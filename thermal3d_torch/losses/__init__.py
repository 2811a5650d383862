from thermal3d_torch.losses.losses import (
    batched_enhanced_loss,
    confidence_weighted_regression_loss,
    enhanced_thermal_aware_loss,
    thermal_aware_loss,
)
