from thermal3d_torch.preprocess.enhance import (
    enhance_thermal_contrast,
    enhance_thermal_fixed_range,
    percentile_rescale,
    rgb_to_gray,
)
from thermal3d_torch.preprocess.fire_scene import (
    advanced_fire_scene_processing,
    clahe,
    preprocess_fire_scene_thermal,
)
from thermal3d_torch.preprocess.io import (load_rgb_image, load_thermal_image,
                                           preprocess_thermal_for_model)
