from thermal3d_torch.data.freiburg import (
    FreiburgPairDataset,
    build_pair_index,
    build_rgb_pair_index,
    build_rgb_thermal_index,
    day_night_filter,
    match_pseudo_gt,
    validate_pair_index,
)
from thermal3d_torch.data.pipeline import BatchLoader, split_index
