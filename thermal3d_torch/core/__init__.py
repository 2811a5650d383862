"""Configuration and the device mesh (counterpart of thermal3d/core).
Imports no model code: the serving artifact's loader runs this package."""

from thermal3d_torch.core.config import (
    DUSTR_224_LINEAR,
    FREIBURG_RAW_MAX,
    FREIBURG_RAW_MIN,
    MASTR_512_CATMLPDPT,
    DustrModelConfig,
    HeadConfig,
    LossConfig,
    PreprocessConfig,
    TrainConfig,
)
from thermal3d_torch.core.mesh import make_mesh
