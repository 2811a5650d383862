from thermal3d_torch.geometry.calibration import load_thermal_calibration
from thermal3d_torch.geometry.intrinsics import estimate_camera_intrinsics
from thermal3d_torch.geometry.umeyama import (GeometryException, extract_relative_pose,
                                              umeyama_alignment)
