"""The kernels (counterpart of thermal3d/kernels). As in JAX, the package
re-exports the function `flash_attention`, whose name is also its module's:
`from thermal3d_torch.kernels import flash_attention` and
`import thermal3d_torch.kernels.flash_attention as m` both give the
function. Reach the module with
`importlib.import_module("thermal3d_torch.kernels.flash_attention")` or
import names from it."""

from thermal3d_torch.kernels.flash_attention import flash_attention
