"""Checkpoint conversion (counterpart of thermal3d/convert). The port loads
a DUSt3R/MASt3R `.pth` itself (`from_pth.load_pth`), so the reference's
`.pth` → flax converters have no counterpart here."""

from thermal3d_torch.convert.from_pth import expected_torch_keys, load_torch_checkpoint
