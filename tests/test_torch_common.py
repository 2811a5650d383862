"""Shared helpers for the parity tests of the PyTorch port (thermal3d_torch)
against the JAX reference (thermal3d). Imported as tests.test_torch_common.

Inputs are made with numpy from a seed and handed to both frameworks; JAX
params come from the Flax init and are converted with the port's own
convert/from_jax.py.
"""

from __future__ import annotations

import numpy as np
import torch

# Six xdist workers share eight cores: keep each torch worker to two threads.
torch.set_num_threads(2)
# In a process where JAX's CPU backend is up, the first torch.exp on a CPU
# tensor has now and then returned one thread's share of the elements with
# ~1.5e-4 relative error (torch 2.13.0+cpu with MKL, jax 0.9.0); every call
# after it was exact. Warm exp up once, inline and across the threads, so
# that no parity test measures that first call. (The conftest brings JAX's
# CPU backend up before any test module imports this one.)
for _n in (1 << 10, 1 << 16):
    torch.exp(torch.zeros(_n))

TINY_KW = dict(
    img_size=(32, 32),
    enc_embed_dim=64,
    enc_depth=2,
    enc_num_heads=2,
    dec_embed_dim=48,
    dec_depth=2,
    dec_num_heads=2,
)

# Production widths (ViT-L encoder, base decoder, 224²) cut to one block each.
PROD_DEPTH1_KW = dict(
    img_size=(224, 224),
    enc_embed_dim=1024,
    enc_depth=1,
    enc_num_heads=16,
    dec_embed_dim=768,
    dec_depth=1,
    dec_num_heads=12,
)


def configs(**kw):
    """(JAX config, port config) built from the same keywords."""
    from thermal3d.core.config import DustrModelConfig as JaxConfig
    from thermal3d_torch.core.config import DustrModelConfig as TorchConfig

    return JaxConfig(**kw), TorchConfig(**kw)


def jax_model_params(jax_cfg, seed: int = 0):
    """Flax params of AsymmetricCroCo3DStereo as nested dicts of numpy arrays."""
    import jax
    import jax.numpy as jnp

    from thermal3d.models.dustr import AsymmetricCroCo3DStereo

    h, w = jax_cfg.img_size
    dummy = jnp.zeros((1, h, w, 3), jnp.float32)
    params = AsymmetricCroCo3DStereo(jax_cfg).init(jax.random.key(seed), dummy, dummy)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def thermal_head_params(edge_weight: float = 0.37, temp_scale: float = 1.1):
    """Thermal-head params away from their init values, so both are exercised."""
    return {"edge_weight": np.float32(edge_weight), "temp_scale": np.float32(temp_scale)}


def torch_state(params):
    from thermal3d_torch.convert.from_jax import state_dict_from_jax

    return state_dict_from_jax(params)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
