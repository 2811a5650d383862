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


def drawn_params(jax_cfg, seed: int = 0):
    """A Flax param tree for jax_cfg drawn with numpy, without an XLA compile:
    shapes from jax.eval_shape of the init; kernels normal with std
    1/sqrt(fan_in); biases and LayerNorm scales 0 and 1 plus 0.02 noise."""
    import jax
    import jax.numpy as jnp

    from thermal3d.models.dustr import AsymmetricCroCo3DStereo

    h, w = jax_cfg.img_size
    dummy = jnp.zeros((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: AsymmetricCroCo3DStereo(jax_cfg).init(jax.random.key(0), dummy, dummy))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def thermal_head_params(edge_weight: float = 0.37, temp_scale: float = 1.1):
    """Thermal-head params away from their init values, so both are exercised."""
    return {"edge_weight": np.float32(edge_weight), "temp_scale": np.float32(temp_scale)}


def torch_state(params):
    from thermal3d_torch.convert.from_jax import state_dict_from_jax

    return state_dict_from_jax(params)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# --- a small PNG encoder, to write files that use every filter type -------

PNG_COLOR_TYPES = {"gray": 0, "rgb": 2, "palette": 3, "gray_alpha": 4, "rgba": 6}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _pack_rows(arr: np.ndarray, depth: int) -> np.ndarray:
    """[H, W, C] samples → [H, row bytes] uint8 at bit depth `depth`."""
    h = arr.shape[0]
    if depth == 16:
        return arr.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return arr.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    flat = arr.reshape(h, -1).astype(np.uint8)
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = np.array([8 - depth * (k + 1) for k in range(per)], np.uint8)
    return (flat << shifts).sum(axis=-1).astype(np.uint8)


def _filter_rows(raw: np.ndarray, bpp: int, filters) -> bytes:
    """Filter each row with filters[row % len(filters)] (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth); → the bytes zlib compresses."""
    out = bytearray()
    prev = np.zeros(raw.shape[1], np.int32)
    for y, row in enumerate(raw.astype(np.int32)):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            res = row
        elif f == 1:
            res = row - left
        elif f == 2:
            res = row - prev
        elif f == 3:
            res = row - ((left + prev) >> 1)
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            res = row - pred
        out.append(f)
        out += (res & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def png_chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib

    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def encode_png(arr: np.ndarray, color: str = "gray", depth: int = 8, filters=(0, 1, 2, 3, 4),
               palette: np.ndarray = None, interlace: bool = False) -> bytes:
    """A PNG of `arr` ([H, W] or [H, W, C] samples; palette indices for
    'palette', with `palette` [N, 3] uint8). Rows are filtered in turn by
    `filters`; the image data is split over two IDAT chunks. interlace=True
    writes Adam7 passes (filter 0)."""
    import struct
    import zlib

    arr = arr.reshape(arr.shape[0], arr.shape[1], -1)
    h, w, c = arr.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        data = b"".join(_filter_rows(_pack_rows(arr[y0::dy, x0::dx], depth), bpp, (0,))
                        for x0, y0, dx, dy in _ADAM7 if x0 < w and y0 < h)
    else:
        data = _filter_rows(_pack_rows(arr, depth), bpp, filters)
    z = zlib.compress(data, 6)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, PNG_COLOR_TYPES[color], 0, 0, int(interlace))
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", ihdr)
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    half = len(z) // 2
    return out + png_chunk(b"IDAT", z[:half]) + png_chunk(b"IDAT", z[half:]) + png_chunk(b"IEND", b"")


class StandInLibrary:
    """A kernel library that launches nothing: each `t3d_*` entry point
    appends ("call", its name) to `events` and returns 0 (no CUDA error);
    the tensor-core K2/K3 kernel's scratch query answers as
    csrc/rope_attention_tc.cu does (past S = 256 two bf16 [B, H, S, 64] at
    head_dim 64, roped K and Q; one [B, H, S, D] at every S at another
    head_dim; else 0), the 3xTF32 kernels' as
    csrc/attention_3xtf32.cu does, and the packed entries' scratch queries
    as csrc/attention_tc.cu and csrc/attention_3xtf32.cu do. No query is
    recorded."""

    def __init__(self, events: list):
        self.events = events

    def t3d_rope_attention_tc_scratch_bytes(self, batch, seq, heads, head_dim) -> int:
        if head_dim == 64:
            return 2 * batch * heads * seq * head_dim * 2 if seq > 256 else 0
        return batch * heads * seq * head_dim * 2

    def t3d_attention_3xtf32_scratch_bytes(self, batch, heads, seq, head_dim) -> int:
        return 4 * (2 * batch * heads * seq * head_dim
                    + 2 * batch * heads * head_dim * (-(-seq // 8) * 8))

    def t3d_attention_tc_packed_scratch_bytes(self, batch, heads, sq, sk, head_dim) -> int:
        return 2 * batch * heads * (sq + 2 * sk) * _padded_width(head_dim)

    def t3d_attention_3xtf32_packed_scratch_bytes(self, batch, heads, sq, sk, head_dim) -> int:
        dp = _padded_width(head_dim)
        return 4 * batch * heads * sq * dp + self.t3d_attention_3xtf32_scratch_bytes(
            batch, heads, sk, dp)

    def __getattr__(self, name):
        if not name.startswith("t3d_"):
            raise AttributeError(name)

        def entry(*args):
            self.events.append(("call", name))
            return 0

        return entry


def _padded_width(head_dim: int) -> int:
    """The built width a head dim runs at (csrc/attention_tc.cuh's
    padded_width), restated for the stand-in library."""
    return next(w for w in (16, 32, 64, 128, 256) if head_dim <= w)


def record_device_blocks(monkeypatch, events: list) -> None:
    """Stand torch.cuda.device in with a recorder that appends ("enter",
    device) and ("exit", device) to `events`, and torch.cuda.current_stream
    with one that gives stream 0, so a launch function runs its library call
    on CPU tensors standing in for a card's."""

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))
            return False

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)



def run_wrapper(script: str, tmp_path, args=(), env=None, timeout: int = 300):
    """Run scripts/<script> with bash from the repository's root, as a user
    would, and return the CompletedProcess (text output). Its `python` is
    this interpreter (a script under tmp_path, first on PATH), on the test
    process's two torch threads, so that its float results can be held bit
    for bit against a direct call in the test process."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    bin_dir = Path(tmp_path) / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    shim.chmod(0o755)
    full_env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
                    PYTHONPATH=str(root), OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
                    **(env or {}))
    return subprocess.run(["bash", str(root / "scripts" / script), *args], cwd=root,
                          env=full_env, capture_output=True, text=True, timeout=timeout)
