"""int8 serving quantization of the transformer-trunk GEMMs (counterpart of
thermal3d/kernels/quant.py).

No Pallas kernel lies behind it: the JAX `int8_dense` computes its int8 ×
int8 → int32 product with `lax.dot_general` and leaves it to XLA. Here that
product is a library GEMM too, by one of two routes that the caller names:

* 'int_mm' (the default, and the card's route): `torch._int_mm`, cuBLASLt's
  IMMA GEMM on the card, counted by `int_mm.launches` (one a call). The
  port's [N, K] weight goes in as `wq.t()`, column-major. On the card it
  takes M > 16 rows and K, N multiples of 8 (`check_int_mm_shape` raises a
  clear error otherwise); every production shape qualifies.
* 'plain': the same product in float64, cast to int32. It is exact, since
  |Σ| ≤ 127²·K < 2^53 for any K the model has.

Layout: the port's `Dense.weight` is torch's [N, K]; the JAX kernel is
[K, N]. So weight scales are per row N here ([N], or [N, G] with grouped
scales: the transpose of JAX's [G, N]), and `equalize_ln_gemm` folds its
scale into weight columns where JAX folds it into kernel rows.

Rounding, held bit for bit against the JAX package:
* the dynamic activation scale max(|x|, 1e-8) / 127 runs under jit in the
  JAX engine, where XLA turns a division by the constant 127 into a
  multiplication by its float32 reciprocal; the port multiplies by that
  reciprocal (`dynamic_scale`), which rounds the same on the card and the
  CPU;
* the weight scales and the static activation scale are computed eagerly
  in JAX (true IEEE divisions); the port divides by a tensor on the same
  device (torch's CUDA division by a Python or CPU scalar multiplies by the
  reciprocal instead, 1 ulp off for some values);
* rounding is half to even (jnp.round, torch.round); the dequant is
  acc·(x_scale·w_scale) in float32, then the cast to the output dtype; the
  grouped variant sums its K/G segments in segment order, each step a
  float32 fused multiply-add as XLA fuses it (computed exactly in float64,
  rounded once to float32).

`quantize_model_int8` and `equalize_ln_gemm` work on the port's model in
place, on the trunk's Dense modules only (`enc_blocks.*`, `dec_blocks.*`,
`dec_blocks2.*`, `decoder_embed`): heads, patch embed, norms and biases stay
float. `skip` takes the JAX package's top-level names (`enc_blocks_0`,
`dec_blocks2_3`, `decoder_embed`), so a caller's list carries over.
"""

from __future__ import annotations

from typing import Collection, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from thermal3d_torch.kernels import _build

# named --int8_scope presets → quantize_model_int8(only=...) module-name filters
SCOPE_TO_ONLY = {"all": (), "mlp": ("fc1", "fc2"), "fc1": ("fc1",)}
INT8_IMPLS = ("int_mm", "plain")
QMAX = 127.0
RECIP_QMAX = float(np.float32(1.0) / np.float32(QMAX))  # XLA's folded 1/127
TRUNK_STACKS = ("enc_blocks", "dec_blocks", "dec_blocks2")


def check_int_mm_shape(m: int, k: int, n: int) -> None:
    """Raise for an int8 product that cuBLASLt's IMMA path (torch._int_mm on
    CUDA) refuses: it needs more than 16 rows and K, N multiples of 8."""
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"int8 GEMM [{m},{k}] x [{k},{n}]: torch._int_mm on CUDA needs M > 16 and K, N "
            "multiples of 8; pass int8_impl='plain' to run such a shape")


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 × wq [N, K] int8 → [M, N] int32 by torch._int_mm
    (cuBLASLt IMMA on the card), with the weight passed column-major."""
    m, k = xq.shape
    if xq.is_cuda:
        check_int_mm_shape(m, k, wq.shape[0])
    if not torch.compiler.is_compiling():  # a trace records the call, launches nothing
        _build.count_launch(int_mm)
    return torch._int_mm(xq, wq.t())


int_mm.launches = 0


def int_mm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int_mm's plain version: the product in float64 (exact), cast to int32."""
    return (xq.to(torch.float64) @ wq.to(torch.float64).t()).to(torch.int32)


def int_product(xq: torch.Tensor, wq: torch.Tensor, impl: str) -> torch.Tensor:
    if impl == "int_mm":
        return int_mm(xq, wq)
    if impl == "plain":
        return int_mm_plain(xq, wq)
    raise ValueError(f"int8_impl {impl!r} not in {INT8_IMPLS}")


def dynamic_scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127 as the jitted JAX function computes it: a
    multiplication by the float32 reciprocal of 127."""
    return torch.clamp_min(absmax, 1e-8) * torch.full_like(absmax, RECIP_QMAX)


def static_scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127 in IEEE division (the eager JAX transform's)."""
    a = torch.clamp_min(absmax.to(torch.float32), 1e-8)
    return a / torch.full_like(a, QMAX)


def quantize_values(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(xf / scale), -127, 127) as int8 (round half to even)."""
    return torch.clamp(torch.round(xf / scale), -QMAX, QMAX).to(torch.int8)


def int8_dense(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, out_dtype: torch.dtype,
               act_scale: Optional[torch.Tensor] = None, impl: str = "int_mm") -> torch.Tensor:
    """x [..., K] float; wq [N, K] int8; ws [N] float32 (whole-row scales)
    or [N, G] (grouped: a scale per K/G-column segment) → [..., N] in
    out_dtype. Dynamic symmetric per-token activation quantization (per
    token and segment when grouped), or the static per-tensor act_scale
    (a 0-dim float32 tensor: values beyond it saturate at ±127); int32
    accumulation by `impl`; float32 dequant."""
    if ws.dim() == 2:
        if act_scale is not None:
            raise ValueError("static act_scale is not supported with grouped "
                             "weight scales (pick one)")
        return _int8_dense_grouped(x, wq, ws, out_dtype, impl)
    lead, k = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, k).to(torch.float32)
    if act_scale is not None:
        xs = act_scale.to(torch.float32)
    else:
        xs = dynamic_scale(xf.abs().amax(dim=-1, keepdim=True))
    acc = int_product(quantize_values(xf, xs), wq, impl)
    y = (acc.to(torch.float32) * (xs * ws)).to(out_dtype)
    return y.reshape(*lead, wq.shape[0])


def _int8_dense_grouped(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                        out_dtype: torch.dtype, impl: str) -> torch.Tensor:
    """Grouped variant: ws [N, G]; weights and activations both get a scale
    per K/G segment; one int8 product a segment, summed in float32 in
    segment order."""
    n, g = ws.shape
    lead, k = x.shape[:-1], x.shape[-1]
    gk = k // g
    xf = x.reshape(-1, g, gk).to(torch.float32)
    xs = dynamic_scale(xf.abs().amax(dim=-1, keepdim=True))  # [M, G, 1]
    xq = quantize_values(xf, xs).transpose(0, 1).contiguous()  # [G, M, gk]
    wg = wq.reshape(n, g, gk).transpose(0, 1).contiguous()  # [G, N, gk]
    y = torch.zeros((xq.shape[1], n), dtype=torch.float64, device=x.device)
    for i in range(g):
        acc = int_product(xq[i], wg[i], impl).to(torch.float32)
        scale = xs[:, i] * ws[:, i]  # [M, 1] * [N]: float32
        # XLA fuses the products into the sum as float32 fused multiply-adds;
        # a product of two float32 values is exact in float64, so the step
        # is y + acc·scale in float64, rounded once to float32
        y = (y + acc.to(torch.float64) * scale.to(torch.float64)).to(torch.float32).to(
            torch.float64)
    return y.to(torch.float32).to(out_dtype).reshape(*lead, n)


def quantize_kernel(w: torch.Tensor, group_size: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, K] float weight → (int8 weight [N, K], float32 scales).

    group_size=None: scales [N] (absmax per row). group_size=G columns:
    scales [N, K/G] (absmax per row per K-segment)."""
    wf = w.to(torch.float32)
    if group_size is None:
        ws = static_scale(wf.abs().amax(dim=1))
        return quantize_values(wf, ws[:, None]), ws
    n, k = wf.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    wg = wf.reshape(n, k // group_size, group_size)
    ws = static_scale(wg.abs().amax(dim=2))  # [N, G]
    return quantize_values(wg, ws[:, :, None]).reshape(n, k), ws


def jax_top(path: str) -> str:
    """The JAX package's top-level module name of a port module path:
    'enc_blocks.3.attn.qkv' → 'enc_blocks_3', 'decoder_embed' → itself."""
    parts = path.split(".")
    return f"{parts[0]}_{parts[1]}" if parts[0] in TRUNK_STACKS else parts[0]


def trunk_dense(model: torch.nn.Module) -> Iterator[Tuple[str, torch.nn.Module]]:
    """(path, module) of every Dense of the transformer trunk, in module
    order: the GEMMs of the encoder and decoder blocks and decoder_embed."""
    from thermal3d_torch.models.layers import Dense

    for path, mod in model.named_modules():
        if isinstance(mod, Dense) and (path == "decoder_embed"
                                       or path.split(".")[0] in TRUNK_STACKS):
            yield path, mod


def targeted(path: str, skip: Collection[str], only: Collection[str]) -> bool:
    """Whether a trunk Dense at `path` is quantized: its top-level module
    not in `skip`, and its own name in `only` unless `only` is empty."""
    if jax_top(path) in skip:
        return False
    return not only or path.split(".")[-1] in only


@torch.no_grad()
def _equalize_block(blk: torch.nn.Module, only: Collection[str], alpha: float) -> int:
    """Fold one block's LN→GEMM pairs in place; returns the GEMMs folded."""

    def want(name):
        return not only or name in only

    pairs = []
    if want("qkv"):
        pairs.append((blk.norm1, [blk.attn.qkv]))
    if hasattr(blk, "cross_attn"):
        if want("projq"):
            pairs.append((blk.norm2, [blk.cross_attn.projq]))
        kv = [getattr(blk.cross_attn, n) for n in ("projk", "projv") if want(n)]
        if kv:  # norm_y feeds both k and v: one shared s serves both
            pairs.append((blk.norm_y, kv))
        if want("fc1"):
            pairs.append((blk.norm3, [blk.mlp.fc1]))
    elif want("fc1"):
        pairs.append((blk.norm2, [blk.mlp.fc1]))

    n = 0
    for ln, targets in pairs:
        g = ln.weight.to(torch.float32)
        be = ln.bias.to(torch.float32)
        # LN output magnitude proxy per input channel: |γ| + |β|
        a = g.abs() + be.abs() + 1e-6
        w = None
        for dense in targets:
            kmax = dense.weight.to(torch.float32).abs().amax(dim=0)  # [K]: column absmax
            w = kmax if w is None else torch.maximum(w, kmax)
        s = torch.clamp(torch.pow(a, alpha) / torch.pow(w + 1e-6, 1.0 - alpha), 1e-2, 1e2)
        ln.weight.copy_((g / s).to(ln.weight.dtype))
        ln.bias.copy_((be / s).to(ln.bias.dtype))
        for dense in targets:
            # folded weights stay float32: quantize_model_int8 consumes them
            # before any storage-dtype rounding
            dense.weight = torch.nn.Parameter(dense.weight.to(torch.float32) * s[None, :],
                                              requires_grad=False)
            n += 1
    return n


def equalize_ln_gemm(model: torch.nn.Module, only: Collection[str] = (),
                     skip: Collection[str] = (), alpha: float = 0.5) -> int:
    """SmoothQuant-style LN→GEMM equalization of the trunk, in place (an
    exact reparameterization): for each pair (encoder norm1→qkv, norm2→fc1;
    decoder norm1→qkv, norm2→projq, norm_y→projk+projv, norm3→fc1) a
    per-input-channel s = a^α / w^(1-α), clipped to [1e-2, 1e2], with a =
    |γ|+|β| the LN output proxy and w the weight's column absmax, divides
    the LN affine (γ/s, β/s, stored back in its dtype) and multiplies the
    weight's columns (kept float32). `only` / `skip` as quantize_model_int8,
    so exactly the quantized GEMMs get folded. Returns the GEMMs folded;
    raises ValueError if there are none."""
    total = 0
    for stack in TRUNK_STACKS:
        for i, blk in enumerate(getattr(model, stack)):
            if f"{stack}_{i}" not in skip:
                total += _equalize_block(blk, only, alpha)
    if not total:
        raise ValueError("no equalizable LN→GEMM pairs found "
                         "(only fc1/qkv/projq/projk/projv have a preceding "
                         "LayerNorm affine)")
    return total


@torch.no_grad()
def quantize_model_int8(model: torch.nn.Module, group_size: Optional[int] = None,
                        skip: Collection[str] = (), only: Collection[str] = (),
                        act_scales: Optional[Dict[str, torch.Tensor]] = None,
                        impl: str = "int_mm") -> int:
    """Quantize the trunk's Dense modules of the port's model in place
    (counterpart of quantize_params_int8); returns how many.

    Each targeted Dense gets its weight as int8 [N, K], `weight_scale`
    ([N], or [N, K/group_size] when group_size divides K; whole-row scales
    otherwise) and, where `act_scales` (calibrate_act_absmax's
    {path: absmax}) has its path, a static `act_scale` = absmax / 127.
    act_scales requires group_size=None. impl: the int8 product's route
    ('int_mm' or 'plain'). Raises ValueError when nothing is targeted."""
    if act_scales is not None and group_size is not None:
        raise ValueError("act_scales (static activation quantization) "
                         "requires group_size=None")
    if impl not in INT8_IMPLS:
        raise ValueError(f"int8_impl {impl!r} not in {INT8_IMPLS}")
    n = 0
    for path, dense in trunk_dense(model):
        if not targeted(path, skip, only):
            continue
        k = dense.weight.shape[1]
        gs = group_size if group_size and k % group_size == 0 else None
        wq, ws = quantize_kernel(dense.weight, gs)
        act = None
        if act_scales is not None and path in act_scales:
            act = static_scale(act_scales[path].to(wq.device))
        dense.set_int8(wq, ws, act, impl)
        n += 1
    if not n:
        raise ValueError("no quantizable Dense kernels found in the model")
    return n


def quantize_for_serving(model: torch.nn.Module, calibrate=None,
                         group_size: Optional[int] = None, skip: Collection[str] = (),
                         only: Collection[str] = (), equalize: bool = False,
                         impl: str = "int_mm") -> int:
    """The serving engines' int8 transform, in the JAX engines' order:
    equalize_ln_gemm (with `equalize`), then `calibrate(model)` (None, or
    a function returning the {path: absmax} of a float forward on the
    equalized model) for static activation scales, then
    quantize_model_int8. Static scales with a group size raise before any
    forward runs."""
    if calibrate is not None and group_size is not None:
        raise ValueError("act_scales (static activation quantization) "
                         "requires group_size=None")
    if equalize:
        equalize_ln_gemm(model, only=only, skip=skip)
    act_scales = None if calibrate is None else calibrate(model)
    return quantize_model_int8(model, group_size=group_size, skip=skip, only=only,
                               act_scales=act_scales, impl=impl)


def load_int8_state_dict(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                         impl: str = "int_mm") -> None:
    """Load an int8 state dict (e.g. convert.from_jax.int8_state_dict_from_jax)
    strictly: every Dense whose `weight_scale` the state holds is switched
    to int8 first, then the whole state loads with strict=True."""
    for path, dense in trunk_dense(model):
        if f"{path}.weight_scale" in state:
            act = state.get(f"{path}.act_scale")
            dense.set_int8(state[f"{path}.weight"].to(torch.int8),
                           state[f"{path}.weight_scale"].to(torch.float32),
                           None if act is None else act.to(torch.float32), impl)
    model.load_state_dict(state, strict=True)
