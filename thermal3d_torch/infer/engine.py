"""Batched inference engine (counterpart of thermal3d/infer/engine.py).

The serving path: raw frames [B, h, w] → bilinear resize to the model size →
p2/p98 percentile enhance (kernel K1) → learnable thermal head → DUSt3R
(encoder once in monocular mode, dual decoder, linear heads; attention
through kernels K2/K3) → pointmaps, confidences and depth = pts3d[..., 2].
Everything runs under torch.inference_mode(); the device is CUDA unless the
caller names the CPU.

Data-parallel serving (`mesh=`, a single-controller core.mesh.Mesh): one
process holds a replica of the model on each distinct device of the mesh's
'data' axis (positions that repeat a device share its replica), splits each
batch into one chunk of B/n rows a position, runs each chunk on its
position's device (a thread per distinct device, so their launches overlap
when there are several), and gathers the results on the mesh's first
device. Each row's arithmetic is the single-device engine's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from thermal3d_torch.core.config import DUSTR_224_LINEAR, DustrModelConfig
from thermal3d_torch.core.device import resolve_device, to_device
from thermal3d_torch.core.mesh import mesh_positions, replicate, run_on_mesh
from thermal3d_torch.data.pipeline import PinnedFetch, PinnedStage, pipelined_batches
from thermal3d_torch.kernels.quant import quantize_for_serving
from thermal3d_torch.models.dustr import calibrate_act_absmax, frozen_model
from thermal3d_torch.models.thermal_wrap import ThermalPreprocessHead
from thermal3d_torch.preprocess.enhance import ENHANCE_IMPLS, enhance_thermal_contrast
from thermal3d_torch.preprocess.io import load_thermal_images_batch
from thermal3d_torch.preprocess.resize import resize_bilinear_hw

OUTPUT_KEYS = ("pointmap1", "pointmap2", "confidence1", "confidence2", "depth")


def serving_outputs(pred1: Dict, pred2: Dict) -> Dict[str, torch.Tensor]:
    """The model's two predictions → the five serving outputs."""
    return {
        "pointmap1": pred1["pts3d"],
        "pointmap2": pred2["pts3d_in_other_view"],
        "confidence1": pred1["conf"],
        "confidence2": pred2["conf"],
        "depth": pred1["pts3d"][..., 2],
    }


class InferenceEngine:
    """Holds the model (on one device, or a replica a mesh device) and serves
    batches.

    state_dict: torch/dust3r-layout weights (e.g. convert.from_jax); None
    makes seeded random weights (`seed`). thermal_head_state: {'edge_weight',
    'temp_scale'}; None keeps the init values 0.5 / 1.0. params_dtype:
    'bfloat16' stores every model weight in bf16 (the linear head up-casts the
    rounded weights to f32); None keeps float32. enhance_impl: passed to
    enhance_thermal_contrast ('auto' = K1 on CUDA, sort on CPU).

    quantize_int8: int8 serving of the trunk GEMMs (kernels/quant.py), after
    the params_dtype cast, as the JAX engine: int8_equalize folds the
    LN→GEMM pairs first; int8_calibration, a raw frame sample [B, h, w],
    runs ONE float forward over it (preprocess, thermal head, monocular
    model) for static per-GEMM activation scales (not with
    int8_group_size); int8_only / int8_skip scope it (SCOPE_TO_ONLY,
    top-level JAX names). int8_impl names the int8 product's route:
    'int_mm' (torch._int_mm) or 'plain' (float64). The JAX engine's
    pin_attention_for_int8 is TPU policy and not carried over: attention
    keeps config.attention_impl.

    mesh: a single-controller core.mesh.Mesh with a 'data' axis (module
    docstring); the engine's device is then the mesh's first, and a batch
    must divide into its 'data' size (ValueError).
    """

    def __init__(self, config: DustrModelConfig = DUSTR_224_LINEAR,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 thermal_head_state: Optional[Mapping[str, torch.Tensor]] = None,
                 use_thermal_head: bool = True, params_dtype: Optional[str] = None,
                 device=None, seed: int = 0, enhance_impl: str = "auto",
                 quantize_int8: bool = False, int8_group_size: Optional[int] = None,
                 int8_skip: tuple = (), int8_only: tuple = (), int8_equalize: bool = False,
                 int8_calibration=None, int8_impl: str = "int_mm", mesh=None):
        if enhance_impl not in ENHANCE_IMPLS:
            raise ValueError(f"enhance_impl {enhance_impl!r} not in {ENHANCE_IMPLS}")
        self.mesh = mesh
        self._positions = mesh_positions(mesh)
        self.device = self._positions[0] if mesh is not None else resolve_device(device)
        self.config = config
        self.enhance_impl = enhance_impl
        self.use_thermal_head = use_thermal_head

        self.model = frozen_model(config, self.device, state_dict, seed, params_dtype)

        self.thermal_head = ThermalPreprocessHead().to(self.device)
        if thermal_head_state is not None:
            self.thermal_head.load_state_dict(thermal_head_state, strict=True)
        self.thermal_head.eval().requires_grad_(False)
        if quantize_int8:
            quantize_for_serving(
                self.model, None if int8_calibration is None
                else lambda model: calibrate_act_absmax(model, self._model_input(int8_calibration)),
                group_size=int8_group_size, skip=int8_skip, only=int8_only,
                equalize=int8_equalize, impl=int8_impl)
        self._replicas = replicate(self.device, self._positions,
                                   (self.model, self.thermal_head))

    def _model_input(self, grays) -> torch.Tensor:
        """Raw frames [B, h, w] → the model's input: preprocess, thermal head."""
        with torch.inference_mode():
            x = self.preprocess(to_device(grays, self.device))
            return self.thermal_head(x) if self.use_thermal_head else x

    def preprocess(self, grays: torch.Tensor) -> torch.Tensor:
        """[B, h, w] decoded grayscale (any scale) → enhanced [B, H, W, 3]."""
        resized = resize_bilinear_hw(grays, self.config.img_size)
        return enhance_thermal_contrast(resized, impl=self.enhance_impl)

    def infer(self, img1: np.ndarray, img2: Optional[np.ndarray] = None,
              preprocessed: bool = False) -> Dict[str, np.ndarray]:
        """img*: [B, h, w] raw grayscale or [B, H, W, 3] preprocessed → numpy
        pointmap1/2 [B,H,W,3], confidence1/2 [B,H,W], depth [B,H,W]."""
        out = self.infer_async(img1, img2, preprocessed)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def infer_async(self, img1, img2=None, preprocessed: bool = False
                    ) -> Dict[str, torch.Tensor]:
        """Like infer() but returns device tensors without waiting for them
        (on the mesh's first device with a mesh); img* may also be float32
        tensors on the engine's device."""
        if self.mesh is None:
            return self._forward((self.model, self.thermal_head), self.device, img1, img2,
                                 preprocessed)

        def chunk(device, rows):
            return self._forward(self._replicas[device], device, img1[rows],
                                 None if img2 is None else img2[rows], preprocessed)

        return run_on_mesh(self._positions, img1.shape[0], chunk)

    def _forward(self, modules, device, img1, img2, preprocessed: bool
                 ) -> Dict[str, torch.Tensor]:
        model, head = modules
        with torch.inference_mode():
            x1 = to_device(img1, device)
            x2 = None if img2 is None else to_device(img2, device)
            if x1.shape[0] == 0:
                raise ValueError("infer: empty batch")
            if not preprocessed:
                x1 = self.preprocess(x1)
                x2 = None if x2 is None else self.preprocess(x2)
            if self.use_thermal_head:
                x1 = head(x1)
                x2 = None if x2 is None else head(x2)
            return serving_outputs(*model(x1, x2))

    def infer_paths(self, paths: List[str], batch_size: int = 36, pad_final: bool = True,
                    outputs: Optional[Sequence[str]] = None, prefetch: int = 2
                    ) -> Dict[str, Any]:
        """Monocular depth over a list of thermal PNGs, pipelined: a
        background thread decodes batches i+1..i+prefetch (the port's
        decoder, resized to the model size) while the card computes batch i;
        batch i's frames reach the card through pinned memory without
        waiting for batch i-1's compute (data.pipeline.PinnedStage); its
        results are copied into pinned host memory on a copy stream as soon
        as its own work ends, and read after batch i+1 has been dispatched
        (PinnedFetch). Results are bit-equal to a serial decode → infer →
        fetch loop.

        outputs: the keys to fetch, e.g. ("depth",), a seventh of the bytes
        of all five. A short last batch is padded with its last frame
        (pad_final), so every batch has one shape. The result has a "paths"
        list of the frames that decoded, row-aligned with every array:
        failed decodes are dropped, so callers zip against it, not `paths`."""
        keys = tuple(OUTPUT_KEYS if outputs is None else outputs)
        unknown = set(keys) - set(OUTPUT_KEYS)
        if unknown:
            raise ValueError(f"infer_paths: unknown outputs {sorted(unknown)}")
        chunks = [paths[i:i + batch_size] for i in range(0, len(paths), batch_size)]
        stage, fetch = PinnedStage(self.device), PinnedFetch(self.device)
        result: Dict[str, np.ndarray] = {}  # room for every path, filled in order
        ok_paths: List[str] = []

        def decode(chunk):
            return load_thermal_images_batch(chunk, normalize=True, out_hw=self.config.img_size)

        def dispatch(decoded):
            grays, survivors = decoded
            if not grays:
                return None
            real = len(grays)
            ok_paths.extend(survivors)
            if pad_final and real < batch_size:
                grays = list(grays) + [grays[-1]] * (batch_size - real)
            out = self.infer_async(stage.put({"frames": np.stack(grays)})["frames"])
            return fetch.start({k: out[k] for k in keys}), real

        n_out = 0

        def consume(token):
            nonlocal n_out
            started, real = token
            if not result:
                result.update(PinnedFetch.empty_like(started, len(paths)))
            fetch.finish(started, real, into={k: v[n_out:n_out + real] for k, v in result.items()})
            n_out += real

        pipelined_batches(chunks, decode, dispatch, consume, prefetch=prefetch)
        if not result:
            return {}
        out: Dict[str, Any] = {k: v[:n_out] for k, v in result.items()}
        out["paths"] = ok_paths
        return out
