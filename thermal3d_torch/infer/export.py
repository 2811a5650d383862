"""Serving artifacts via torch.export (counterpart of thermal3d/infer/export.py).

The whole serving computation of `InferenceEngine` (resize → percentile
enhance → thermal head → model → the five outputs, `InferenceEngine._forward`)
is exported as one `torch.export` program per batch size and written with the
weights into ONE `.npz` file:

* **model-code-free serving**: `ServingArtifact.load(path).infer(raw)` imports
  torch and numpy, and for a native artifact `thermal3d_torch.kernels` (which
  registers the kernels' ops and builds them at first use); never the port's
  models, engine, converters or preprocessing.
* **weights once**: the weights are inputs of every program, never a
  program's own state (each program's state_dict is empty), so a second batch
  size adds a graph, not another copy of the ViT-L. They are stored as raw
  bytes with their dtype names (bf16 as 2-byte words, rebuilt with
  torch.frombuffer: no ml_dtypes needed).
* **platforms**: `platforms=None` exports the engine's exact program for its
  own device type: on the card K1, K2 and K3 as the ops of kernels/ops.py
  (the plain versions on the CPU, behind the same ops). Such an artifact
  loads only on that device type. Any other set of platforms (the CLI's
  default 'cpu,cuda') exports the PORTABLE program: the exact sort
  percentile (`enhance_impl='sort'`) and the plain attention
  (`attention_impl='torch'`), no op of the port, moved to the loading device
  by torch.export's move_to_device_pass.
* **fixed shapes**: one program per batch size; `infer` pads a short batch
  to the smallest exported size and slices the outputs back. The loader
  serves each program without the per-call checks that a fixed-shape
  program and `infer`'s own checks make redundant (the module's input
  check, the trace's dtype asserts and its casts to a tensor's own dtype).

int8 engines export as they are: the int8 weights and their scales are
weights like the others, and the program calls torch._int_mm.
"""

from __future__ import annotations

import contextlib
import io
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from thermal3d_torch.core.device import exact_float32_convs, resolve_device

FORMAT = "thermal3d_torch-serving-v1"
# the program's outputs, as the JAX artifact lists them
OUTPUTS = ("confidence1", "confidence2", "depth", "pointmap1", "pointmap2")
PLATFORMS = ("cpu", "cuda")


class _Serving(torch.nn.Module):
    """InferenceEngine._forward on raw frames, over its model and thermal
    head: resize, enhance (by `enhance_impl`), thermal head, model."""

    def __init__(self, model, thermal_head, img_size, enhance_impl: str, use_head: bool):
        super().__init__()
        self.model, self.thermal_head = model, thermal_head
        self.img_size, self.enhance_impl, self.use_head = tuple(img_size), enhance_impl, use_head

    def forward(self, raw1, raw2=None):
        from thermal3d_torch.infer.engine import serving_outputs
        from thermal3d_torch.preprocess.enhance import enhance_thermal_contrast
        from thermal3d_torch.preprocess.resize import resize_bilinear_hw

        def prep(raw):
            x = enhance_thermal_contrast(resize_bilinear_hw(raw, self.img_size),
                                         impl=self.enhance_impl)
            return self.thermal_head(x) if self.use_head else x

        return serving_outputs(*self.model(prep(raw1), None if raw2 is None else prep(raw2)))


class _Program(torch.nn.Module):
    """forward(weights, raw1[, raw2]): _Serving with every parameter and
    buffer taken from `weights` (a list in `names` order). _Serving is held
    outside the registered submodules, so the export owns none of its
    tensors."""

    def __init__(self, serving: _Serving, names: List[str]):
        super().__init__()
        self.__dict__["serving"] = serving
        self.names = names

    def forward(self, weights, raw1, raw2=None):
        return torch.func.functional_call(self.serving, dict(zip(self.names, weights)),
                                          (raw1, raw2))


@contextlib.contextmanager
def _attention_impl(model: torch.nn.Module, impl: str):
    """Every attention module of `model` on `impl` for the block; restored
    after."""
    mods = [m for m in model.modules() if hasattr(m, "attention_impl")]
    before = [m.attention_impl for m in mods]
    for m in mods:
        m.attention_impl = impl
    try:
        yield
    finally:
        for m, impl_before in zip(mods, before):
            m.attention_impl = impl_before


def _weights(serving: _Serving) -> Tuple[List[str], List[torch.Tensor]]:
    """The names and tensors of every parameter and buffer (each tensor
    once)."""
    named = list(serving.named_parameters()) + list(serving.named_buffers())
    return [n for n, _ in named], [t.detach() for _, t in named]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_serving_artifact(path: str, engine, batch_sizes: Sequence[int] = (64,),
                          input_hw: Optional[Tuple[int, int]] = None,
                          platforms: Optional[Sequence[str]] = ("cpu", "cuda"),
                          stereo: bool = False) -> Dict:
    """Export `engine`'s serving computation for each batch size and write
    the artifact's npz. Returns its metadata.

    input_hw: the raw [h, w] frames the program takes (resized to the
    model's img_size inside); defaults to the model's img_size.
    platforms: None, or exactly the engine's device type, exports its native
    program (module docstring); any other subset of ('cpu', 'cuda') the
    portable one."""
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] <= 0:
        raise ValueError(f"batch_sizes must be positive: {batch_sizes}")
    h, w = (int(v) for v in (engine.config.img_size if input_hw is None else input_hw))
    device = engine.device
    if platforms is None:
        platforms = (device.type,)
    platforms = list(dict.fromkeys(platforms))
    unknown = set(platforms) - set(PLATFORMS)
    if unknown or not platforms:
        raise ValueError(f"platforms must be a subset of {PLATFORMS}, got {platforms}")
    portable = set(platforms) != {device.type}

    serving = _Serving(engine.model, engine.thermal_head, engine.config.img_size,
                       "sort" if portable else engine.enhance_impl, engine.use_thermal_head)
    names, weights = _weights(serving)
    program = _Program(serving, names)
    blobs: Dict[str, np.ndarray] = {}
    seconds: Dict[str, float] = {}
    with torch.no_grad(), _attention_impl(engine.model, "torch") if portable \
            else contextlib.nullcontext():
        for b in batch_sizes:
            t0 = time.perf_counter()
            # one tensor a view: the same tensor twice would export one input
            raws = [torch.zeros((b, h, w), dtype=torch.float32, device=device)
                    for _ in range(1 + stereo)]
            args = (weights, *raws)
            exported = torch.export.export(program, args, strict=False)
            # the example inputs hold the weights: saved, they would put a
            # copy of them into every program
            exported.example_inputs = None
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            blobs[f"program_{b}"] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
            seconds[str(b)] = time.perf_counter() - t0

    weights_meta = []
    for i, (name, t) in enumerate(zip(names, weights)):
        raw_bytes = t.to("cpu").contiguous().reshape(-1).view(torch.uint8)
        blobs[f"w_{i:05d}"] = raw_bytes.numpy()
        weights_meta.append({"name": name, "shape": list(t.shape), "dtype": _dtype_name(t.dtype)})

    config = engine.config
    meta = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "platforms": platforms,
        "batch_sizes": batch_sizes,
        "input_hw": [h, w],
        "img_size": list(config.img_size),
        "stereo": bool(stereo),
        "portable_program": bool(portable),
        "outputs": list(OUTPUTS),
        "num_weights": len(weights),
        "weights": weights_meta,
        "int8": any(t.dtype == torch.int8 for t in weights),
        "model": {"head_type": config.head.head_type, "compute_dtype": config.compute_dtype,
                  "enc_depth": config.enc_depth, "dec_depth": config.dec_depth},
        "export_seconds": seconds,  # host seconds to trace and serialise, by batch size
    }
    blobs["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **blobs)
    return meta


def _weight(buf: bytes, wm: Dict, device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, wm["dtype"])
    flat = torch.frombuffer(bytearray(buf), dtype=torch.uint8) if buf else \
        torch.empty(0, dtype=torch.uint8)
    return flat.view(dtype).reshape(wm["shape"]).to(device)


def _without_dtype_checks(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """The served module without the nodes a trace records for every
    `.to(dtype)` and that compute nothing in a fixed-shape program: the
    `_assert_tensor_metadata` checks of the dtypes the trace saw, and the
    casts of a tensor to the dtype it has (which return it). Each is a host
    dispatch, and every Dense and LayerNorm makes a few; the outputs are the
    same bit for bit."""
    graph = module.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif node.target is torch.ops.aten.to.dtype and len(node.args) == 2 and not node.kwargs:
            source = node.args[0]
            seen = source.meta.get("val") if isinstance(source, torch.fx.Node) else None
            if isinstance(seen, torch.Tensor) and seen.dtype == node.args[1]:
                node.replace_all_uses_with(source)
                graph.erase_node(node)
    module.recompile()
    return module


class ServingArtifact:
    """Loads and runs a serving artifact. `load` and `infer` need torch,
    numpy and, for a native artifact, thermal3d_torch.kernels: no model
    code, engine, converter or preprocessing of the port."""

    def __init__(self, fns: Dict[int, torch.nn.Module], weights: List[torch.Tensor],
                 meta: Dict, device: torch.device):
        self._fns = fns  # batch size -> the program's module
        self._weights = weights
        self.meta = meta
        self.device = device
        self.batch_sizes = sorted(fns)
        self.stereo = bool(meta["stereo"])
        self.input_hw = tuple(meta["input_hw"])

    @classmethod
    def load(cls, path: str, device=None) -> "ServingArtifact":
        """device: where to serve; None is the card ('cuda'), or a native
        artifact's own device type. A native artifact loads only on the
        device type it was exported for (ValueError)."""
        from torch.export.passes import move_to_device_pass

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
            if meta.get("format") != FORMAT:
                raise ValueError(f"{path}: not a {FORMAT} artifact "
                                 f"(format={meta.get('format')!r})")
            native = not meta["portable_program"]
            if native:
                own = meta["platforms"][0]
                asked = torch.device(own if device is None else device)
                if asked.type != own:
                    raise ValueError(f"{path}: a native {own} artifact cannot serve on "
                                     f"{asked}; export it for {asked.type} or export the "
                                     "portable program")
                import thermal3d_torch.kernels.ops  # noqa: F401  (registers the ops)
            dev = resolve_device(asked if native else device)
            weights = [_weight(z[f"w_{i:05d}"].tobytes(), wm, dev)
                       for i, wm in enumerate(meta["weights"])]
            fns = {}
            for b in meta["batch_sizes"]:
                program = torch.export.load(io.BytesIO(z[f"program_{b}"].tobytes()))
                module = move_to_device_pass(program, str(dev)).module()
                # infer checks the frames and supplies the weights itself; the
                # module's own check of ~690 inputs a call costs milliseconds
                module.validate_inputs = False
                fns[int(b)] = _without_dtype_checks(module)
        return cls(fns, weights, meta, dev)

    def _pick_batch(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds the largest exported batch size "
                         f"{self.batch_sizes[-1]}: split the batch or re-export")

    def infer(self, raw1: np.ndarray, raw2: Optional[np.ndarray] = None
              ) -> Dict[str, np.ndarray]:
        """raw*: [n, h, w] raw grayscale frames (any scale: the percentile
        enhance is scale-invariant) at the exported input_hw. Pads n up to
        the smallest exported batch size and slices the outputs back."""
        if self.stereo != (raw2 is not None):
            raise ValueError("artifact was exported "
                             + ("with" if self.stereo else "without") + " a second view")
        raw1 = np.asarray(raw1, np.float32)
        if raw1.ndim != 3 or raw1.shape[1:] != self.input_hw:
            raise ValueError(f"expected [n, {self.input_hw[0]}, {self.input_hw[1]}] raw "
                             f"frames, got {raw1.shape}")
        n = raw1.shape[0]
        if n == 0:
            raise ValueError("empty batch: need at least one frame")
        b = self._pick_batch(n)
        views = [raw1] if raw2 is None else [raw1, np.asarray(raw2, np.float32)]
        padded = []
        for v in views:
            if v.shape[0] != n:
                raise ValueError("view batch sizes differ")
            if n < b:
                v = np.concatenate([v, np.repeat(v[-1:], b - n, axis=0)])
            padded.append(torch.from_numpy(np.ascontiguousarray(v)).to(self.device))
        # the engine's float32 convs run without TF32, a flag the program
        # does not record; bf16 convs are not affected
        with torch.inference_mode(), exact_float32_convs(torch.float32):
            out = self._fns[b](self._weights, *padded)
            return {k: v[:n].cpu().numpy() for k, v in out.items()}
