"""The port's import surface against the JAX package's. The JAX side is read
from its sources with ast (this file imports no jax):

* every public top-level name of thermal3d/**/*.py exists somewhere in
  thermal3d_torch/, under its own name or the port's name in RENAMED, or
  NOT_CARRIED_OVER says why it has no counterpart;
* every name a JAX sub-package's __init__.py re-exports (or defines) is an
  attribute of the port's sub-package, so `from thermal3d_torch.<sub> import
  <name>` works as `from thermal3d.<sub> import <name>` does;
* `thermal3d_torch.kernels.flash_attention` is the function, as in JAX, and
  the module stays reachable through sys.modules;
* `thermal3d_torch.infer` is lazy, as `thermal3d.infer` is.
"""

import ast
import importlib
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "thermal3d", ROOT / "thermal3d_torch"
SUBPACKAGES = sorted(p.name for p in JAX_PKG.iterdir() if (p / "__init__.py").is_file())

# JAX name → the reason the port has no counterpart (ROADMAP.md §3)
NOT_CARRIED_OVER = {
    # the TPU attention policy; the port routes by attention_route
    "FUSED_MIN_SEQ": "the TPU's sequence threshold for the fused kernels",
    "fused_auto_group": "the TPU's head-group sizes for the fused kernels",
    "use_fused_attention": "the TPU's 'auto' route to the fused kernels",
    "pin_attention_for_int8": "a TPU attention policy for int8 serving",
    # the port runs eagerly: the functions themselves are ported
    "compute_depth_metrics_jit": "a jax.jit wrapper",
    "estimate_camera_intrinsics_jit": "a jax.jit wrapper",
    "extract_relative_pose_jit": "a jax.jit wrapper",
    "umeyama_alignment_jit": "a jax.jit wrapper",
    # GSPMD placement; core/mesh.py and the process-sliced BatchLoader do it
    "data_sharding": "a GSPMD sharding",
    "replicated_sharding": "a GSPMD sharding",
    "shard_batch_multihost": "GSPMD placement of a batch",
    "shard_state": "GSPMD placement of the train state",
    "enable_compilation_cache": "XLA's compilation cache; kernels/_build.py caches builds",
    "default_compute_platform": "JAX's platform query; the port dispatches on each tensor's "
                                "device (core/device.py)",
    "convert_state_dict": "turns a .pth into a flax tree; the port loads the .pth itself",
    "convert_checkpoint": "turns a .pth into a flax tree; the port loads the .pth itself",
    "log_sample_images": "a wandb sample panel",
    "log_sample_images_with_edges": "a wandb sample panel",
    "sample_figure": "the matplotlib figure of the wandb sample panels",
    "steps_for_schedule": "no reader in either package",
    "SOBEL_X": "models/thermal_wrap.sobel_edge_magnitude writes the taps out",
    "SOBEL_Y": "models/thermal_wrap.sobel_edge_magnitude writes the taps out",
    "to_scan_params": "the port runs unrolled and reads either JAX layout "
                      "(models/scan_params.unrolled_params)",
    "to_branch_params": "the port runs unrolled and reads either JAX layout "
                        "(models/scan_params.unrolled_params)",
}
# JAX name → the port's name for the same function
RENAMED = {
    "make_optimizer": "AdamW",
    "optax_global_norm": "global_norm",
    "quantize_params_int8": "quantize_model_int8",
    "percentile_enhance_pallas": "percentile_enhance",
    "QuantDense": "Dense",
    "export_state_dict": "state_dict_from_jax",
}


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]


def _public_names(path: Path):
    """Public names a module defines at its top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_assigned(node))
    return {n for n in names if not n.startswith("_")}


def _package_names(root: Path):
    return set().union(*(_public_names(p) for p in root.rglob("*.py")))


PORT_NAMES = _package_names(PORT_PKG)


def _reexports(sub: str):
    """Names thermal3d/<sub>/__init__.py imports or defines, and the keys of
    a lazy package's _EXPORTS table."""
    tree = ast.parse((JAX_PKG / sub / "__init__.py").read_text())
    names = _public_names(JAX_PKG / sub / "__init__.py")
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign) and _assigned(node) == ["_EXPORTS"]:
            names.update(ast.literal_eval(node.value))
    return sorted(n for n in names if not n.startswith("_") and n not in ("annotations",))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_public_name_has_a_counterpart(sub):
    missing = sorted(
        f"{p.relative_to(ROOT)}: {name}"
        for p in (JAX_PKG / sub).rglob("*.py") for name in _public_names(p)
        if name not in PORT_NAMES and RENAMED.get(name) not in PORT_NAMES
        and name not in NOT_CARRIED_OVER)
    assert not missing, missing


def test_the_lists_of_exceptions_are_exact():
    """Each listed name is a public JAX name; no name said not to be carried
    over exists in the port; each renamed one exists only under its new
    name."""
    jax_names = _package_names(JAX_PKG)
    assert not (set(NOT_CARRIED_OVER) | set(RENAMED)) - jax_names
    assert not set(NOT_CARRIED_OVER) & PORT_NAMES
    assert not set(RENAMED) & PORT_NAMES
    assert set(RENAMED.values()) <= PORT_NAMES


@pytest.mark.parametrize("sub", [s for s in SUBPACKAGES if _reexports(s)])
def test_reexports_resolve_on_the_port_subpackage(sub):
    port = importlib.import_module(f"thermal3d_torch.{sub}")
    wanted = [n for n in _reexports(sub) if n not in NOT_CARRIED_OVER]
    missing = [n for n in wanted if not hasattr(port, n)]
    assert wanted and not missing, missing
    for name in wanted:  # each is the port's own object, not a module
        assert not isinstance(getattr(port, name), types.ModuleType), name


def test_kernels_flash_attention_is_the_function():
    """As in JAX, the package binds the function over its module's name:
    both import forms give the function; the module is in sys.modules."""
    kernels = importlib.import_module("thermal3d_torch.kernels")
    module = sys.modules["thermal3d_torch.kernels.flash_attention"]
    assert isinstance(module, types.ModuleType)
    assert kernels.flash_attention is module.flash_attention
    assert callable(kernels.flash_attention)
    import thermal3d_torch.kernels.flash_attention as m

    assert m is module.flash_attention
    assert importlib.import_module("thermal3d_torch.kernels.flash_attention") is module


def test_infer_is_lazy():
    """Importing thermal3d_torch.infer imports no engine and no model code;
    an exported name imports its module at first use; an unknown name raises
    AttributeError."""
    code = """
import sys
import thermal3d_torch.infer as infer
heavy = ("thermal3d_torch.infer.engine", "thermal3d_torch.infer.export",
         "thermal3d_torch.models")
assert not [m for m in heavy if m in sys.modules]
assert infer.ServingArtifact.__module__ == "thermal3d_torch.infer.export"
assert "thermal3d_torch.infer.engine" not in sys.modules
assert infer.InferenceEngine.__module__ == "thermal3d_torch.infer.engine"
try:
    infer.nothing
except AttributeError as e:
    assert "nothing" in str(e)
else:
    raise AssertionError("no AttributeError")
print("LAZY_OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "LAZY_OK" in proc.stdout, proc.stderr[-2000:]
