"""Build the CUDA sources under kernels/csrc/ into shared libraries.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). The libraries go to `thermal3d_torch/_build/`, named by
a hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source rebuilds and an unchanged one is reused. All sources build at once, one nvcc process each, at the first
call that needs any of them.

No `--use_fast_math`: the percentile kernel's `floor(x * 65535)` bins and its
divisions must round as IEEE float32 does, to agree bit for bit with the
reference arithmetic.

Failures raise: no nvcc, a compile error (with nvcc's stderr), a library that
will not load. There is no fallback to the plain PyTorch versions here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("percentile_enhance", "rope_attention", "rope_attention_tc", "attention",
           "attention_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of thermal3d_torch cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.
    Returns {name: library path}. Raises RuntimeError on any failure."""
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                          f"{out}{err}")
            tmp.unlink(missing_ok=True)
            continue
        # nvcc's report (-Xptxas=-v: registers, shared memory, spills) is
        # kept beside the library
        path.with_suffix(".log").write_text(out + err)
        os.replace(tmp, path)  # atomic: a concurrent builder sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build_log(name: str) -> str:
    """nvcc's output for the current build of `name` ('' if not built here)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all sources on the
    first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                if n not in _libs:
                    _libs[n] = load(p)
            lib = _libs[name]
        return lib


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its `t3d_error_string`."""
    lib = ctypes.CDLL(str(path))
    lib.t3d_error_string.argtypes = [ctypes.c_int]
    lib.t3d_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.t3d_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
