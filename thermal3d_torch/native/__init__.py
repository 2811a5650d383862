"""The port's PNG batch decoder (counterpart of thermal3d/native, which
links libpng): needs no libpng, cv2 or PIL.

Per image: png_decode.cpp (built at first use with g++ into
thermal3d_torch/_build/, a host library beside the kernels) walks the chunks
and checks their CRCs; the stdlib zlib inflates the concatenated IDAT data;
png_decode.cpp unfilters the rows, expands the samples, and resizes and
scales them in float32 with the JAX loader's expression, so that
`load_thermal_batch` / `load_rgb_batch` are bit-equal to `thermal3d.native`'s.
All three release the GIL. A batch is decoded by a pool of threads, one image
a task; by default one core fewer than the machine has (at most 8), so that
the thread launching the card's work keeps a core: on the H100's 8-core
host, InferenceEngine.infer_paths ran slower with 8 decode threads than with
7 (chip_smoke.py's file phase times both).

Formats: gray 1/2/4/8/16-bit, gray+alpha, RGB 8/16, RGBA 8/16 and palette
(alpha is dropped; 16-bit samples are raw counts). An interlaced, truncated,
CRC-bad or non-PNG file gives ok=False for its row, never an exception. A
failed build raises: there is no other decoder to fall back to.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import dataclasses
import os
import threading
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from thermal3d_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "png_decode.cpp"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# bit depths the PNG standard allows for each colour type
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
CHANNELS_IN = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CHANNELS_OUT = {0: 1, 2: 3, 3: 3, 4: 1, 6: 3}
MODE_RAW, MODE_THERMAL, MODE_RGB = 0, 1, 2
MAX_PIXELS = 1 << 28  # refuse absurd headers before allocating for them
DEFAULT_THREADS = max(1, min(8, (os.cpu_count() or 2) - 1))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The decoder's host library, built on the first call. Raises
    RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
            i64 = ctypes.POINTER(ctypes.c_longlong)
            lib.t3d_png_scan.restype = ctypes.c_int
            lib.t3d_png_scan.argtypes = [ctypes.c_char_p, ctypes.c_longlong, i64, i64, i64,
                                         ctypes.c_int]
            lib.t3d_png_decode.restype = ctypes.c_int
            lib.t3d_png_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p]
            _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """The error text that keeps the decoder's host library from building or
    loading (building it on the first call), or None once it is loaded. It
    only reports: `library()` raises that error, and nothing falls back."""
    try:
        library()
    except (RuntimeError, OSError) as e:
        return str(e)
    return None


def available() -> bool:
    """Whether the decoder's host library is built and loaded."""
    return build_error() is None


@dataclasses.dataclass
class Png:
    """A PNG's header and its inflated, still filtered rows."""

    width: int
    height: int
    bit_depth: int
    color_type: int
    palette: bytes
    rows: bytes

    @property
    def channels(self) -> int:
        """Channels after decoding: 1 (gray, gray+alpha) or 3."""
        return CHANNELS_OUT[self.color_type]


def read_png(path: str) -> Optional[Png]:
    """Read, walk and inflate one file; None for a missing, non-PNG,
    interlaced, truncated or CRC-bad file. As libpng does, a bad CRC fails a
    critical chunk and drops an ancillary one, and the file may end after the
    image data (no IEND). The chunk walk and the CRCs run in C++
    (t3d_png_scan) and the inflate in zlib, both outside the GIL."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    if not data.startswith(SIGNATURE):
        return None
    lib = library()
    header = (ctypes.c_longlong * 7)()
    plte = (ctypes.c_longlong * 2)()
    room = 256
    while True:
        idat = (ctypes.c_longlong * (2 * room))()
        n = lib.t3d_png_scan(data, len(data), header, plte, idat, room)
        if n <= room:
            break
        room = n
    if n <= 0:
        return None
    w, h, depth, color, compression, filtering, interlace = header
    palette = data[plte[0]:plte[0] + plte[1]]
    if (color not in DEPTHS or depth not in DEPTHS[color] or compression or filtering
            or interlace or not 0 < w * h <= MAX_PIXELS or len(palette) % 3
            or (color == 3 and not palette)):
        return None
    stride = (w * CHANNELS_IN[color] * depth + 7) // 8
    need = h * (stride + 1)
    view = memoryview(data)
    parts = [view[idat[2 * i]:idat[2 * i] + idat[2 * i + 1]] for i in range(n)]
    try:
        rows = zlib.decompressobj().decompress(parts[0] if n == 1 else b"".join(parts), need)
    except zlib.error:
        return None
    if len(rows) < need:
        return None
    return Png(w, h, depth, color, palette, rows)


def _decode_into(png: Png, mode: int, out: np.ndarray, scale: float = 1.0) -> bool:
    """Run the C++ half on one parsed image, writing `out` (C-contiguous
    float32 of the size the mode implies)."""
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("decode buffer must be C-contiguous float32")
    if mode == MODE_RAW:
        want = (png.height, png.width, png.channels)
        out_h = out_w = 0
    else:
        out_h, out_w = out.shape[:2]
        want = (out_h, out_w) if mode == MODE_THERMAL else (out_h, out_w, 3)
    if out.shape != want:
        raise ValueError(f"decode buffer {out.shape}, want {want}")
    rc = library().t3d_png_decode(
        png.rows, png.width, png.height, png.bit_depth, png.color_type,
        png.palette, len(png.palette) // 3, mode, out_h, out_w, scale, out.ctypes.data)
    return rc == 0


def decode_png(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """One file at full resolution → (float32 [H, W, C] raw samples, C = 1 or
    3; bit depth after expansion, 8 or 16), or None if it does not decode."""
    png = read_png(path)
    if png is None:
        return None
    out = np.empty((png.height, png.width, png.channels), np.float32)
    if not _decode_into(png, MODE_RAW, out):
        return None
    return out, 16 if png.bit_depth == 16 else 8


def _scale(png: Png, normalize: bool) -> float:
    """The JAX loader's float32 scale: 1/65535 for 16-bit, 1/255 otherwise."""
    if not normalize:
        return 1.0
    return float(np.float32(1.0) / np.float32(65535.0 if png.bit_depth == 16 else 255.0))


def _batch(paths: Sequence[str], out: np.ndarray, mode: int, normalize: bool,
           n_threads: int) -> np.ndarray:
    """Decode every path into its row of `out` on a pool of threads; rows
    that fail are zero. Returns ok bool [N]."""
    library()  # build (and raise) before any worker runs
    ok = np.zeros(len(paths), dtype=bool)

    def work(i: int) -> None:
        png = read_png(paths[i])
        if png is not None:
            ok[i] = _decode_into(png, mode, out[i], _scale(png, normalize))
        if not ok[i]:
            out[i] = 0.0

    with cf.ThreadPoolExecutor(max(1, n_threads)) as pool:
        for fut in [pool.submit(work, i) for i in range(len(paths))]:
            fut.result()
    return ok


def load_thermal_batch(paths: List[str], out_hw: Tuple[int, int], normalize: bool = True,
                       n_threads: int = DEFAULT_THREADS) -> Tuple[np.ndarray, np.ndarray]:
    """→ (float32 [N, H, W], ok bool [N]). Multi-channel frames are the plain
    mean of their colour channels; normalize divides by 65535 (16-bit) or 255
    after the resize. Failed decodes are zero-filled."""
    h, w = out_hw
    out = np.zeros((len(paths), h, w), dtype=np.float32)
    ok = _batch(list(paths), out, MODE_THERMAL, normalize, n_threads)
    return out, ok


def load_rgb_batch(paths: List[str], out_hw: Tuple[int, int], n_threads: int = DEFAULT_THREADS
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (float32 [N, H, W, 3] in [0, 1], ok bool [N]). Gray frames are
    repeated to three channels."""
    h, w = out_hw
    out = np.zeros((len(paths), h, w, 3), dtype=np.float32)
    ok = _batch(list(paths), out, MODE_RGB, True, n_threads)
    return out, ok
