"""Host-side image IO (counterpart of thermal3d/preprocess/io.py).

Every decode goes through the port's own PNG decoder (thermal3d_torch.native):
the card's machine has no cv2, PIL or libpng, so a path that is not a PNG
raises ValueError instead of reaching another decoder. Missing and
undecodable files are dropped (None, or ok=False), as in the reference.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from thermal3d_torch import native
from thermal3d_torch.core.device import resolve_device
from thermal3d_torch.preprocess.enhance import enhance_thermal_contrast
from thermal3d_torch.preprocess.resize import resize_bilinear_hw


def require_png(*paths: str) -> None:
    """Raise ValueError for a path that does not end in .png."""
    for path in paths:
        if not path.lower().endswith(".png"):
            raise ValueError(f"{path}: thermal3d_torch decodes PNG files only "
                             "(it has no cv2 or PIL to read other formats)")


def load_thermal_image(path: str, normalize: bool = True) -> Optional[np.ndarray]:
    """Decode a thermal frame → float32 [H, W] at full resolution (raw
    counts, or normalized), None if it is missing or does not decode.

    The scale follows the DECODED type, not the pixel values: a 16-bit file
    divides by 65535 even when its maximum is at most 255; an 8-bit one by
    255. Multi-channel frames are the plain mean of their colour channels."""
    require_png(path)
    if not os.path.exists(path):
        return None
    decoded = native.decode_png(path)
    if decoded is None:
        return None
    img, depth = decoded
    img = img[..., 0] if img.shape[-1] == 1 else img.mean(axis=-1)
    if normalize:
        img = img / (65535.0 if depth == 16 else 255.0)
    return img.astype(np.float32)


def load_thermal_images_batch(paths: Sequence[str], normalize: bool = True,
                              out_hw: Optional[Tuple[int, int]] = None
                              ) -> Tuple[List[np.ndarray], List[str]]:
    """Batch-decode thermal frames → (list of float32 [h, w], surviving
    paths). With out_hw the decoder's thread pool decodes and resizes the
    batch; without it each frame is decoded at full resolution. Failed
    decodes are dropped from both lists."""
    paths = list(paths)
    require_png(*paths)
    if out_hw is not None:
        arr, ok = native.load_thermal_batch(paths, tuple(out_hw), normalize=normalize)
        return ([arr[i] for i in range(len(paths)) if ok[i]],
                [p for p, o in zip(paths, ok) if o])
    grays, survivors = [], []
    for p in paths:
        g = load_thermal_image(p, normalize=normalize)
        if g is not None:
            grays.append(g)
            survivors.append(p)
    return grays, survivors


def decode_thermal_batch(paths: Sequence[str], out_hw: Tuple[int, int],
                         normalize: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned batch decode+resize → (float32 [N, H, W], ok bool [N]); rows
    stay aligned with `paths`, failed decodes zero-filled with ok=False."""
    paths = list(paths)
    require_png(*paths)
    return native.load_thermal_batch(paths, tuple(out_hw), normalize=normalize)


def preprocess_thermal_for_model(path: str, img_size: Tuple[int, int] = (224, 224),
                                 device=None) -> Optional[np.ndarray]:
    """One frame as the model sees it (thermal_dustr_inference.py:25-60):
    decode, normalise, bilinear resize to img_size and percentile-enhance
    (K1 on CUDA, the sort path on the CPU) on `device` (None: CUDA) →
    float32 [H, W, 3] in [0, 1], or None if the frame is missing or does
    not decode."""
    gray = load_thermal_image(path, normalize=True)
    if gray is None:
        return None
    return _resize_enhance([gray], img_size, resolve_device(device))[0]


def preprocess_thermal_batch(paths: Sequence[str], img_size: Tuple[int, int] = (224, 224),
                             device=None) -> np.ndarray:
    """preprocess_thermal_for_model over `paths` in one batch on `device`:
    frames that fail to decode are dropped; frames whose size differs from
    the first's are first resized to it. → float32 [N, H, W, 3]."""
    dev = resolve_device(device)
    grays = [g for g in (load_thermal_image(p, normalize=True) for p in paths) if g is not None]
    if not grays:
        return np.zeros((0, *img_size, 3), dtype=np.float32)
    return _resize_enhance(grays, img_size, dev)


def _resize_enhance(grays: List[np.ndarray], img_size, dev: torch.device) -> np.ndarray:
    hw = grays[0].shape
    with torch.inference_mode():
        frames = [torch.from_numpy(g).to(dev) for g in grays]
        stack = torch.stack([t if t.shape == hw else resize_bilinear_hw(t, hw) for t in frames])
        out = enhance_thermal_contrast(resize_bilinear_hw(stack, tuple(img_size)))
        return out.contiguous().cpu().numpy()


def load_rgb_image(path: str) -> Optional[np.ndarray]:
    """Decode an RGB frame → float32 [H, W, 3] in [0, 1] (gray repeated to
    three channels, alpha dropped), None if missing or undecodable."""
    require_png(path)
    if not os.path.exists(path):
        return None
    decoded = native.decode_png(path)
    if decoded is None:
        return None
    img, depth = decoded
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return (img / np.float32(65535.0 if depth == 16 else 255.0)).astype(np.float32)
