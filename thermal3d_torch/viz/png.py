"""A PNG encoder for the figures: 8-bit RGB, every row filter 0 (None),
deflated by the stdlib zlib. Needs no libpng, cv2 or matplotlib."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def encode_png_rgb(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W, 3] → the bytes of an RGB8 PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape[:2]:
        raise ValueError(f"want a non-empty uint8 [H, W, 3] image, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # a leading filter byte of 0 a row
    rows[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_rgb(img))
