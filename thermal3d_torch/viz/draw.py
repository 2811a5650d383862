"""Raster primitives for the port's figures, on uint8 [H, W, 3] images in
pixel coordinates (x right, y down; a pixel's centre at its integer
coordinates): filled rounded rectangles with an edge, line segments (solid
or dashed) of a width, filled triangles, arrows, and single-pixel points.
Each fills the pixels whose centres fall inside the shape: no
anti-aliasing, so what is drawn is exact and testable."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Color = Sequence[int]


def hex_color(code: str) -> Tuple[int, int, int]:
    """'#rrggbb' → (r, g, b)."""
    code = code.lstrip("#")
    return tuple(int(code[i:i + 2], 16) for i in (0, 2, 4))


def _window(img, x0, y0, x1, y1):
    """The integer pixel window covering [x0, x1] × [y0, y1], clipped to img,
    and the centres' coordinates in it."""
    h, w = img.shape[:2]
    c0, c1 = max(int(np.floor(x0)), 0), min(int(np.ceil(x1)) + 1, w)
    r0, r1 = max(int(np.floor(y0)), 0), min(int(np.ceil(y1)) + 1, h)
    ys, xs = np.mgrid[r0:r1, c0:c1]
    return (slice(r0, r1), slice(c0, c1)), xs.astype(np.float64), ys.astype(np.float64)


def _inside_round_rect(xs, ys, x0, y0, x1, y1, r):
    cx = np.clip(xs, x0 + r, x1 - r)
    cy = np.clip(ys, y0 + r, y1 - r)
    return (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r + 1e-9


def round_rect(img: np.ndarray, x0: float, y0: float, x1: float, y1: float, radius: float,
               fill: Color, edge: Optional[Color] = None, width: float = 1.0) -> None:
    """A rectangle with corners rounded by `radius`, filled, with an edge
    `width` pixels wide inside its outline."""
    win, xs, ys = _window(img, x0, y0, x1, y1)
    outer = _inside_round_rect(xs, ys, x0, y0, x1, y1, radius)
    img[win][outer] = fill
    if edge is not None:
        inner = _inside_round_rect(xs, ys, x0 + width, y0 + width, x1 - width, y1 - width,
                                   max(radius - width, 0.0))
        img[win][outer & ~inner] = edge


def segment(img: np.ndarray, p0, p1, color: Color, width: float = 1.0,
            dash: Optional[Tuple[float, float]] = None) -> None:
    """The pixels within width/2 of the segment p0–p1; `dash` (on, off)
    lengths in pixels along it leave gaps."""
    (x0, y0), (x1, y1) = p0, p1
    half = width / 2.0
    win, xs, ys = _window(img, min(x0, x1) - half, min(y0, y1) - half,
                          max(x0, x1) + half, max(y0, y1) + half)
    dx, dy = x1 - x0, y1 - y0
    length2 = dx * dx + dy * dy
    t = np.zeros_like(xs) if length2 == 0 else np.clip(
        ((xs - x0) * dx + (ys - y0) * dy) / length2, 0.0, 1.0)
    near = (xs - (x0 + t * dx)) ** 2 + (ys - (y0 + t * dy)) ** 2 <= half * half + 0.25
    if dash is not None:
        on, off = dash
        near &= np.mod(t * np.sqrt(length2), on + off) < on
    img[win][near] = color


def triangle(img: np.ndarray, a, b, c, color: Color) -> None:
    """The pixels whose centres lie in the triangle abc (edges included)."""
    pts = np.array([a, b, c], np.float64)
    win, xs, ys = _window(img, *pts.min(axis=0), *pts.max(axis=0))

    def side(p, q):
        return (q[0] - p[0]) * (ys - p[1]) - (q[1] - p[1]) * (xs - p[0])

    s = [side(pts[i], pts[(i + 1) % 3]) for i in range(3)]
    inside = ((s[0] >= 0) & (s[1] >= 0) & (s[2] >= 0)) | ((s[0] <= 0) & (s[1] <= 0) & (s[2] <= 0))
    img[win][inside] = color


def arrow(img: np.ndarray, p0, p1, color: Color, width: float = 1.0,
          head: float = 10.0) -> None:
    """A shaft from p0 to the base of a filled head whose tip is p1 (the
    head `head` pixels long and as wide)."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = p1 - p0
    n = np.linalg.norm(d)
    if n == 0:
        return
    u = d / n
    base = p1 - u * min(head, n)
    normal = np.array([-u[1], u[0]]) * head / 2.0
    segment(img, p0, base, color, width)
    triangle(img, p1, base + normal, base - normal, color)


def points(img: np.ndarray, xy: np.ndarray, colors) -> None:
    """Single-pixel points at the rounded [N, 2] (x, y), in order (a later
    point covers an earlier one); `colors` uint8 [N, 3] or one colour.
    Points outside the image are dropped."""
    xy = np.rint(np.asarray(xy, np.float64)).astype(np.int64)
    colors = np.broadcast_to(np.asarray(colors, np.uint8), (len(xy), 3))
    h, w = img.shape[:2]
    keep = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
    img[xy[keep, 1], xy[keep, 0]] = colors[keep]
