"""The 3-D panels' view: points projected as the reference figure's 3-D axes
project them, drawn as pixels.

The JAX panels (thermal3d/viz/panels.py:277-459) scatter pointmaps into a
matplotlib Axes3D with no `view_init`, so at its default view: elevation
30°, azimuth −60°, roll 0, z vertical, box aspect 4:4:3, camera distance 10,
perspective with focal length 1. `projection` restates Axes3D.get_proj
(matplotlib 3.10.8) for that view and the box's limits, `project` restates
proj3d.proj_transform; tests hold both against mpl_toolkits.mplot3d.

A `View` fits the projected box of its limits into a square tile and draws
points (far ones first, so near ones cover them), line segments and dashed
lines there. The limits are the drawn data's range plus 5% each side (not
matplotlib's autoscale), and no axes, ticks or labels are drawn.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from thermal3d_torch.viz import draw

ELEV, AZIM = 30.0, -60.0
DIST = 10.0
FOCAL_LENGTH = 1.0
TILE = 480  # pixels of a 3-D tile's side
MARGIN = 0.05  # of each axis's range, each side


def box_aspect() -> np.ndarray:
    """Axes3D.set_box_aspect(None): (4, 4, 3) scaled as matplotlib scales it."""
    aspect = np.asarray((4, 4, 3), dtype=float)
    aspect *= 1.8294640721620434 * 25 / 24 * 1 / np.linalg.norm(aspect)
    return aspect


def projection(xlim, ylim, zlim, elev: float = ELEV, azim: float = AZIM) -> np.ndarray:
    """The 4×4 matrix of Axes3D.get_proj for the limits, at roll 0 with z
    vertical, perspective at FOCAL_LENGTH."""
    aspect = box_aspect()
    (x0, x1), (y0, y1), (z0, z1) = xlim, ylim, zlim
    dx, dy, dz = (x1 - x0) / aspect[0], (y1 - y0) / aspect[1], (z1 - z0) / aspect[2]
    world = np.array([[1 / dx, 0, 0, -x0 / dx], [0, 1 / dy, 0, -y0 / dy],
                      [0, 0, 1 / dz, -z0 / dz], [0, 0, 0, 1]])
    r = 0.5 * aspect
    elev_rad, azim_rad = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(elev_rad) * np.cos(azim_rad), np.cos(elev_rad) * np.sin(azim_rad),
                   np.sin(elev_rad)])
    eye = r + DIST * ps
    vertical = np.array([0.0, 0.0, -1.0 if abs(np.deg2rad(elev)) > np.pi / 2 else 1.0])
    w = (eye - r) / np.linalg.norm(eye - r)
    u = np.cross(vertical, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    eye_focal = r + DIST * ps * FOCAL_LENGTH
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, -1] = -eye_focal
    view = np.dot(rot, shift)
    zfront, zback = -DIST, DIST
    persp = np.array([[FOCAL_LENGTH, 0, 0, 0], [0, FOCAL_LENGTH, 0, 0],
                      [0, 0, (zfront + zback) / (zfront - zback),
                       -2 * (zfront * zback) / (zfront - zback)],
                      [0, 0, -1, 0]])
    return np.dot(persp, np.dot(view, world))


def project(points: np.ndarray, m: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[N, 3] points → their projected (x, y, z) as proj3d.proj_transform
    gives them: x right, y up; z orders them by depth (larger is farther)."""
    p = np.asarray(points, dtype=float)
    vec = np.array([p[:, 0], p[:, 1], p[:, 2], np.ones(len(p))])
    vecw = np.dot(m, vec)
    w = vecw[3]
    return vecw[0] / w, vecw[1] / w, vecw[2] / w


def limits(*point_sets: np.ndarray):
    """The three axes' limits: the points' range plus MARGIN each side (a
    flat axis gets ±0.5)."""
    pts = np.concatenate([np.asarray(p, float).reshape(-1, 3) for p in point_sets])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = hi - lo
    pad = np.where(span > 0, MARGIN * span, 0.5)
    return tuple((float(a), float(b)) for a, b in zip(lo - pad, hi + pad))


class View:
    """A square tile of TILE pixels showing the box of `lims` at the
    default view, the projected box fitted into the tile."""

    def __init__(self, lims, size: int = TILE):
        self.m = projection(*lims)
        corners = np.array([[x, y, z] for x in lims[0] for y in lims[1] for z in lims[2]])
        cx, cy, _ = project(corners, self.m)
        self.origin = np.array([cx.min(), cy.max()])
        span = max(cx.max() - cx.min(), cy.max() - cy.min())
        self.scale = (size - 1) / span
        self.image = np.full((size, size, 3), 255, np.uint8)

    def pixels(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[N, 3] points → [N, 2] pixel (x, y) and their projected depth."""
        x, y, z = project(points, self.m)
        xy = np.stack([(x - self.origin[0]) * self.scale, (self.origin[1] - y) * self.scale], -1)
        return xy, z

    def scatter(self, points: np.ndarray, colors) -> None:
        """Points as single pixels, far ones first; colors uint8 [N, 3] or
        one colour."""
        if not len(points):
            return
        xy, z = self.pixels(points)
        order = np.argsort(-z, kind="stable")
        colors = np.broadcast_to(np.asarray(colors, np.uint8), (len(points), 3))
        draw.points(self.image, xy[order], colors[order])

    def line(self, p0, p1, color, dash: Optional[Sequence[float]] = None) -> None:
        (a, b), _ = self.pixels(np.array([p0, p1], float))
        draw.segment(self.image, a, b, color, width=1.5, dash=dash)
