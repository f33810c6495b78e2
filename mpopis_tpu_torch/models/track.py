"""Track geometry: CSV centerline loading, boundary offsets, and the batched
point-to-centerline distance query.

Counterpart of `mpopis_tpu/models/track.py`. The bundled centerline CSVs
are the JAX package's data files, read by path from
`mpopis_tpu/models/tracks/` without importing that package (which would
import jax). `distance_query` takes positions with any leading batch shape
(..., 2) in place of the reference's `jax.vmap` over a (2,) query.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

_TRACK_DIR = os.path.normpath(
    os.path.join(
        os.path.dirname(__file__), os.pardir, os.pardir,
        "mpopis_tpu", "models", "tracks",
    )
)


def track_path(name: str) -> str:
    """Resolve a bundled track name ('curve', 'cubic3', ...) to its CSV."""
    if os.path.sep in name or name.endswith(".csv"):
        return name
    return os.path.join(_TRACK_DIR, name + ".csv")


def _compute_boundaries(x: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Offset the centerline along central-difference normals."""
    n = len(x)
    left = np.zeros((n, 2))
    right = np.zeros((n, 2))
    for i in range(n):
        if i == 0:
            dx, dy = x[1] - x[0], y[1] - y[0]
        elif i == n - 1:
            dx, dy = x[-1] - x[-2], y[-1] - y[-2]
        else:
            dx, dy = x[i + 1] - x[i - 1], y[i + 1] - y[i - 1]
        p = np.array([-dy, dx])
        p = p / np.linalg.norm(p)
        c = np.array([x[i], y[i]])
        left[i] = c + w[i] * p
        right[i] = c - w[i] * p
    return left, right


@dataclasses.dataclass(frozen=True, eq=False)
class Track:
    """Immutable track: full-resolution centerline for bookkeeping,
    subsampled centerline (`xs`, `ys`, `lane_width_s`) for the query."""

    x: np.ndarray
    y: np.ndarray
    lane_width: np.ndarray
    xs: np.ndarray  # subsampled
    ys: np.ndarray
    lane_width_s: np.ndarray
    boundary_left: np.ndarray
    boundary_right: np.ndarray
    sample_factor: int

    @staticmethod
    def load(
        name_or_path: str = "curve",
        width: float | np.ndarray = 15.0,
        sample_factor: int = 20,
    ) -> "Track":
        data = np.loadtxt(track_path(name_or_path), delimiter=",")
        if data.ndim != 2 or data.shape[1] != 2:
            raise ValueError("track CSV must have exactly 2 columns")
        x, y = data[:, 0], data[:, 1]
        if np.ndim(width) == 0:
            w = np.full(len(x), float(width))
        else:
            w = np.asarray(width, dtype=float)
            if len(w) != len(x):
                raise ValueError("width vector length must match track length")
        left, right = _compute_boundaries(x, y, w)
        return Track(
            x=x,
            y=y,
            lane_width=w,
            xs=x[::sample_factor],
            ys=y[::sample_factor],
            lane_width_s=w[::sample_factor],
            boundary_left=left,
            boundary_right=right,
            sample_factor=sample_factor,
        )

    def query_arrays(self, dtype=torch.float32, device="cpu"):
        """Tensors for the distance query: (pts (M, 2), widths (M,))."""
        pts = torch.as_tensor(
            np.stack([self.xs, self.ys], axis=1), dtype=dtype, device=device
        )
        widths = torch.as_tensor(self.lane_width_s, dtype=dtype, device=device)
        return pts, widths


def distance_query(pts: torch.Tensor, widths: torch.Tensor, pos: torch.Tensor):
    """Distance from each `pos` (..., 2) to the centerline polyline.

    Returns (within (...,) bool, dist (...,)). `pts` is the (M, 2)
    subsampled centerline, `widths` the (M,) lane half-widths. Semantics of
    the reference, exactly: the nearest point is the first index among
    equal minima; the better of its two cyclic neighbours (ties to the
    previous one) closes the segment; `within` compares against the lane
    width at the nearest point's index, not the segment's.
    """
    m = pts.shape[0]
    d = pts - pos[..., None, :]  # (..., M, 2)
    d2 = torch.sum(d * d, dim=-1)
    i = torch.argmin(d2, dim=-1)
    im1 = torch.remainder(i - 1, m)
    ip1 = torch.remainder(i + 1, m)
    dist_m1 = torch.sqrt(torch.sum((pts[im1] - pos) ** 2, dim=-1))
    dist_p1 = torch.sqrt(torch.sum((pts[ip1] - pos) ** 2, dim=-1))
    i2 = torch.where(dist_m1 <= dist_p1, im1, ip1)
    p1 = pts[i]
    seg = pts[i2] - p1
    t = torch.sum((pos - p1) * seg, dim=-1) / torch.sum(seg * seg, dim=-1)
    proj = p1 + t[..., None] * seg
    dist = torch.sqrt(torch.sum((proj - pos) ** 2, dim=-1))
    return dist < widths[i], dist
