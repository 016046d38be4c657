"""Plain S3DIS room sweep and room-level label propagation (Xu & Lee, CVPR
2020: S3DIS/DataIO_S3DIS.py and Util/ProbLabelPropagation.py).

The sweep cuts a raw room [P, 7] (xyz in metres from its min corner, rgb
0-255, label) into 1 m x 1 m columns on the xy grid, bounds inclusive,
drops columns of fewer than 100 points and resamples each to ``points``
points: a draw of that many indices with replacement where there are
more, every point then such a draw of the rest where there are fewer.
Channels: xy centred in the column (z as is), rgb / 255, xyz over the
room's extent. The draws come from the caller's numpy generator in
column order, so the reference replays the trainers' stream.

The label propagation runs once over every block point of the room in
room coordinates, the blocks padded to a multiple of 8 with blocks of
uniform probabilities 2 m beyond the room's far corner (rgb 0):

    W_ij = exp(-(1e3 |xyz_i - xyz_j|^2 + 10 |rgb_i - rgb_j|^2))
    d = W 1,  s = d^-1/2,  c_i = 1 - H(G_i) / log2(K)
    (diag(alpha (d + 1e-8) s^2 + beta c + ridge) - alpha S W S) Y = c G

solved by conjugate gradients over the whole array as one vector, Jacobi
preconditioned, from 0, until |r|^2 <= tol^2 |c G|^2 or 50 iterations;
then beta Y normalised over classes. W is never held: every product
recomputes it from exact differences, in blocks of rows sorted by x, each
against the columns within sqrt(110 / 1e3) m in x. Every pair outside that
window has 1e3 dx^2 > 110, where exp in float32 is exactly 0.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

BLOCK, MIN_POINTS = 1.0, 100
XYZ_BW, RGB_BW, ALPHA, BETA, RIDGE, ITERS, TOL = 1e3, 1e1, 1.0, 1.0, 1e-5, 50, 1e-5
CUTOFF = 110.0  # exp(-110) is below float32's least subnormal


def columns(room: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(room extent, the point indices of every kept column in sweep
    order)."""
    xyz = room[:, 0:3]
    limit = xyz.max(axis=0)
    nx = int(np.ceil((limit[0] - BLOCK) / BLOCK)) + 1
    ny = int(np.ceil((limit[1] - BLOCK) / BLOCK)) + 1
    kept = []
    for i in range(nx):
        for j in range(ny):
            x0, y0 = i * BLOCK, j * BLOCK
            sel = np.nonzero((xyz[:, 0] >= x0) & (xyz[:, 0] <= x0 + BLOCK)
                             & (xyz[:, 1] >= y0) & (xyz[:, 1] <= y0 + BLOCK))[0]
            if len(sel) >= MIN_POINTS:
                kept.append(sel)
    return limit, kept


def resample(n: int, points: int, rng: np.random.Generator) -> np.ndarray:
    if n == points:
        return np.arange(n)
    if n > points:
        return rng.choice(n, points)
    return np.concatenate([np.arange(n), rng.choice(n, points - n)])


def sweep(room: np.ndarray, cols, points: int, rng: np.random.Generator,
          build: bool = True):
    """The room's blocks [K, points, 9] f32 and labels [K, points], or with
    ``build`` off only the generator's draws."""
    limit, kept = cols
    blocks, labels = [], []
    for sel in kept:
        pick = sel[resample(len(sel), points, rng)]
        if not build:
            continue
        pts = room[pick, 0:6].astype(np.float64)
        pts[:, 3:6] /= 255.0
        out = np.zeros((points, 9), np.float32)
        out[:, 6:9] = pts[:, 0:3] / limit
        pts[:, 0] -= pts[:, 0].min() + BLOCK / 2
        pts[:, 1] -= pts[:, 1].min() + BLOCK / 2
        out[:, 0:6] = pts
        blocks.append(out)
        labels.append(room[pick, 6].astype(np.int32))
    if not build:
        return None
    return np.stack(blocks), np.stack(labels)


def confidence(g: torch.Tensor) -> torch.Tensor:
    h = -(g * torch.log2(g + 1e-5)).sum(dim=-1)
    return 1.0 - h / math.log2(g.shape[-1])


class Affinity:
    """W of points (xyz, rgb) [N, 3] each, applied in x-sorted row blocks."""

    def __init__(self, xyz: torch.Tensor, rgb: torch.Tensor, rows: int = 2048):
        self.order = torch.argsort(xyz[:, 0], stable=True)
        self.xyz, self.rgb = xyz[self.order], rgb[self.order]
        x = self.xyz[:, 0].contiguous()
        h = math.sqrt(CUTOFF / XYZ_BW)
        starts = torch.arange(0, len(x), rows, device=x.device)
        ends = torch.clamp_max(starts + rows, len(x))
        lo = torch.searchsorted(x, x[starts] - h)
        hi = torch.searchsorted(x, x[ends - 1] + h, right=True)
        self.windows = list(zip(starts.tolist(), ends.tolist(), lo.tolist(),
                                hi.tolist()))

    def block(self, r0, r1, c0, c1) -> torch.Tensor:
        a = torch.zeros((r1 - r0, c1 - c0), device=self.xyz.device)
        for f, bw in ((self.xyz, XYZ_BW), (self.rgb, RGB_BW)):
            for ch in range(f.shape[1]):
                a.add_((f[r0:r1, ch, None] - f[None, c0:c1, ch]).square_(),
                       alpha=bw)
        return torch.exp_(a.neg_())

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """W u for u [N, K] in the sorted order."""
        out = torch.empty_like(u)
        for r0, r1, c0, c1 in self.windows:
            out[r0:r1] = self.block(r0, r1, c0, c1) @ u[c0:c1]
        return out

    def pairs(self, cutoff: float) -> int:
        """Ordered pairs whose exponent 1e3 |dxyz|^2 + 10 |drgb|^2 is at most
        ``cutoff`` (at most CUTOFF)."""
        return sum(int((self.block(*w) >= math.exp(-cutoff)).sum())
                   for w in self.windows)


def pad_room(xyz: np.ndarray, rgb: np.ndarray, prob: np.ndarray,
             room_max: np.ndarray):
    """The blocks [K, N, .] padded to a multiple of 8 as set out above."""
    k, n, c = prob.shape
    extra = -(-k // 8) * 8 - k
    if extra:
        xyz = np.concatenate([xyz, np.broadcast_to(
            (np.asarray(room_max, np.float32) + 2.0).reshape(1, 1, 3),
            (extra, n, 3))])
        rgb = np.concatenate([rgb, np.zeros((extra, n, 3), np.float32)])
        prob = np.concatenate([prob, np.full((extra, n, c), 1.0 / c, np.float32)])
    return xyz, rgb, prob


def room_label_prop(blocks: np.ndarray, prob: np.ndarray, room_max: np.ndarray,
                    device) -> torch.Tensor:
    """Propagated probabilities [K, N, C] of the room's K blocks."""
    k, n, c = prob.shape
    xyz = (blocks[:, :, 6:9] * room_max).astype(np.float32)
    xyz, rgb, prob = pad_room(xyz, blocks[:, :, 3:6].astype(np.float32),
                              prob.astype(np.float32), room_max)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1, a.shape[-1])).to(device)
    aff = Affinity(put(xyz), put(rgb))
    g = put(prob)[aff.order]
    d = aff.apply(torch.ones_like(g[:, :1]))
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))
    conf = confidence(g)[:, None]
    diag = ALPHA * (d + 1e-8) * s * s + BETA * conf + RIDGE

    def matvec(v):
        return diag * v - ALPHA * s * aff.apply(s * v)

    rhs = conf * g
    x = torch.zeros_like(rhs)
    r = rhs.clone()
    z = r / diag
    p = z
    gamma = (r * z).sum()
    atol2 = TOL * TOL * (rhs * rhs).sum()
    for _ in range(ITERS):
        if not bool((r * r).sum() > atol2):
            break
        ap = matvec(p)
        alpha = gamma / (p * ap).sum()
        x = x + alpha * p
        r = r - alpha * ap
        z = r / diag
        gamma_new = (r * z).sum()
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
    y = BETA * x
    den = y.sum(dim=-1, keepdim=True)
    y = y / torch.where(den.abs() < 1e-30, torch.ones_like(den), den)
    out = torch.empty_like(y)
    out[aff.order] = y
    return out.reshape(-1, n, c)[:k]
