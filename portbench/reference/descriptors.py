"""Triangle descriptors (STDesc.cpp:174-315), plainly, on padded graphs.

For each node i of a scan: its ``near_num`` nearest nodes by squared
distance (self first, ties to the lower index), every pair (m, n) of them,
1 <= m < n, as a triangle; sides in [min_len, max_len]; vertices ordered
A, B, C opposite the longest, middle and shortest side; the first
triangle of each truncated millimetre side triple kept; at most
``max_descriptors`` kept, in (i, m, n) order.

The arithmetic is the configuration's float32: squared distances summed
as ((x^2 + y^2) + z^2); the two sides at vertex i accumulated by fused
multiply-adds rounded once to float32 (each product exact in float64), as
the JAX package compiles them on the CPU; correctly rounded roots. One
ulp decides which duplicates merge and which key cell a side falls in, so
the keys have one definition only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.params import Params


class Desc(NamedTuple):
    sides: torch.Tensor  # (F, D, 3) float32 ascending
    verts: torch.Tensor  # (F, D, 3, 3) float32 rows A, B, C
    labels: torch.Tensor  # (F, D, 3) int64
    mask: torch.Tensor  # (F, D) bool

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(-1)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 root (through float64)."""
    return torch.sqrt(x.double()).float()


def _norm_plain(d: torch.Tensor) -> torch.Tensor:
    s = d * d
    return sqrt_f32((s[..., 0] + s[..., 1]) + s[..., 2])


def _norm_fma(d: torch.Tensor) -> torch.Tensor:
    d64 = d.double()
    acc = (d64[..., 0] * d64[..., 0]).float()
    for k in (1, 2):
        acc = (d64[..., k] * d64[..., k] + acc.double()).float()
    return sqrt_f32(acc)


def _pairs(near: int):
    ms = [m for m in range(1, near - 1) for n in range(m + 1, near)]
    ns = [n for m in range(1, near - 1) for n in range(m + 1, near)]
    return ms, ns


def build(centers, labels, mask, p: Params) -> Desc:
    """Descriptors of padded graphs: centers (F, N, 3), labels (F, N),
    mask (F, N), all on one device."""
    pts = centers.float()
    f_n, n_n, _ = pts.shape
    dev = pts.device
    big = torch.tensor(1e30, device=dev)
    near = min(p.near_num, n_n)
    ms, ns = _pairs(near)

    diff = pts[:, :, None, :] - pts[:, None, :, :]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    both = mask[:, :, None] & mask[:, None, :]
    d2 = torch.where(both, d2, big)
    eye = torch.eye(n_n, dtype=torch.bool, device=dev)
    d2 = torch.where(eye & mask[:, :, None], torch.zeros((), device=dev), d2)
    d_s, order = torch.sort(d2, dim=-1, stable=True)
    knn, knn_ok = order[..., :near], d_s[..., :near] < 1e29

    rows = torch.arange(f_n, device=dev)
    take = lambda x, idx: x[rows.reshape(-1, *([1] * (idx.dim() - 1))), idx]  # x[f, idx[f, ...]]
    i2, i3 = knn[..., ms], knn[..., ns]  # (F, N, P)
    x1 = pts[:, :, None, :].expand(f_n, n_n, len(ms), 3)
    x2, x3 = take(pts, i2), take(pts, i3)
    a, b, c = _norm_fma(x1 - x2), _norm_fma(x1 - x3), _norm_plain(x3 - x2)
    raw = torch.stack([a, b, c], -1)
    ok = mask[:, :, None] & knn_ok[..., ms] & knn_ok[..., ns] & ((raw >= p.min_len) & (raw <= p.max_len)).all(-1)

    # Ascending sides; the vertex opposite side a (|x1 - x2|) is x3, b's x2, c's x1.
    srt = torch.argsort(raw, dim=-1, stable=True)
    sides = torch.gather(raw, -1, srt)
    opp = srt.flip(-1)  # A opposite the longest side
    verts = torch.stack([x3, x2, x1], -2)
    abc = torch.gather(verts, -2, opp[..., None].expand(*opp.shape, 3))
    nodes = torch.stack([i3, i2, torch.arange(n_n, device=dev)[None, :, None].expand_as(i2)], -1)
    lab = take(labels.long(), torch.gather(nodes, -1, opp))

    # First occurrence of each truncated millimetre triple, in (i, m, n) order.
    flat_n = n_n * len(ms)
    q = torch.trunc(sides * 1000.0).long().reshape(f_n, flat_n, 3)
    okf = ok.reshape(f_n, flat_n)
    key = torch.where(okf, (q[..., 0] << 32) | (q[..., 1] << 16) | q[..., 2], torch.full_like(q[..., 0], 1 << 48))
    idx = torch.arange(flat_n, device=dev)
    ks, perm = torch.sort((key << 14) | idx, dim=-1)
    grp = ks >> 14
    first = torch.cat([torch.ones_like(grp[:, :1], dtype=torch.bool), grp[:, 1:] != grp[:, :-1]], 1)
    keep = torch.zeros_like(okf).scatter_(1, perm, first) & okf

    # The first max_descriptors kept triangles, in (i, m, n) order.
    pri = torch.where(keep, idx, flat_n)
    comp = torch.argsort(pri, dim=-1, stable=True)[:, : p.max_descriptors]
    out_mask = torch.gather(pri, 1, comp) < flat_n
    g = lambda x: take(x.reshape(f_n, flat_n, *x.shape[3:]), comp)
    scale = torch.tensor(1.0 / p.side_resolution, dtype=torch.float32).item()
    return Desc(g(sides) * scale, g(abc), g(lab), out_mask)


def build_chunked(centers, labels, mask, p: Params, chunk: int = 64) -> Desc:
    """``build`` over frame chunks (bounded working memory)."""
    parts = [build(centers[i : i + chunk], labels[i : i + chunk], mask[i : i + chunk], p)
             for i in range(0, centers.shape[0], chunk)]
    return Desc(*(torch.cat(x) for x in zip(*parts)))
