"""The descriptor database and the candidate search, plainly
(STDesc.cpp:149-172, 318-460, with the configuration's pair-list rules).

Database: every map descriptor keyed by its round-half-up side cell and
its label triple, rows in (key, frame, slot) order. A query descriptor
probes the 27 truncated neighbour cells within 1.5 cells of its sides;
every row of a probed bucket whose 1/256 fixed-point sides lie within
``rough_dis_threshold`` of the query's is a hit and one vote for the row's
keyframe. Candidates: the ``candidate_num`` frames of most votes, ties to
the lower frame id; valid from ``min_votes``.

Pair lists, as the configuration bounds them: a query whose probe total
fits the calibrated scan budget keeps each descriptor's hits in scan order,
strided down to ``hits_per_descriptor`` when it has more, and a candidate
takes its frame's kept hits in (descriptor, rank) order, at most
``pairs_per_candidate``; a query past the budget takes, candidate by
candidate, the rows of the frame in key order, each against at most
``probes_per_key`` query probes of equal key (float sides in the rough
filter), at most ``pairs_per_candidate``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.descriptors import Desc, sqrt_f32
from portbench.reference.params import Params

N_CODES = 13 * 13 * 13
OFFSETS = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1).reshape(27, 3)
_NO_KEY = 2**31 - 1


class DB(NamedTuple):
    keys: torch.Tensor  # (M,) int64, sorted; invalid rows last
    fixed: torch.Tensor  # (M, 3) int64 1/256 sides
    sides: torch.Tensor  # (M, 3) float32 (the 1/256 sides, exact)
    verts: torch.Tensor  # (M, 3, 3) float32
    frame: torch.Tensor  # (M,) int64
    poses: torch.Tensor  # (F_pad, 4, 4) float64
    f_pad: int
    num_rows: int


class Query(NamedTuple):
    votes: torch.Tensor  # (F_pad,) int64
    frames: torch.Tensor  # (C,) candidates, votes descending
    cand_votes: torch.Tensor  # (C,)
    valid: torch.Tensor  # (C,) bool
    pair_q: list  # C tensors of query descriptor ids
    pair_row: list  # C tensors of DB rows
    total: int  # probe-scan total
    trunc: bool  # past the scan budget: candidate-major pair lists


def _code(labels: torch.Tensor) -> torch.Tensor:
    l = labels.long().clamp(0, 12)
    return (l[..., 0] * 13 + l[..., 1]) * 13 + l[..., 2]


def _pack(cell: torch.Tensor, code: torch.Tensor, e: int) -> torch.Tensor:
    c = cell.clamp(0, e - 1)
    return ((c[..., 0] * e + c[..., 1]) * e + c[..., 2]) * N_CODES + code


def build_db(desc: Desc, poses: np.ndarray, p: Params) -> DB:
    f_n, d_n = desc.mask.shape
    dev = desc.sides.device
    valid = desc.mask.reshape(-1)
    sides = desc.sides.reshape(-1, 3)
    key = _pack(torch.floor(sides + 0.5).long(), _code(desc.labels.reshape(-1, 3)), p.extent)
    key = torch.where(valid, key, torch.full_like(key, 1 << 40))
    key_s, order = torch.sort(key, stable=True)
    n = int(valid.sum())
    order = order[:n]
    fixed = torch.round(sides[order] * 256.0).clamp(0, 65535).long()
    f_pad = max(-(-f_n // 8) * 8, 8)
    fp = np.tile(np.eye(4), (f_pad, 1, 1))
    fp[:f_n] = np.asarray(poses, np.float32)
    return DB(
        keys=key_s[:n], fixed=fixed, sides=fixed.float() * (1.0 / 256.0), verts=desc.verts.reshape(-1, 3, 3)[order],
        frame=torch.arange(f_n, device=dev).repeat_interleave(d_n)[order],
        poses=torch.as_tensor(fp, dtype=torch.float64, device=dev), f_pad=f_pad, num_rows=n,
    )


def _probes(sides: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, p: Params):
    """(D, 27) probe keys and their gate (1.5 cells, live descriptors)."""
    offs = torch.as_tensor(OFFSETS, dtype=torch.float32, device=sides.device)
    voxel = torch.trunc(sides[:, None, :] + offs).long()
    d = sides[:, None, :] - (voxel.float() + 0.5)
    s = d * d
    gate = (sqrt_f32((s[..., 0] + s[..., 1]) + s[..., 2]) < 1.5) & mask[:, None]
    return _pack(voxel, _code(labels)[:, None], p.extent), gate


def scan_total(db: DB, sides, labels, mask, p: Params) -> int:
    key, gate = _probes(sides, labels, mask, p)
    lo = torch.searchsorted(db.keys, key[gate])
    hi = torch.searchsorted(db.keys, key[gate], right=True)
    return int((hi - lo).sum())


def scan_budget(totals, p: Params) -> int:
    """The calibrated scan budget: ``calibrate_margin`` x the largest probe
    total of the first ``calibrate_queries`` queries, up to a multiple of
    8,192 slots, at least 8,192, never above ``max_scan_slots``."""
    fitted = max(8192, -(-int(max(totals) * p.calibrate_margin) // 8192) * 8192)
    return min(fitted, p.max_scan_slots)


def query(db: DB, sides, labels, mask, p: Params, budget: int) -> Query:
    """Votes, candidates and pair lists of one query's descriptors
    (D, 3) sides, (D, 3) labels, (D,) mask."""
    dev = sides.device
    key, gate = _probes(sides, labels, mask, p)  # (D, 27)
    lo = torch.searchsorted(db.keys, key)
    hi = torch.searchsorted(db.keys, key, right=True)
    length = torch.where(gate, hi - lo, 0).reshape(-1)
    total = int(length.sum())

    # Every (probe, row) of the probed buckets, in scan order.
    job = torch.repeat_interleave(torch.arange(length.numel(), device=dev), length)
    head = torch.cumsum(length, 0) - length
    row = lo.reshape(-1)[job] + torch.arange(job.numel(), device=dev) - head[job]
    desc = job // 27
    qq = torch.round(sides * 256.0).clamp(0, 32767).long()
    d = db.fixed[row] - qq[desc]
    dis2 = (d * d).sum(-1).float()
    qs2 = (qq * qq).sum(-1).float()
    thr2 = qs2 * float(np.float32(p.rough_dis_threshold) ** 2)
    hit = dis2 < thr2[desc]
    votes = torch.bincount(db.frame[row[hit]], minlength=db.f_pad)

    c_n = min(p.candidate_num, db.f_pad)
    order = torch.sort(-votes, stable=True).indices[:c_n]
    cand_votes = votes[order]
    valid = cand_votes >= p.min_votes
    trunc = total > budget
    if trunc:
        pair_q, pair_row = _pairs_by_frame(db, sides, labels, mask, key, gate, order, valid, p)
    else:
        pair_q, pair_row = _pairs_by_descriptor(db, row[hit], desc[hit], order, valid, p)
    return Query(votes, order, cand_votes, valid, pair_q, pair_row, total, trunc)


def _pairs_by_descriptor(db: DB, hit_row, hit_desc, frames, valid, p: Params):
    u = p.hits_per_descriptor
    dev = hit_row.device
    n_d = torch.bincount(hit_desc, minlength=int(hit_desc.max()) + 1 if hit_desc.numel() else 1)
    first = torch.cumsum(n_d, 0) - n_d
    rank = torch.arange(hit_row.numel(), device=dev) - first[hit_desc]
    stride = (n_d[hit_desc] - 1) // u + 1
    keep = rank % stride == 0
    slot = hit_desc[keep] * u + rank[keep] // stride[keep]
    fr = db.frame[hit_row[keep]]
    srt = torch.argsort(fr * (1 << 32) + slot)
    fr, slot, rows = fr[srt], slot[srt], hit_row[keep][srt]
    pair_q, pair_row = [], []
    for f, ok in zip(frames.tolist(), valid.tolist()):
        a, b = int(torch.searchsorted(fr, f)), int(torch.searchsorted(fr, f, right=True))
        b = min(b, a + p.pairs_per_candidate) if ok else a
        pair_q.append(slot[a:b] // u)
        pair_row.append(rows[a:b])
    return pair_q, pair_row


def _pairs_by_frame(db: DB, sides, labels, mask, key, gate, frames, valid, p: Params):
    pkey = torch.where(gate, key, _NO_KEY).reshape(-1)
    pkey_s, porder = torch.sort(pkey, stable=True)
    pdesc = porder // 27
    n_p = pkey.numel()
    s2 = sides * sides
    thr2 = ((s2[:, 0] + s2[:, 1]) + s2[:, 2]) * float(np.float32(p.rough_dis_threshold) ** 2)
    pair_q, pair_row = [], []
    for f, ok in zip(frames.tolist(), valid.tolist()):
        rows = torch.nonzero(db.frame == f)[:, 0] if ok else db.frame[:0]
        rk = db.keys[rows]
        p_lo = torch.searchsorted(pkey_s, rk)
        j = (p_lo[:, None] + torch.arange(p.probes_per_key, device=rk.device)).clamp(max=n_p - 1)
        qd = pdesc[j]
        ds = db.sides[rows][:, None, :] - sides[qd]
        dis2 = (ds[..., 0] * ds[..., 0] + ds[..., 1] * ds[..., 1]) + ds[..., 2] * ds[..., 2]
        m = (pkey_s[j] == rk[:, None]) & (rk[:, None] != _NO_KEY) & (dis2 < thr2[qd])
        r_all = rows[:, None].expand_as(m)[m][: p.pairs_per_candidate]
        pair_q.append(qd[m][: p.pairs_per_candidate])
        pair_row.append(r_all)
    return pair_q, pair_row
