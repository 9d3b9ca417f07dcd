"""Vote-based candidate frame search (port of sgtd_tpu.match.search).

Batched over a leading query axis B. Per query: 27 bucket probes per
descriptor through the direct-addressed bucket table (or, for DBs past
the table budget, an in-cell bisection over the sorted codes), the ragged
bucket scan (kernel B2 expands per-probe quantities to scan slots), the
rough side-length filter, the exact per-frame vote tally (kernel B1 up to
2048 keyframes, B6 above), top-K candidates, and per-candidate
match-pair lists: compacted per descriptor during the scan (the sel path)
or, above ``sel_max_scan_slots``, built candidate-major from the
frame-major row index. DBs above 65,536 keyframes read frame ids from
``frame_ids`` instead of packed2.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sgtd_tpu_torch.config import CapacityConfig, DescriptorConfig, SearchConfig
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.desc.keys import _N_CODES, probe_cells
from sgtd_tpu_torch.desc.triangles import Descriptors
from sgtd_tpu_torch.ops import expand, probe
from sgtd_tpu_torch.utils import batch_take, profiling

# Truncation bitmask values (CandidateSet.truncated / LocalizationResult).
TRUNC_SCAN = 1  # ragged scan overflowed max_scan_slots: votes may be lost
TRUNC_PAIRS = 2  # hits_per_descriptor exceeded: pair lists strided-subsampled

_I32_MAX = 2**31 - 1
# Frame ids above this do not fit packed2's 16 high bits.
_MAX_PACKED_FRAMES = 65536


class CandidateSet(NamedTuple):
    """Top-K candidate frames and their match-pair lists (leading axis B).

    frames:     (B, C) int32 — candidate keyframe ids (vote-descending).
    votes:      (B, C) float32.
    valid:      (B, C) bool — vote >= min_votes.
    pair_qidx:  (B, C, P) int32 — query-descriptor index of each pair.
    pair_row:   (B, C, P) int32 — DB row of each pair.
    pair_valid: (B, C, P) bool.
    truncated:  (B,) int32 bitmask of TRUNC_SCAN | TRUNC_PAIRS.
    """

    frames: torch.Tensor
    votes: torch.Tensor
    valid: torch.Tensor
    pair_qidx: torch.Tensor
    pair_row: torch.Tensor
    pair_valid: torch.Tensor
    truncated: torch.Tensor


class ProbeHits(NamedTuple):
    """Stage-1 output of :func:`probe_and_hits` (leading axis B).

    votes:     (B, F) float32 per-frame vote tally.
    sel_row:   (B, D, U) int32 compacted DB row per kept hit; None with
               ``with_sel=False`` (candidate-major pair extraction).
    sel_frame: (B, D, U) int32 frame of each kept hit (F = empty slot);
               None with ``with_sel=False``.
    scan_overflow: (B,) bool — probe total exceeded caps.max_scan_slots.
    pair_overflow: (B,) bool — some descriptor's hits were subsampled.
    """

    votes: torch.Tensor
    sel_row: torch.Tensor
    sel_frame: torch.Tensor
    scan_overflow: torch.Tensor
    pair_overflow: torch.Tensor


def _frame_of_rows(db: DescriptorDB, rows: torch.Tensor) -> torch.Tensor:
    """Owning keyframe of DB rows: the high half of packed2 word 1, or
    ``frame_ids`` for DBs above 65,536 keyframes (the choice follows the
    frame axis' shape)."""
    if db.frame_poses.shape[0] > _MAX_PACKED_FRAMES:
        return db.frame_ids[rows.long()]
    return (db.packed2[rows.long(), 1] >> 16) & 0xFFFF


def _bisect(key_at, targets: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, steps: int):
    """Lower bound of ``targets`` within [lo, hi) of a sorted array read
    through ``key_at(positions)``; ``steps`` halvings."""
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = key_at(mid) < targets
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _bucket_lookup(
    db: DescriptorDB,
    cells: torch.Tensor,
    code: torch.Tensor,
    probe_ok: torch.Tensor,
    row_offset: torch.Tensor | int | None = None,
):
    """(start, end) row range of each (cell, code) probe bucket. cells
    (..., 27), code (...).

    Through the direct-addressed bucket table when the DB has one; else
    an in-cell bisection over the sorted codes of [cell_start[c],
    cell_start[c + 1]) for code and code + 1, ceil(log2(M)) steps, which
    covers any cell.

    With ``row_offset`` the DB's row fields are one contiguous shard of a
    larger table whose first row is global row ``row_offset``: the global
    ranges (bucket table, cell_start) are clipped into the shard's local
    rows, so a bucket split across shards is scanned partly on each side.
    """
    m_rows = db.keys.shape[0]
    if not db.has_direct_table:
        cs = db.cell_start[cells.long()]
        ce = db.cell_start[cells.long() + 1]
        if row_offset is not None:
            # The codes bisected below are this shard's rows; a cell split
            # across shards stays code-sorted within each side.
            cs = (cs - row_offset).clamp(0, m_rows)
            ce = (ce - row_offset).clamp(0, m_rows)
        target = torch.stack([code, code + 1])[..., None]  # (2, ..., 1)
        lo = cs.expand((2,) + cs.shape)
        hi = ce.expand((2,) + ce.shape)
        steps = max(int(np.ceil(np.log2(max(m_rows, 2)))), 1)
        key_at = lambda i: db.codes[i.clamp(max=m_rows - 1).long()]
        lo = _bisect(key_at, target, lo, hi, steps)
        return lo[0], lo[1], probe_ok
    dc = db.cell_remap[cells.long()]
    dk = db.code_remap[code.clamp(0, db.code_remap.shape[0] - 1).long()]
    ok = probe_ok & (dc >= 0) & (dk >= 0)[..., None]
    idx = torch.where(ok, dc * db.table_stride[0] + dk[..., None], 0)
    # Clamped like the reference's gather: only a table past its slot
    # budget (about to be emptied) can be indexed beyond its end.
    word2 = db.bucket_table[idx.clamp(max=db.bucket_table.shape[0] - 1).long()]
    start = word2[..., 0]
    end = start + torch.where(ok, word2[..., 1], 0)
    if row_offset is not None:
        start = (start - row_offset).clamp(0, m_rows)
        end = (end - row_offset).clamp(0, m_rows)
    return start, end, ok


def probe_and_hits(
    db: DescriptorDB,
    query: Descriptors,
    cfg: DescriptorConfig,
    search: SearchConfig,
    caps: CapacityConfig,
    row_offset: torch.Tensor | int | None = None,
    with_sel: bool = True,
) -> ProbeHits:
    """Stage 1: bucket probes, ragged scan, rough filter, vote tally, and
    (with ``with_sel``) the per-descriptor hit compaction for the pair
    lists.

    ``row_offset``: where ``db``'s row fields are a contiguous shard of a
    larger table, the global row of the shard's first row; the votes are
    then the shard's part of the whole table's and ``sel_row`` holds local
    rows."""
    bsz, d_max = query.mask.shape
    if d_max > 1 << 16:
        raise ValueError(
            f"caps.max_descriptors={d_max} exceeds 65536: descriptor ids "
            "must fit 16 bits"
        )
    f_pad = db.frame_poses.shape[0]
    dev = query.sides.device
    i32 = torch.int32
    m_rows = db.keys.shape[0]

    cells, code, gate = probe_cells(query.sides, query.labels, cfg)  # (B, D, 27)
    start, end, probe_ok = _bucket_lookup(db, cells, code, gate & query.mask[..., None], row_offset)

    # --- ragged (CSR-style) bucket scan over the exact bucket lengths. ---
    n_jobs = d_max * 27
    length = torch.where(probe_ok, end - start, 0).reshape(bsz, n_jobs)
    offsets = expand.job_offsets(length)  # (B, NJ + 1)
    total = offsets[:, -1]
    l_max = caps.max_scan_slots
    slot = torch.arange(l_max, dtype=i32, device=dev)
    slot_valid = slot < total[:, None]  # (B, L)
    heads = offsets[:, :-1]
    job_desc = torch.arange(n_jobs, dtype=i32, device=dev) // 27

    # Query sides in the DB's 1/256 fixed-point grid, expanded per slot
    # with the row base (start - head, any sign) and the descriptor id.
    qq = torch.round(query.sides * 256.0).clamp(0, 32767).to(i32)  # (B, D, 3)
    qq_j = qq[:, job_desc.long()]  # (B, NJ, 3)
    payload = torch.cat(
        [
            (start.reshape(bsz, n_jobs) - heads)[..., None],
            qq_j,
            job_desc.expand(bsz, n_jobs)[..., None],
        ],
        dim=-1,
    )
    ex = expand.expand_jobs(length, payload, l_max, offsets=offsets)  # (B, 5, L)
    row = ex[:, 0] + slot
    q_a, q_b, q_c, desc = ex[:, 1], ex[:, 2], ex[:, 3], ex[:, 4]

    row_c = row.clamp(0, m_rows - 1)
    w2 = db.packed2[row_c.long()]  # (B, L, 2)
    lo_w, hi_w = w2[..., 0], w2[..., 1]
    if f_pad > _MAX_PACKED_FRAMES:
        frame_of_hit = db.frame_ids[row_c.long()]
    else:
        frame_of_hit = (hi_w >> 16) & 0xFFFF
    da = (lo_w & 0xFFFF) - q_a
    db_ = ((lo_w >> 16) & 0xFFFF) - q_b
    dc = (hi_w & 0xFFFF) - q_c
    dis2 = (da * da + db_ * db_ + dc * dc).to(torch.float32)
    qs2 = (q_a * q_a + q_b * q_b + q_c * q_c).to(torch.float32)
    thr2 = qs2 * float(np.float32(search.rough_dis_threshold) ** 2)
    hit = slot_valid & (dis2 < thr2)  # (B, L)

    # --- exact per-frame vote tally. ---
    if f_pad <= probe.MAX_F_PAD:
        votes = probe.frame_votes(hit, frame_of_hit, f_pad)
    else:
        votes = probe.frame_votes_wide(hit, frame_of_hit, f_pad)
    votes = torch.where(db.frame_valid, votes, 0.0)
    if not with_sel:
        return ProbeHits(
            votes=votes,
            sel_row=None,
            sel_frame=None,
            scan_overflow=total > l_max,
            pair_overflow=torch.zeros(bsz, dtype=torch.bool, device=dev),
        )

    # --- compact hits per query descriptor for pair extraction. ---
    # Ranks within each descriptor from a segment-relative cumsum; more
    # than u hits are STRIDED-subsampled (the reference's skip_len).
    u = caps.hits_per_descriptor
    hcum = torch.cumsum(hit.to(i32), -1, dtype=i32)
    hcum_ext = torch.cat([torch.zeros_like(hcum[:, :1]), hcum], dim=-1)  # (B, L + 1)
    desc_slot = offsets[:, ::27]  # (B, D + 1): first slot of each descriptor
    hits_before = torch.gather(hcum_ext, 1, desc_slot.clamp(0, l_max).long())
    n_hits_d = hits_before[:, 1:] - hits_before[:, :-1]  # (B, D)
    desc_c = desc.clamp(0, d_max - 1).long()
    rank_in_desc = hcum - 1 - torch.gather(hits_before, 1, desc_c)
    stride_d = (n_hits_d - 1) // u + 1  # ceil(n/u): rank // stride < u
    stride = torch.gather(stride_d, 1, desc_c).clamp(min=1)
    keep = hit & (rank_in_desc % stride == 0)
    pair_overflow = (hit & (stride > 1)).any(-1)
    # One masked scatter: row + 1 at (query, descriptor, rank // stride).
    sel = torch.zeros((bsz, d_max * u), dtype=i32, device=dev)
    b_idx = torch.arange(bsz, device=dev)[:, None].expand_as(keep)
    dst = desc * u + rank_in_desc // stride
    sel[b_idx[keep], dst[keep].long()] = row_c[keep] + 1
    sel = sel.reshape(bsz, d_max, u)
    sel_ok = sel > 0
    sel_row = (sel - 1).clamp(min=0)
    sel_frame = torch.where(sel_ok, _frame_of_rows(db, sel_row), f_pad)
    return ProbeHits(
        votes=votes,
        sel_row=sel_row,
        sel_frame=sel_frame,
        scan_overflow=total > l_max,
        pair_overflow=pair_overflow,
    )


def select_candidates(
    votes: torch.Tensor, search: SearchConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 2: top-K candidate frames, ties to the lower frame id."""
    k_cand = min(search.candidate_num, votes.shape[-1])
    cand_votes, cand_frames = torch.sort(votes, dim=-1, descending=True, stable=True)
    cand_votes = cand_votes[..., :k_cand]
    cand_frames = cand_frames[..., :k_cand].to(torch.int32)
    cand_valid = cand_votes >= float(np.float32(search.min_votes))
    return cand_votes, cand_frames, cand_valid


def extract_pairs(
    sel_row: torch.Tensor,
    sel_frame: torch.Tensor,
    cand_frames: torch.Tensor,
    cand_valid: torch.Tensor,
    pairs_per_candidate: int,
    f_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 3: group hits by frame and slice each candidate's pair list.

    The grouping is one int32 value sort of frame * DU + flat index while
    (f_pad + 1) * DU < 2^31; wider DBs take a stable argsort of the frame
    ids, which orders the hits the same way.
    """
    bsz, d_max, u = sel_frame.shape
    du = d_max * u
    dev = sel_frame.device
    hf = sel_frame.reshape(bsz, du)
    hr = sel_row.reshape(bsz, du)
    if (f_pad + 1) * du < 2**31:
        flat = torch.arange(du, dtype=torch.int32, device=dev)
        s, _ = torch.sort(hf * du + flat, dim=-1)
        hf_s = s // du
        idx_s = s - hf_s * du
        hq_s = idx_s // u
        hr_s = torch.gather(hr, 1, idx_s.long())
    else:
        hf_s, order = torch.sort(hf, dim=-1, stable=True)
        hq_s = (order // u).to(torch.int32)
        hr_s = torch.gather(hr, 1, order)

    p = pairs_per_candidate
    lo = torch.searchsorted(hf_s, cand_frames.contiguous(), out_int32=True)  # (B, C)
    pair_pos = lo[..., None] + torch.arange(p, dtype=torch.int32, device=dev)
    pair_pos_c = pair_pos.clamp(max=du - 1).long()
    take = lambda x: torch.gather(x, 1, pair_pos_c.reshape(bsz, -1)).reshape(pair_pos.shape)
    pair_valid = (
        (pair_pos < du) & (take(hf_s) == cand_frames[..., None]) & cand_valid[..., None]
    )
    return take(hq_s), take(hr_s), pair_valid


def probe_ranges(
    db: DescriptorDB,
    query: Descriptors,
    cfg: DescriptorConfig,
    row_offset: torch.Tensor | int | None = None,
):
    """(start, end) row range of each (descriptor, probe) bucket and the
    probe validity mask, each (B, D, 27); shard-local with ``row_offset``
    (see :func:`_bucket_lookup`)."""
    cells, code, gate = probe_cells(query.sides, query.labels, cfg)
    return _bucket_lookup(db, cells, code, gate & query.mask[..., None], row_offset)


def scan_totals(db: DescriptorDB, query: Descriptors, cfg: DescriptorConfig) -> torch.Tensor:
    """Each query's ragged-scan total, (B,) int32: the rows of its live
    probe buckets."""
    s, e, ok = probe_ranges(db, query, cfg)
    return torch.where(ok, e - s, 0).sum(dim=(-2, -1), dtype=torch.int32)


def build_probe_table(
    query: Descriptors, cfg: DescriptorConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's probe keys (cell * 2197 + code; int32 max where the
    probe is off), stably sorted, and the descriptor of each: (B, D * 27)
    twice."""
    cells, code, gate = probe_cells(query.sides, query.labels, cfg)  # (B, D, 27)
    bsz, d_max = code.shape
    ok = gate & query.mask[..., None]
    pkey = torch.where(ok, cells * _N_CODES + code[..., None], _I32_MAX).reshape(bsz, -1)
    pdesc = torch.arange(d_max, dtype=torch.int32, device=code.device).repeat_interleave(27)
    pkey_s, order = torch.sort(pkey, dim=-1, stable=True)
    return pkey_s, pdesc[order]


def extract_pairs_by_frame(
    db: DescriptorDB,
    query: Descriptors,
    pkeys: torch.Tensor,
    pdesc: torch.Tensor,
    cand_frames: torch.Tensor,
    cand_valid: torch.Tensor,
    search: SearchConfig,
    caps: CapacityConfig,
    row_offset: torch.Tensor | int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate-major pair pass: every (query descriptor, DB row) match of
    each candidate frame, in (row, probe) order, capped at
    caps.pairs_per_candidate per candidate.

    Each candidate's rows are contiguous in the frame-major index
    (frame_rows / frame_start, at most caps.max_descriptors of them); each
    row's key is bisected into the query's sorted probe table and the
    caps.probes_per_key probes from there are tested for key equality and
    the rough side filter. Outputs (B, C, pairs_per_candidate): qidx,
    row, valid. With ``row_offset`` (``db``'s rows a shard of a larger
    table, its first row global row ``row_offset``) only the shard's rows
    contribute, and ``row`` is shard-local.
    """
    p_cap = caps.pairs_per_candidate
    bsz, c_n = cand_frames.shape
    m_rows = db.keys.shape[0]
    n_probes = pkeys.shape[-1]
    dev = cand_frames.device

    cf = cand_frames.long()
    fs, fe = db.frame_start[cf], db.frame_start[cf + 1]  # (B, C)
    pos = fs[..., None] + torch.arange(caps.max_descriptors, dtype=torch.int32, device=dev)
    row_ok = (pos < fe[..., None]) & cand_valid[..., None]  # (B, C, R)
    rows = db.frame_rows[pos.clamp(0, db.frame_rows.shape[0] - 1).long()]
    if row_offset is not None:
        rows = rows - row_offset
        row_ok = row_ok & (rows >= 0) & (rows < m_rows)
        rows = rows.clamp(0, m_rows - 1)
    rows = rows.clamp(max=m_rows - 1)
    rowkey = db.keys[rows.long()]
    w2 = db.packed2[rows.long()]
    inv256 = 1.0 / 256.0  # exact in float32
    sa = (w2[..., 0] & 0xFFFF).to(torch.float32) * inv256
    sb = ((w2[..., 0] >> 16) & 0xFFFF).to(torch.float32) * inv256
    sc = (w2[..., 1] & 0xFFFF).to(torch.float32) * inv256

    # First probe with key >= rowkey.
    steps = max(int(np.ceil(np.log2(max(n_probes, 2)))) + 1, 1)
    key_at = lambda i: batch_take(pkeys, i.clamp(max=n_probes - 1))
    p_lo = _bisect(key_at, rowkey, torch.zeros_like(rowkey), torch.full_like(rowkey, n_probes), steps)

    sq = query.sides * query.sides
    thr2 = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) * float(
        np.float32(search.rough_dis_threshold) ** 2
    )  # (B, D)
    matches, descs = [], []
    for j in range(caps.probes_per_key):
        p = (p_lo + j).clamp(max=n_probes - 1)
        key_eq = (batch_take(pkeys, p) == rowkey) & (rowkey != _I32_MAX)
        qd = batch_take(pdesc, p)  # (B, C, R)
        qs = batch_take(query.sides, qd)  # (B, C, R, 3)
        da, db_, dc = sa - qs[..., 0], sb - qs[..., 1], sc - qs[..., 2]
        dis2 = (da * da + db_ * db_) + dc * dc
        matches.append(key_eq & row_ok & (dis2 < batch_take(thr2, qd)))
        descs.append(qd)
    match = torch.stack(matches, -1).reshape(bsz, c_n, -1)  # (B, C, R * K)
    qdesc = torch.stack(descs, -1).reshape(bsz, c_n, -1)
    rows_k = rows[..., None].expand(-1, -1, -1, caps.probes_per_key).reshape(bsz, c_n, -1)

    # Compact per candidate: the first p_cap matches in (row, probe) order.
    rank = torch.cumsum(match.to(torch.int32), -1, dtype=torch.int32) - 1
    keep = match & (rank < p_cap)
    b_i, c_i, _ = keep.nonzero(as_tuple=True)
    packed = torch.zeros((bsz, c_n, p_cap, 3), dtype=torch.int32, device=dev)
    packed[b_i, c_i, rank[keep].long()] = torch.stack(
        [qdesc[keep], rows_k[keep], torch.ones_like(qdesc[keep])], -1
    )
    return packed[..., 0], packed[..., 1], packed[..., 2] > 0


@profiling.traced("match.search")
def candidate_search(
    db: DescriptorDB,
    query: Descriptors,
    cfg: DescriptorConfig = DescriptorConfig(),
    search: SearchConfig = SearchConfig(),
    caps: CapacityConfig = CapacityConfig(),
) -> CandidateSet:
    """Stages 1-3 for a batch of queries.

    Up to caps.sel_max_scan_slots scan slots the pair lists come from the
    per-descriptor compaction of the scan (extract_pairs); above it the
    L-sized compaction is skipped and they are built candidate-major
    (extract_pairs_by_frame), whose cost does not grow with L.
    """
    use_sel = caps.max_scan_slots <= caps.sel_max_scan_slots
    with profiling.span("search.probe"):
        ph = probe_and_hits(db, query, cfg, search, caps, with_sel=use_sel)
    with profiling.span("search.select"):
        cand_votes, cand_frames, cand_valid = select_candidates(ph.votes, search)
    with profiling.span("search.pairs"):
        if use_sel:
            pair_qidx, pair_row, pair_valid = extract_pairs(
                ph.sel_row, ph.sel_frame, cand_frames, cand_valid,
                caps.pairs_per_candidate, db.frame_poses.shape[0],
            )
        else:
            pkeys, pdesc = build_probe_table(query, cfg)
            pair_qidx, pair_row, pair_valid = extract_pairs_by_frame(
                db, query, pkeys, pdesc, cand_frames, cand_valid, search, caps
            )
    truncated = (
        ph.scan_overflow.to(torch.int32) * TRUNC_SCAN
        + ph.pair_overflow.to(torch.int32) * TRUNC_PAIRS
    )
    return CandidateSet(
        frames=cand_frames,
        votes=cand_votes,
        valid=cand_valid,
        pair_qidx=pair_qidx,
        pair_row=pair_row,
        pair_valid=pair_valid,
        truncated=truncated,
    )


@profiling.traced("index.calibrate")
def calibrate_scan_slots(db: DescriptorDB, sample_queries: Descriptors, config, margin: float = 1.5):
    """``config`` with caps.max_scan_slots fitted (:func:`fit_scan_slots`)
    to the largest probe-scan total of a batch of sample queries."""
    return fit_scan_slots(int(scan_totals(db, sample_queries, config.desc).max()), config, margin)


def fit_scan_slots(observed_max: int, config, margin: float = 1.5):
    """``config`` with caps.max_scan_slots fitted to an observed max probe
    total: ``margin`` x the max, rounded up to 8192 slots, never above the
    incoming cap."""
    fitted = max(8192, -(-int(observed_max * margin) // 8192) * 8192)
    caps = dataclasses.replace(
        config.caps, max_scan_slots=min(fitted, config.caps.max_scan_slots)
    )
    return config.replace(caps=caps)
