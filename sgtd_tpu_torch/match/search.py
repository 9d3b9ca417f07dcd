"""Vote-based candidate frame search (port of sgtd_tpu.match.search).

Batched over a leading query axis B. Per query: 27 bucket probes per
descriptor through the direct-addressed bucket table, the ragged bucket
scan (kernel B2 expands per-probe quantities to scan slots), the rough
side-length filter, the exact per-frame vote tally (kernel B1), top-K
candidates, and per-candidate match-pair lists.

Three paths of the reference are not ported yet and raise
NotImplementedError (ROADMAP, scale leg): the bisection fallback for DBs
beyond the bucket-table budget, candidate-major pair extraction above
``sel_max_scan_slots``, and the frame-id gathers of DBs above 65,536
keyframes (with the wide vote tally above 2048).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sgtd_tpu_torch.config import CapacityConfig, DescriptorConfig, SearchConfig
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.desc.keys import probe_cells
from sgtd_tpu_torch.desc.triangles import Descriptors
from sgtd_tpu_torch.ops import expand, probe
from sgtd_tpu_torch.utils import batch_take

# Truncation bitmask values (CandidateSet.truncated / LocalizationResult).
TRUNC_SCAN = 1  # ragged scan overflowed max_scan_slots: votes may be lost
TRUNC_PAIRS = 2  # hits_per_descriptor exceeded: pair lists strided-subsampled

_SCALE_LEG = "not ported yet (ROADMAP: scale leg)"


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
    sel_row:   (B, D, U) int32 compacted DB row per kept hit.
    sel_frame: (B, D, U) int32 frame of each kept hit (F = empty slot).
    scan_overflow: (B,) bool — probe total exceeded caps.max_scan_slots.
    pair_overflow: (B,) bool — some descriptor's hits were subsampled.
    """

    votes: torch.Tensor
    sel_row: torch.Tensor
    sel_frame: torch.Tensor
    scan_overflow: torch.Tensor
    pair_overflow: torch.Tensor


def _check_narrow_frames(db: DescriptorDB) -> None:
    if db.frame_poses.shape[0] > 65536:
        raise NotImplementedError(
            f"frame-id gathers for DBs above 65536 keyframes {_SCALE_LEG}"
        )


def _frame_of_rows(db: DescriptorDB, rows: torch.Tensor) -> torch.Tensor:
    """Owning keyframe of DB rows, from the high half of packed2 word 1."""
    _check_narrow_frames(db)
    return (db.packed2[rows.long(), 1] >> 16) & 0xFFFF


def _bucket_lookup(
    db: DescriptorDB,
    cells: torch.Tensor,
    code: torch.Tensor,
    probe_ok: torch.Tensor,
):
    """(start, end) row range of each (cell, code) probe bucket, via the
    direct-addressed bucket table. cells (..., 27), code (...)."""
    if not db.has_direct_table:
        raise NotImplementedError(
            f"in-cell bisection for DBs beyond the bucket-table budget {_SCALE_LEG}"
        )
    dc = db.cell_remap[cells.long()]
    dk = db.code_remap[code.clamp(0, db.code_remap.shape[0] - 1).long()]
    ok = probe_ok & (dc >= 0) & (dk >= 0)[..., None]
    idx = torch.where(ok, dc * db.table_stride[0] + dk[..., None], 0)
    # Clamped like the reference's gather: only a table past its slot
    # budget (about to be emptied) can be indexed beyond its end.
    word2 = db.bucket_table[idx.clamp(max=db.bucket_table.shape[0] - 1).long()]
    start = word2[..., 0]
    end = start + torch.where(ok, word2[..., 1], 0)
    return start, end, ok


def probe_and_hits(
    db: DescriptorDB,
    query: Descriptors,
    cfg: DescriptorConfig,
    search: SearchConfig,
    caps: CapacityConfig,
) -> ProbeHits:
    """Stage 1: bucket probes, ragged scan, rough filter, vote tally, and
    the per-descriptor hit compaction for the pair lists."""
    bsz, d_max = query.mask.shape
    if d_max > 1 << 16:
        raise ValueError(
            f"caps.max_descriptors={d_max} exceeds 65536: descriptor ids "
            "must fit 16 bits"
        )
    _check_narrow_frames(db)
    f_pad = db.frame_poses.shape[0]
    if f_pad > probe.MAX_F_PAD:
        raise NotImplementedError(
            f"vote tally over {f_pad} > {probe.MAX_F_PAD} frames (kernel B6) {_SCALE_LEG}"
        )
    dev = query.sides.device
    i32 = torch.int32
    m_rows = db.keys.shape[0]

    cells, code, gate = probe_cells(query.sides, query.labels, cfg)  # (B, D, 27)
    start, end, probe_ok = _bucket_lookup(db, cells, code, gate & query.mask[..., None])

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
    ex = expand.expand_jobs(length, payload, l_max)  # (B, 5, L)
    row = ex[:, 0] + slot
    q_a, q_b, q_c, desc = ex[:, 1], ex[:, 2], ex[:, 3], ex[:, 4]

    row_c = row.clamp(0, m_rows - 1)
    w2 = db.packed2[row_c.long()]  # (B, L, 2)
    lo_w, hi_w = w2[..., 0], w2[..., 1]
    frame_of_hit = (hi_w >> 16) & 0xFFFF
    da = (lo_w & 0xFFFF) - q_a
    db_ = ((lo_w >> 16) & 0xFFFF) - q_b
    dc = (hi_w & 0xFFFF) - q_c
    dis2 = (da * da + db_ * db_ + dc * dc).to(torch.float32)
    qs2 = (q_a * q_a + q_b * q_b + q_c * q_c).to(torch.float32)
    thr2 = qs2 * float(np.float32(search.rough_dis_threshold) ** 2)
    hit = slot_valid & (dis2 < thr2)  # (B, L)

    # --- exact per-frame vote tally. ---
    votes = probe.frame_votes(hit, frame_of_hit, f_pad)
    votes = torch.where(db.frame_valid, votes, 0.0)

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
    """Stage 3: group hits by frame (one int32 value sort of
    frame * DU + flat index) and slice each candidate's pair list."""
    bsz, d_max, u = sel_frame.shape
    du = d_max * u
    if (f_pad + 1) * du >= 2**31:
        raise NotImplementedError(f"argsort pair grouping for wide DBs {_SCALE_LEG}")
    hf = sel_frame.reshape(bsz, du)
    hr = sel_row.reshape(bsz, du)
    flat = torch.arange(du, dtype=torch.int32, device=hf.device)
    s, _ = torch.sort(hf * du + flat, dim=-1)
    hf_s = s // du
    idx_s = s - hf_s * du
    hq_s = idx_s // u
    hr_s = torch.gather(hr, 1, idx_s.long())

    p = pairs_per_candidate
    lo = torch.searchsorted(hf_s, cand_frames.contiguous(), out_int32=True)  # (B, C)
    pair_pos = lo[..., None] + torch.arange(p, dtype=torch.int32, device=hf.device)
    pair_pos_c = pair_pos.clamp(max=du - 1).long()
    take = lambda x: torch.gather(x, 1, pair_pos_c.reshape(bsz, -1)).reshape(pair_pos.shape)
    pair_valid = (
        (pair_pos < du) & (take(hf_s) == cand_frames[..., None]) & cand_valid[..., None]
    )
    return take(hq_s), take(hr_s), pair_valid


def candidate_search(
    db: DescriptorDB,
    query: Descriptors,
    cfg: DescriptorConfig = DescriptorConfig(),
    search: SearchConfig = SearchConfig(),
    caps: CapacityConfig = CapacityConfig(),
) -> CandidateSet:
    """Stages 1-3 for a batch of queries."""
    if caps.max_scan_slots > caps.sel_max_scan_slots:
        raise NotImplementedError(
            f"candidate-major pair extraction above sel_max_scan_slots {_SCALE_LEG}"
        )
    ph = probe_and_hits(db, query, cfg, search, caps)
    cand_votes, cand_frames, cand_valid = select_candidates(ph.votes, search)
    pair_qidx, pair_row, pair_valid = extract_pairs(
        ph.sel_row, ph.sel_frame, cand_frames, cand_valid,
        caps.pairs_per_candidate, db.frame_poses.shape[0],
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


def fit_scan_slots(observed_max: int, config, margin: float = 1.5):
    """``config`` with caps.max_scan_slots fitted to an observed max probe
    total: ``margin`` x the max, rounded up to 8192 slots, never above the
    incoming cap."""
    fitted = max(8192, -(-int(observed_max * margin) // 8192) * 8192)
    caps = dataclasses.replace(
        config.caps, max_scan_slots=min(fitted, config.caps.max_scan_slots)
    )
    return config.replace(caps=caps)
