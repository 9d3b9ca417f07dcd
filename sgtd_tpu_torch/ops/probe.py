"""B1 ``frame_votes`` and B6 ``frame_votes_wide``: the per-frame vote tally;
B8 ``gather_rows``: a row gather (port of sgtd_tpu.ops.pallas_probe; kernels
in ``csrc/probe.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from sgtd_tpu_torch.ops import _build

# Kernel launches since the last reset (the main-path check reads them).
LAUNCHES = 0
WIDE_LAUNCHES = 0
GATHER_LAUNCHES = 0

# Widest frame axis of B1; B6 takes any.
MAX_F_PAD = 2048


def frame_votes_plain(hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    """Plain version: scatter-add of the hits at their in-range frame ids."""
    keep = hit & (frame >= 0) & (frame < f_pad)
    idx = torch.where(keep, frame, 0).long()
    out = torch.zeros(hit.shape[:-1] + (f_pad,), dtype=torch.float32, device=hit.device)
    return out.scatter_add_(-1, idx, keep.to(torch.float32))


def frame_votes_wide_plain(hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    """Plain version of B6: the same scatter-add, for any f_pad."""
    return frame_votes_plain(hit, frame, f_pad)


def frame_votes(hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    """Sum of ``hit`` per ``frame`` id: (B, L) bool, (B, L) int32 -> (B, f_pad)
    float32 holding exact integer counts, f_pad <= 2048. Ids outside
    [0, f_pad) are dropped."""
    global LAUNCHES
    if hit.device.type == "cpu":
        return frame_votes_plain(hit, frame, f_pad)
    if not 0 < f_pad <= MAX_F_PAD:
        raise ValueError(f"frame_votes: f_pad {f_pad} outside (0, {MAX_F_PAD}]")
    counts = _launch("sgtd_frame_votes", hit, frame, f_pad)
    LAUNCHES += 1
    return counts


def frame_votes_wide(hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    """:func:`frame_votes` for any f_pad >= 1 (the tally of DBs above 2048
    keyframes). Counts are int32 on the card and exact in float32 while
    each stays below 2^24, which holds for every L < 2^24 slots."""
    global WIDE_LAUNCHES
    if hit.device.type == "cpu":
        return frame_votes_wide_plain(hit, frame, f_pad)
    if f_pad <= 0:
        raise ValueError(f"frame_votes_wide: f_pad {f_pad} must be positive")
    counts = _launch("sgtd_frame_votes_wide", hit, frame, f_pad)
    WIDE_LAUNCHES += 1
    return counts


def _launch(entry: str, hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    if hit.device.type != "cuda" or frame.device != hit.device:
        raise ValueError(f"{entry}: CUDA tensors required, got {hit.device}/{frame.device}")
    if hit.dtype != torch.bool or frame.dtype != torch.int32:
        raise TypeError(f"{entry}: bool hit and int32 frame, got {hit.dtype}/{frame.dtype}")
    if hit.dim() != 2 or frame.shape != hit.shape:
        raise ValueError(f"{entry}: (B, L) inputs, got {tuple(hit.shape)}/{tuple(frame.shape)}")
    hit, frame = hit.contiguous(), frame.contiguous()
    b, l = hit.shape
    counts = torch.zeros((b, f_pad), dtype=torch.int32, device=hit.device)
    rc = getattr(_build.library(), entry)(
        hit.data_ptr(), frame.data_ptr(), counts.data_ptr(), b, l, f_pad,
        torch.cuda.current_stream(hit.device).cuda_stream,
    )
    _build.check(rc, entry)
    return counts.to(torch.float32)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of B8: advanced indexing."""
    return table[idx.long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = table[idx[i], :]``: table (M, W) int32 (for the DB's
    ``packed2``, the bit patterns of the reference's uint32 words), idx
    (L,) int32 -> (L, W) int32. Indices must lie in [0, M): the kernel does
    not check them, as the reference's does not. No module of the port
    calls it (none of the reference calls its TPU counterpart, a lowering
    experiment for the probe stage's row gathers)."""
    global GATHER_LAUNCHES
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"gather_rows: CUDA tensors required, got {table.device}/{idx.device}")
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: int32 table and idx, got {table.dtype}/{idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1 or table.shape[1] < 1:
        raise ValueError(f"gather_rows: (M, W) table and (L,) idx, got {tuple(table.shape)}/{tuple(idx.shape)}")
    table, idx = table.contiguous(), idx.contiguous()
    l, w = idx.shape[0], table.shape[1]
    out = torch.empty((l, w), dtype=torch.int32, device=table.device)
    if w == 2 and (table.data_ptr() % 8 or out.data_ptr() % 8):
        raise ValueError("gather_rows: a 2-word table must be 8-byte aligned")
    rc = _build.library().sgtd_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), l, w,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(rc, "sgtd_gather_rows")
    GATHER_LAUNCHES += 1
    return out
