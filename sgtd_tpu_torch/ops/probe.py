"""B1 ``frame_votes`` and B6 ``frame_votes_wide``: the per-frame vote tally;
B8 ``gather_rows``: a row gather (port of sgtd_tpu.ops.pallas_probe; kernels
in ``csrc/probe.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from sgtd_tpu_torch.ops import _build

# Widest frame axis of B1 (kMaxFPad of csrc/probe.cu); B6 takes any.
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
    [0, f_pad) are dropped. On the card one launch writes every count: the
    output needs no zeroing and no conversion."""
    if hit.device.type == "cpu":
        return frame_votes_plain(hit, frame, f_pad)
    if not 0 < f_pad <= MAX_F_PAD:
        raise ValueError(f"frame_votes: f_pad {f_pad} outside (0, {MAX_F_PAD}]")
    hit, frame = _checked("frame_votes", hit, frame)
    b, l = hit.shape
    counts = hit.new_empty((b, f_pad), dtype=torch.float32)
    _build.launch("sgtd_frame_votes", hit.device, hit.data_ptr(), frame.data_ptr(), counts.data_ptr(), b, l, f_pad)
    return counts


def frame_votes_wide(hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    """:func:`frame_votes` for any f_pad >= 1 (the tally of DBs above 2048
    keyframes). Counts are int32 on the card and exact in float32 while
    each stays below 2^24, which holds for every L < 2^24 slots."""
    if hit.device.type == "cpu":
        return frame_votes_wide_plain(hit, frame, f_pad)
    if f_pad <= 0:
        raise ValueError(f"frame_votes_wide: f_pad {f_pad} must be positive")
    hit, frame = _checked("frame_votes_wide", hit, frame)
    b, l = hit.shape
    counts = frame.new_zeros((b, f_pad))
    _build.launch("sgtd_frame_votes_wide", hit.device, hit.data_ptr(), frame.data_ptr(), counts.data_ptr(), b, l, f_pad)
    return counts.to(torch.float32)


def _checked(name: str, hit: torch.Tensor, frame: torch.Tensor):
    """The (B, L) inputs of a tally kernel, checked and contiguous."""
    _build.check(name, ("hit", hit, 2, torch.bool), ("frame", frame, hit.shape, torch.int32))
    return hit.contiguous(), frame.contiguous()


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
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_plain(table, idx)
    _build.check("gather_rows", ("table", table, 2, torch.int32), ("idx", idx, 1, torch.int32))
    if table.shape[1] < 1:
        raise ValueError("gather_rows: a table of no columns")
    table, idx = table.contiguous(), idx.contiguous()
    l, w = idx.shape[0], table.shape[1]
    out = table.new_empty((l, w))
    table_ptr, out_ptr = table.data_ptr(), out.data_ptr()
    if w == 2 and (table_ptr % 8 or out_ptr % 8):
        raise ValueError("gather_rows: a 2-word table must be 8-byte aligned")
    _build.launch("sgtd_gather_rows", dev, table_ptr, idx.data_ptr(), out_ptr, l, w)
    return out
