"""B1 ``frame_votes``: the per-frame vote tally (port of
sgtd_tpu.ops.pallas_probe.frame_votes; kernel in ``csrc/probe.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from sgtd_tpu_torch.ops import _build

# Kernel launches since the last reset (the main-path check reads it).
LAUNCHES = 0

MAX_F_PAD = 2048


def frame_votes_plain(hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    """Plain version: scatter-add of the hits at their in-range frame ids."""
    keep = hit & (frame >= 0) & (frame < f_pad)
    idx = torch.where(keep, frame, 0).long()
    out = torch.zeros(hit.shape[:-1] + (f_pad,), dtype=torch.float32, device=hit.device)
    return out.scatter_add_(-1, idx, keep.to(torch.float32))


def frame_votes(hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    """Sum of ``hit`` per ``frame`` id: (B, L) bool, (B, L) int32 -> (B, f_pad)
    float32 holding exact integer counts. Ids outside [0, f_pad) are dropped."""
    if hit.device.type == "cpu":
        return frame_votes_plain(hit, frame, f_pad)
    return _frame_votes_cuda(hit, frame, f_pad)


def _frame_votes_cuda(hit: torch.Tensor, frame: torch.Tensor, f_pad: int) -> torch.Tensor:
    global LAUNCHES
    if hit.device.type != "cuda" or frame.device != hit.device:
        raise ValueError(f"frame_votes: CUDA tensors required, got {hit.device}/{frame.device}")
    if hit.dtype != torch.bool or frame.dtype != torch.int32:
        raise TypeError(f"frame_votes: bool hit and int32 frame, got {hit.dtype}/{frame.dtype}")
    if hit.dim() != 2 or frame.shape != hit.shape:
        raise ValueError(f"frame_votes: (B, L) inputs, got {tuple(hit.shape)}/{tuple(frame.shape)}")
    if not 0 < f_pad <= MAX_F_PAD:
        raise ValueError(f"frame_votes: f_pad {f_pad} outside (0, {MAX_F_PAD}]")
    hit, frame = hit.contiguous(), frame.contiguous()
    b, l = hit.shape
    counts = torch.zeros((b, f_pad), dtype=torch.int32, device=hit.device)
    lib = _build.library()
    rc = lib.sgtd_frame_votes(
        hit.data_ptr(), frame.data_ptr(), counts.data_ptr(), b, l, f_pad,
        torch.cuda.current_stream(hit.device).cuda_stream,
    )
    _build.check(rc, "sgtd_frame_votes")
    LAUNCHES += 1
    return counts.to(torch.float32)
