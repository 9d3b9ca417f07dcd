"""B2 ``expand_jobs``: the ragged expansion from jobs to scan slots (port of
sgtd_tpu.ops.pallas_expand.expand_jobs and of the XLA
``match.search._expand`` path; kernel in ``csrc/expand.cu``).

``out[b, c, slot] = payload[b, job(slot), c]`` over contiguous job
segments of lengths ``length``, truncated at ``l_max``; slots past the
total are don't-care (the kernel gives them the payload of one of the last jobs). A
CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version. There is no fallback between the two.
"""

from __future__ import annotations

from typing import Optional

import torch

from sgtd_tpu_torch.ops import _build


def job_offsets(length: torch.Tensor) -> torch.Tensor:
    """(B, NJ) lengths -> (B, NJ + 1) int32 exclusive prefix sums."""
    zero = torch.zeros(length.shape[:-1] + (1,), dtype=torch.int32, device=length.device)
    return torch.cat([zero, torch.cumsum(length, -1, dtype=torch.int32)], dim=-1)


def expand_jobs_plain(
    length: torch.Tensor, payload: torch.Tensor, l_max: int, offsets: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version: the reference's delta scatter at the segment heads,
    then one int32 cumsum per channel. Heads at or past ``l_max`` drop;
    the telescoping sum gives each slot its job's value even where empty
    jobs share a head, and int32 wrap-around cancels in it. ``offsets``
    as :func:`expand_jobs` takes them."""
    heads = (job_offsets(length) if offsets is None else offsets)[..., :-1]  # (B, NJ)
    delta = torch.cat([payload[:, :1], payload[:, 1:] - payload[:, :-1]], dim=1)
    keep = heads < l_max
    b = payload.shape[0]
    buf = torch.zeros((b, l_max, payload.shape[2]), dtype=torch.int32, device=payload.device)
    rows = torch.arange(b, device=payload.device)[:, None].expand_as(heads)
    buf.index_put_((rows[keep], heads[keep].long()), delta[keep], accumulate=True)
    return torch.cumsum(buf, dim=1, dtype=torch.int32).transpose(1, 2).contiguous()


def expand_jobs(
    length: torch.Tensor, payload: torch.Tensor, l_max: int, offsets: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """length (B, NJ) int32, payload (B, NJ, C) int32 -> (B, C, l_max) int32.
    ``offsets``: ``job_offsets(length)`` where the caller has it already."""
    if length.device.type == "cpu":
        return expand_jobs_plain(length, payload, l_max, offsets)
    return _expand_jobs_cuda(length, payload, l_max, offsets)


def _expand_jobs_cuda(length, payload, l_max, offsets) -> torch.Tensor:
    _build.check("expand_jobs", ("length", length, 2, torch.int32),
                 ("payload", payload, length.shape + payload.shape[-1:], torch.int32))
    if l_max <= 0:
        raise ValueError(f"expand_jobs: l_max {l_max} must be positive")
    b, nj, c = payload.shape
    if offsets is None:
        offsets = job_offsets(length)
    elif offsets.shape != (b, nj + 1) or offsets.dtype != torch.int32 or offsets.device != length.device:
        raise ValueError(f"expand_jobs: offsets must be (B, NJ + 1) int32 beside length, got "
                         f"{tuple(offsets.shape)} {offsets.dtype} on {offsets.device}")
    offsets, payload = offsets.contiguous(), payload.contiguous()
    out = payload.new_empty((b, c, l_max))
    _build.launch("sgtd_expand_jobs", length.device, offsets.data_ptr(), payload.data_ptr(),
                  out.data_ptr(), b, nj, c, l_max)
    return out
