"""Small tensor helpers shared by the batched stages."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def host_array(x) -> np.ndarray:
    """A NumPy array of ``x``: a tensor on any device, copied to the host,
    or anything ``np.asarray`` takes."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def batch_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ...] = x[b, idx[b, ...]]``: per-batch gather on axis 1.

    x (B, N, *rest); idx (B, *shape) integer -> (B, *shape, *rest).
    """
    b = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (idx.dim() - 1)
    )
    return x[b, idx.long()]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    torch's vectorized CPU ``sqrt`` can land one ulp off the correctly
    rounded float32 result that XLA and NumPy give (e.g. sqrt(529.1663)).
    A float64 root rounded to float32 is exact, and one ulp decides gates
    such as ``trunc(side * 1000)`` in the descriptor dedup.
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    The Kabsch cross-covariances, the verification transforms and the pose
    products are f32 in the reference; TF32 keeps about three decimal
    digits and would move poses and inlier tests.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add ``a * b + c``, emulated in float64: the
    product of two float32 values is exact there, and the sum rounds to
    float64 and then float32, which differs from one true rounding only in
    rare halfway cases. XLA:CPU contracts such pairs where one fused loop
    holds both (the reference's sums of squares, some affine maps)."""
    return (a.double() * b.double() + c.double()).float()


def sq_norm_fma(p: torch.Tensor) -> torch.Tensor:
    """``sum(p * p, -1)`` over a 3-wide axis as XLA:CPU evaluates it:
    ``fma(z, z, fma(y, y, x * x))``."""
    x, y, z = p.unbind(-1)
    return fma_f32(z, z, fma_f32(y, y, x * x))


class SegmentPlan(NamedTuple):
    """How ``segment_sum`` groups a fixed segment-id vector: the stable
    order of its entries by segment, and each segment's length."""

    order: torch.Tensor    # (n,) int64
    lengths: torch.Tensor  # (num_segments,) int64


def segment_plan(seg: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The stable sort and the segment lengths of ``seg`` (values in
    [0, num_segments)), taken once where one segment-id vector serves many
    sums (the back end's edges and observations). No host sync: the lengths are an ``index_add_`` of int64 ones, where
    ``bincount`` would synchronize."""
    seg = seg.reshape(-1).long()
    order = torch.sort(seg, stable=True).indices
    lengths = torch.zeros(num_segments, dtype=torch.long, device=seg.device).index_add_(0, seg, torch.ones_like(seg))
    return SegmentPlan(order, lengths)


def segment_sum(
    x: torch.Tensor, seg: torch.Tensor | None, num_segments: int, plan: SegmentPlan | None = None
) -> torch.Tensor:
    """``out[s] = sum(x[i] for i with seg[i] == s)`` over axis 0, each
    segment summed from zero in index order: the reference's
    ``jax.ops.segment_sum`` (and ``.at[seg].add`` into zeros) on the CPU
    adds its updates one by one in that order. A stable sort by segment and
    ``torch.segment_reduce`` keep it on any device, with no atomics
    (``index_add_`` on the card adds in no fixed order). ``seg`` holds
    values in [0, num_segments); ``plan``, ``segment_plan(seg,
    num_segments)`` taken beforehand, skips the sort, and ``seg`` is then
    not read."""
    if plan is None:
        plan = segment_plan(seg, num_segments)
    flat = x.reshape((plan.order.shape[0], -1))[plan.order]
    out = torch.segment_reduce(flat, "sum", lengths=plan.lengths, axis=0)
    return out.reshape((num_segments,) + x.shape[1:])


def segment_max(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` over axis 0: an empty segment holds the
    dtype's lowest value (-inf for floats), as the reference's does."""
    low = -float("inf") if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
    out = torch.full((num_segments,) + x.shape[1:], low, dtype=x.dtype, device=x.device)
    idx = seg.long().reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce(0, idx, x, "amax", include_self=False)


def sorted_unique_head(key: torch.Tensor, count: int, pad: int) -> torch.Tensor:
    """The ``count`` smallest distinct values of the int32 ``key`` (values
    equal to ``pad`` ignored), ascending, padded with ``pad``: the
    reference's sort / first-of-run / sort idiom. At most ``count`` (and
    at most ``len(key)``) int32 values."""
    n = key.shape[0]
    skey = torch.sort(key).values
    head = torch.ones(1, dtype=torch.bool, device=key.device)
    first = torch.cat([head, skey[1:] != skey[:-1]]) & (skey != pad)
    upos = torch.where(first, torch.arange(n, dtype=torch.int32, device=key.device), n)
    sel = torch.sort(upos).values[:count]
    return torch.where(sel < n, skey[sel.clamp(max=n - 1).long()], pad).to(torch.int32)
