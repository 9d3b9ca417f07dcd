"""K3 ``grouped_sums``: the front end's cluster sums (kernel in
``csrc/grouped.cu``; no TPU kernel: the reference sums clusters with plain
``jax.ops.segment_sum``).

For each slot s < S of an int32 slot vector: the count of its rows, their
three coordinate sums and the sum of their ``sq_norm_fma``, each column
added from zero in point order (the reference's segment-sum order on the
CPU). A row whose slot lies outside [0, S) is left out. A CUDA tensor
launches the kernel after one stable sort of the slot vector, and the
kernel reads no row that is left out; a CPU tensor takes the plain
PyTorch version (``utils.segment_sum``, the rows left out summed into an
extra segment that is dropped), the oracle. There is no fallback between
the two.

Under the tracer (``utils.profiling``), the counters ``grouped.rows``
(rows summed) and ``grouped.dropped`` (rows left out), a call each. The
mask they count is made on both devices, so that tracing adds no
operation.
"""

from __future__ import annotations

import torch

from sgtd_tpu_torch.ops import _build
from sgtd_tpu_torch.utils import profiling, segment_sum, sq_norm_fma


def grouped_sums_plain(points: torch.Tensor, slot: torch.Tensor, num_slots: int):
    """Plain version of K3: (counts (S,), sums (S, 3), sq (S,)) float32."""
    return _plain(points, slot, (slot >= 0) & (slot < num_slots), num_slots)


def _plain(points, slot, keep, num_slots: int):
    # One stable sort for the five columns: segment_sum adds each column
    # of each segment from zero in index order.
    seg = torch.where(keep, slot, num_slots)
    cols = torch.cat([keep.to(torch.float32)[:, None], points, sq_norm_fma(points)[:, None]], dim=1)
    out = segment_sum(cols, seg, num_slots + 1)[:num_slots]
    return out[:, 0], out[:, 1:4], out[:, 4]


def grouped_sums(points: torch.Tensor, slot: torch.Tensor, num_slots: int):
    """points (N, 3) float32, slot (N,) int32 (outside [0, num_slots): left
    out) -> (counts (S,), sums (S, 3), sq (S,)) float32, S = num_slots:
    each slot's row count, coordinate sums and sum of ``sq_norm_fma``,
    added in point order."""
    n = slot.shape[0] if slot.ndim == 1 else -1
    dev = _build.check("grouped_sums", ("slot", slot, 1, torch.int32), ("points", points, (n, 3), torch.float32))
    if num_slots < 1 or n >= 2**31:
        raise ValueError(f"grouped_sums: 1 or more slots and fewer than 2**31 rows required, got {num_slots}, {n}")
    keep = (slot >= 0) & (slot < num_slots)
    profiling.count_mask("grouped.rows", keep, True)
    profiling.count_mask("grouped.dropped", keep, False)
    if dev.type == "cpu":
        return _plain(points, slot, keep, num_slots)
    points = points.contiguous()
    sorted_slot, order = torch.sort(slot, stable=True)
    counts, sums, sq = points.new_empty((num_slots,)), points.new_empty((num_slots, 3)), points.new_empty((num_slots,))
    _build.launch("sgtd_grouped_sums", dev, points.data_ptr(), sorted_slot.data_ptr(), order.data_ptr(),
                  counts.data_ptr(), sums.data_ptr(), sq.data_ptr(), n, num_slots)
    return counts, sums, sq
