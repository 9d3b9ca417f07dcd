"""The yardstick's arithmetic: the card's published peaks and the least
work a stage needs, counted from the problem's shapes and data (the
kernel records of ``chip_smoke.py``: bytes read once and written once, a
distance as 8 float32 operations).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet at 700 W: HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
DISTANCE_FLOPS = 8


def bound_s(nbytes: float = 0.0, flops: float = 0.0) -> float:
    """Least seconds the card needs: bytes over the memory rate or
    operations over the float32 peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S)


def search_bytes(scan_totals, f_pad: int) -> int:
    """Candidate search of one request: every scanned bucket slot's packed
    row (two int32 words) read once, each query's float32 vote row over
    the padded frames written once."""
    return 8 * int(sum(scan_totals)) + 4 * len(scan_totals) * f_pad


def refine_flops(nn1_launches: int, knn_launches: int, pairs: int, self_pairs: int) -> int:
    """GICP rerank of one request: the nearest-neighbour distances of
    every linearization and of the final fitness pass (``nn1_launches``,
    each over the ``pairs`` of valid query and keyframe points of all the
    request's problems), and of the query covariances' k-NN
    (``knn_launches``, each over the ``self_pairs`` of valid points of
    each query cloud with itself). Padding is not counted. The
    linearization's own arithmetic (under 3% of it) is not counted."""
    return DISTANCE_FLOPS * (nn1_launches * pairs + knn_launches * self_pairs)
