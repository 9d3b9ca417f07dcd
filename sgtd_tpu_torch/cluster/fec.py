"""Fast Euclidean Clustering (FEC) on tensors (port of sgtd_tpu.cluster.fec).

The reference's alternate clustering backend (FEC.h:34-140, invoked —
commented out — at get_json.cpp:196-197): connected components of the
"within ``tolerance``" radius graph, then a ``min_component_size`` filter.
As in the JAX package, the neighbour graph is the k-nearest-neighbour
graph (k = ``max_n``, the reference's cap on each radius query) gated at
``tolerance``, and the components resolve by min-label propagation with
pointer jumping.

The k nearest neighbours come from B5 (``ops.nn.knn``): one problem whose
queries and references are the same N points, the padding at 1e6 m (so
up to N - n equal far points tie, and the lowest index wins). On a CUDA
tensor that launches the hand-written kernel; on a CPU tensor its plain
version. The propagation and the compaction are ``cluster.components``'s,
shared with DCVC. Under the tracer (``utils.profiling``), the counter
``fec.sweeps`` records a call's propagation sweeps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sgtd_tpu_torch.cluster import components
from sgtd_tpu_torch.ops import nn
from sgtd_tpu_torch.utils import profiling, sq_norm_fma


class FecResult(NamedTuple):
    """labels: (N,) int32 cluster id per point (-1 = unclustered or
    filtered), ids compacted by descending cluster size;
    counts: (C,) float32 points per cluster id."""

    labels: torch.Tensor
    counts: torch.Tensor


def fec_cluster(
    points: torch.Tensor,
    mask: torch.Tensor,
    tolerance,
    min_component_size,
    max_n: int = 16,
    max_clusters: int = 256,
) -> FecResult:
    """Cluster the masked points of one (class-filtered) cloud.

    points (N, 3) float32 padded; mask (N,) bool; tolerance: radius in
    metres (ref FEC.h radiusSearch); min_component_size: minimum cluster
    size (ref :36); max_n: neighbour cap (ref :64). Where a point's
    ``max_n`` nearest neighbours all lie in its own dense clump, bridging
    edges beyond them are lost and a radius-graph component can split, as
    in the JAX package (tests/test_fec.py's ``max_n`` case).
    """
    n = points.shape[0]
    dev = points.device
    pts_eff = torch.where(mask[:, None], points, 1e6)
    idx = nn.knn(pts_eff, pts_eff, max_n).long()  # (N, k), self included
    tol = np.float32(tolerance)
    within = sq_norm_fma(pts_eff[idx] - pts_eff[:, None, :]) <= float(tol * tol)
    self_i = torch.arange(n, dtype=torch.int32, device=dev)
    nidx = torch.where(within & mask[:, None], idx, self_i[:, None].long())
    # kNN edges are directed: each sweep also pushes labels along them.
    label, sweeps = components.min_labels(self_i, nidx, reverse=nidx.reshape(-1))
    profiling.count("fec.sweeps", sweeps)

    # Component sizes (a masked point adds 0); filter small components
    # (ref FEC.h:110-128).
    sizes = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(0, label.long(), mask.to(torch.float32))
    keep_root = sizes >= float(np.float32(min_component_size))

    # Compact kept roots into dense ids, largest first.
    is_root = (label == self_i) & mask & keep_root
    k = min(max_clusters, n)
    slot_of_root = components.root_slots(torch.where(is_root, sizes, -1.0), k)
    labels = torch.where(mask, slot_of_root[label.long()], -1)
    counts = torch.zeros(k + 1, dtype=torch.float32, device=dev).index_add_(
        0, torch.where(labels >= 0, labels, k).long(), (labels >= 0).to(torch.float32))[:k]
    return FecResult(labels=labels, counts=counts)
