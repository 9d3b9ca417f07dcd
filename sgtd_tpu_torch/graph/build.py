"""Labeled point cloud -> semantic instance graph (port of
sgtd_tpu.graph.build).

The reference's per-scan graph builder (``gen_labels`` + ``gen_graphs``,
get_json.cpp:41-343) with its class routing, on tensors on the points'
device:

  * whole-kept classes (class 10, sidewalk, under the MulRan/SemanticKITTI
    routing) become one instance each;
  * instance classes are split by ground-truth instance ids where the scan
    has them (> 20 points an instance), else DCVC-clustered with per-class
    minimum segment sizes, all classes in one clustering pass (the class is
    packed into the voxel key);
  * node labels are remapped through the routing's node map and kept in
    its range; attributes are the centroid and the density.

Sums follow the reference's order on the CPU: segment sums point by point
(K3 ``ops.grouped.grouped_sums``), the whole-class sums as XLA:CPU's row
reduction adds them (:func:`_xla_row_sum`), squares as FMA chains.

Under the tracer (``utils.profiling``), a scan is the span ``graph.build``
holding ``cluster.dcvc``, ``graph.gt_group``, ``graph.whole`` and
``graph.compact``, with the counters ``graph.points`` (valid points) and
``graph.nodes`` (kept nodes).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sgtd_tpu_torch.cluster.dcvc import ClusterResult, dcvc_cluster
from sgtd_tpu_torch.config import CapacityConfig, DcvcConfig
from sgtd_tpu_torch.graph.types import SemanticGraph
from sgtd_tpu_torch.ops import grouped
from sgtd_tpu_torch.utils import profiling, segment_max, sorted_unique_head, sq_norm_fma

I32_MAX = 2**31 - 1

GT_MIN_POINTS = 20
# The window of XLA:CPU's tree-reduction rewrite (see _xla_row_sum).
_REDUCE_WINDOW = 32


@dataclasses.dataclass(frozen=True)
class ClassRouting:
    """Static per-dataset class routing."""

    whole_classes: Tuple[int, ...]
    instance_classes: Tuple[int, ...]
    min_seg: Tuple[Tuple[int, int], ...]  # (class, min_seg) overrides
    default_min_seg: int
    node_map: Tuple[Tuple[int, int], ...]
    keep_lo: int
    keep_hi: int

    def tables(self):
        is_inst = np.zeros(32, dtype=bool)
        min_seg = np.zeros(32, dtype=np.float32)
        node_label = np.full(32, -1, dtype=np.int32)
        overrides = dict(self.min_seg)
        for c in self.instance_classes:
            is_inst[c] = True
            min_seg[c] = overrides.get(c, self.default_min_seg)
        for c, v in self.node_map:
            node_label[c] = v
        return is_inst, min_seg, node_label


# MulRan/SemanticKITTI train-id routing (ref get_json.cpp).
MULRAN_ROUTING = ClassRouting(
    whole_classes=(10,),
    instance_classes=(11, 12, 13, 15, 16, 17, 18),
    min_seg=((15, 5), (17, 5), (18, 5)),
    default_min_seg=300,
    node_map=((10, 3), (11, 4), (12, 5), (13, 6), (14, 7), (15, 8), (16, 9), (17, 10), (18, 11)),
    keep_lo=3,
    keep_hi=12,
)

# Wild-Places forests routing (ref get_json_wild.cpp:10-31,119-180): 13
# remapped classes; class 1 (dirt) kept whole; tree-foliage (11) dropped;
# others DCVC with min 100; identity node map.
WILD_ROUTING = ClassRouting(
    whole_classes=(1,),
    instance_classes=(0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12),
    min_seg=(),
    default_min_seg=100,
    node_map=tuple((c, c) for c in range(13)),
    keep_lo=0,
    keep_hi=12,
)

# Back-compat module constants (MulRan profile).
WHOLE_CLASSES = MULRAN_ROUTING.whole_classes
INSTANCE_CLASSES = MULRAN_ROUTING.instance_classes
NODE_MAP = dict(MULRAN_ROUTING.node_map)


def _xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x, axis=0)`` of an (N, ...) float32 array as XLA:CPU adds
    it: its tree-reduction rewrite sums windows of 32 rows, each from zero
    in row order (the rows zero-padded to a multiple of 32, half the
    padding before them, rounded down), and repeats on the window sums
    until at most 32 rows are left, which it sums in row order."""

    def rows_in_order(v: torch.Tensor) -> torch.Tensor:  # (M, W, ...) -> (M, ...)
        acc = torch.zeros_like(v[:, 0])
        for row in v.unbind(1):
            acc = acc + row
        return acc

    while x.shape[0] > _REDUCE_WINDOW:
        pad = -x.shape[0] % _REDUCE_WINDOW
        if pad:
            zeros = lambda k: x.new_zeros((k,) + x.shape[1:])  # noqa: E731
            x = torch.cat([zeros(pad // 2), x, zeros(pad - pad // 2)])
        x = rows_in_order(x.reshape((-1, _REDUCE_WINDOW) + x.shape[1:]))
    return rows_in_order(x[None])[0]


def _group_by_key(points: torch.Tensor, key: torch.Tensor, c_max: int, min_pts: float):
    """Group masked points by an int32 key (key == I32_MAX -> ignored).

    Returns (point_cluster (N,), centroids (C, 3), counts (C,), density
    (C,), ukey (C,), valid (C,)).
    """
    ukey = sorted_unique_head(key, c_max, I32_MAX)
    c = ukey.shape[0]
    slot = torch.searchsorted(ukey, key.contiguous()).to(torch.int32)
    pc = torch.where((key != I32_MAX) & (slot < c), slot, -1)

    counts, sums, sq = grouped.grouped_sums(points, pc, c)
    denom = counts.clamp(min=1.0)[:, None]
    centroids = sums / denom
    density = (sq / denom[:, 0] - sq_norm_fma(centroids)).clamp(min=0.0)
    valid = (counts > min_pts) & (ukey != I32_MAX)
    return pc, centroids, counts, density, ukey, valid


@profiling.traced("graph.build")
def build_graph_arrays(
    points: torch.Tensor,
    sem: torch.Tensor,
    inst: torch.Tensor,
    mask: torch.Tensor,
    caps: CapacityConfig = CapacityConfig(),
    dcvc: DcvcConfig = DcvcConfig(),
    routing: ClassRouting = MULRAN_ROUTING,
):
    """Cluster one labeled scan into padded node arrays.

    points: (N, 3) float32; sem/inst: (N,) int32 (train-id semantics and raw
    instance ids); mask: (N,) bool for padding. Runs on the points' device.
    Returns (centers (M, 3), labels (M,), density (M,), node_mask (M,)).
    """
    dev = points.device
    profiling.count_mask("graph.points", mask, True)
    is_inst_tab, min_seg_tab, node_label_tab = (torch.from_numpy(t).to(dev) for t in routing.tables())
    sem_c = sem.to(torch.int32).clamp(0, 31)
    inst = inst.to(torch.int32)
    is_inst_class = is_inst_tab[sem_c.long()] & mask

    # Which classes have GT instance ids in this scan? (ref :138)
    has_inst_point = is_inst_class & (inst != 0)
    class_has_inst = segment_max(has_inst_point.to(torch.int32), sem_c, 32) != 0
    use_gt = class_has_inst[sem_c.long()] & is_inst_class

    # One DCVC pass over every instance class without GT ids.
    dcvc_res: ClusterResult = dcvc_cluster(points, is_inst_class & ~use_gt, min_seg_tab[sem_c.long()], dcvc,
                                           group=sem_c)
    dcvc_labels = node_label_tab[dcvc_res.group.clamp(0, 31).long()]

    # One grouping pass over (class, instance) for GT-labelled classes.
    with profiling.span("graph.gt_group"):
        gt_key = torch.where(use_gt, sem_c * 65536 + inst.clamp(0, 65535), I32_MAX).to(torch.int32)
        _, gt_cent, gt_cnt, gt_den, gt_ukey, gt_valid = _group_by_key(
            points, gt_key, dcvc.max_clusters, float(GT_MIN_POINTS))
        gt_labels = node_label_tab[(gt_ukey // 65536).clamp(0, 31).long()]

    # Whole-kept classes: one instance from all points of the class.
    with profiling.span("graph.whole"):
        whole = []
        node_map = dict(routing.node_map)
        for c in routing.whole_classes:
            cmask = mask & (sem_c == c)
            # The count, the coordinate sums and the sum of squares as five
            # columns of one reduction (each column adds in the same order).
            cols = torch.cat([cmask.to(torch.float32)[:, None], torch.where(cmask[:, None], points, 0.0),
                              torch.where(cmask, sq_norm_fma(points), 0.0)[:, None]], dim=1)
            cnt, sums, sq = _xla_row_sum(cols).split([1, 3, 1])
            denom = cnt.clamp(min=1.0)
            centroid = sums / denom
            density = (sq / denom - sq_norm_fma(centroid)).clamp(min=0.0)
            whole.append((centroid[None], torch.full((1,), node_map[c], dtype=torch.int32, device=dev),
                          density, cnt > 0))

    with profiling.span("graph.compact"):
        centers = torch.cat([w[0] for w in whole] + [dcvc_res.centroids, gt_cent])
        labels = torch.cat([w[1] for w in whole] + [dcvc_labels, gt_labels])
        density = torch.cat([w[2] for w in whole] + [dcvc_res.density, gt_den])
        valid = torch.cat([w[3] for w in whole] + [dcvc_res.valid, gt_valid])

        # Node labels must land in the keep range (ref :288).
        valid = valid & (labels >= routing.keep_lo) & (labels <= routing.keep_hi)

        # Compact to max_nodes, keeping the (source, cluster-slot) order.
        m = caps.max_nodes
        total = valid.shape[0]
        prio = torch.where(valid, torch.arange(total, dtype=torch.int32, device=dev), total)
        sel = torch.sort(prio, stable=True).indices[:m]
        node_mask = prio[sel] < total
        profiling.count_mask("graph.nodes", node_mask, True)
        return (
            torch.where(node_mask[:, None], centers[sel], 0.0),
            torch.where(node_mask, labels[sel], 0),
            torch.where(node_mask, density[sel], 0.0),
            node_mask,
        )


def build_graph(
    points: torch.Tensor,
    sem: torch.Tensor,
    inst: torch.Tensor,
    mask: torch.Tensor,
    pose,
    caps: CapacityConfig = CapacityConfig(),
    dcvc: DcvcConfig = DcvcConfig(),
    routing: ClassRouting = MULRAN_ROUTING,
) -> SemanticGraph:
    """One scan's SemanticGraph, its arrays on the points' device."""
    centers, labels, density, node_mask = build_graph_arrays(points, sem, inst, mask, caps, dcvc, routing)
    return SemanticGraph(
        centers=centers,
        labels=labels,
        density=density,
        mask=node_mask,
        pose=torch.as_tensor(pose, dtype=torch.float32, device=points.device),
    )
