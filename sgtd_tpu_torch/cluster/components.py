"""Connected components and cluster slots, shared by DCVC and FEC.

:func:`min_labels` labels each node of a neighbour graph by the smallest
node of its component: min-label propagation with two pointer jumps a
sweep, until a sweep changes nothing. Each sweep is a handful of tensor
operations and one host synchronisation (``torch.equal``); the fixed point
does not depend on the order of the updates. :func:`root_slots` compacts
component roots into cluster slots, largest first.
"""

from __future__ import annotations

import torch


def min_labels(init: torch.Tensor, nbr: torch.Tensor, reverse: torch.Tensor | None = None):
    """init (N,) int32, ``arange(N)``; nbr (N, k) int64, each node's
    neighbours (a node may list itself) -> (labels (N,) int32, the smallest
    node of each node's component; the propagation's sweeps). ``reverse``:
    ``nbr`` flattened, where its edges run one way only (a kNN graph); each
    sweep then also pushes every node's label to its neighbours by a
    scatter-min."""
    label = init
    sweeps = 0
    while True:
        sweeps += 1
        new = torch.minimum(label, label[nbr].min(dim=1).values)
        if reverse is not None:
            new = new.scatter_reduce(0, reverse, new[:, None].expand(-1, nbr.shape[1]).reshape(-1), "amin")
        new = torch.minimum(new, new[new.long()])  # pointer jumping
        new = torch.minimum(new, new[new.long()])
        if torch.equal(new, label):
            return label, sweeps
        label = new


def root_slots(score: torch.Tensor, num_slots: int) -> torch.Tensor:
    """score (N,) float32, each root's size (<= 0 for a node that is no
    root) -> (N,) int32: the slot of each of the ``num_slots`` largest
    positive scores, in descending order with ties to the lower index (the
    reference's top_k), -1 for every other node. One stable sort, no
    boolean-mask indexing (no host synchronisation)."""
    top = torch.sort(score, descending=True, stable=True)
    top_score, top_root = top.values[:num_slots], top.indices[:num_slots]
    slot_of_root = torch.full(score.shape, -1, dtype=torch.int32, device=score.device)
    slot_of_root[top_root] = torch.where(
        top_score > 0, torch.arange(top_score.shape[0], dtype=torch.int32, device=score.device), -1)
    return slot_of_root
