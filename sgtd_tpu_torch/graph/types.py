"""Semantic-graph keyframes as padded tensors (port of sgtd_tpu.graph.types).

Same padded layout as the reference: per keyframe ``max_nodes`` instance
slots with a validity mask. ``make_graph`` stays host-side NumPy (one
graph at a time, as the reference builds them); ``stack_graphs`` stacks a
list of graphs (NumPy arrays, stacked on the host and moved in one
transfer a field, or tensors, stacked where they lie) onto a device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class SemanticGraph(NamedTuple):
    """One keyframe's (or a batch's) semantic instance graph.

    centers: (..., N, 3) float32 — instance centroids in the sensor frame.
    labels:  (..., N) int32 — remapped node class labels.
    density: (..., N) float32 — per-instance spread.
    mask:    (..., N) bool — True for real nodes.
    pose:    (..., 4, 4) float32 — keyframe pose (sensor in world).
    """

    centers: torch.Tensor
    labels: torch.Tensor
    density: torch.Tensor
    mask: torch.Tensor
    pose: torch.Tensor


def make_graph(
    centers: np.ndarray,
    labels: np.ndarray,
    pose: np.ndarray,
    max_nodes: int,
    density: np.ndarray | None = None,
) -> SemanticGraph:
    """Padded SemanticGraph of NumPy arrays from variable-length host arrays.

    Graphs with more than ``max_nodes`` nodes keep the nodes nearest the
    sensor, in their original order (as the reference does). ``density``
    defaults to zeros.
    """
    centers = np.asarray(centers, dtype=np.float32).reshape(-1, 3)
    labels = np.asarray(labels, dtype=np.int32).reshape(-1)
    n = centers.shape[0]
    if n > max_nodes:
        order = np.argsort(np.linalg.norm(centers, axis=1), kind="stable")[:max_nodes]
        order = np.sort(order)
        centers, labels = centers[order], labels[order]
        if density is not None:
            density = np.asarray(density, dtype=np.float32)[order]
        n = max_nodes
    pad = max_nodes - n
    m = np.zeros(max_nodes, dtype=bool)
    m[:n] = True
    d = np.zeros(max_nodes, dtype=np.float32)
    if density is not None:
        d[:n] = np.asarray(density, dtype=np.float32)[:n]
    return SemanticGraph(
        centers=np.pad(centers, ((0, pad), (0, 0))),
        labels=np.pad(labels, (0, pad)),
        density=d,
        mask=m,
        pose=np.asarray(pose, dtype=np.float32).reshape(4, 4),
    )


def stack_graphs(
    graphs: Sequence[SemanticGraph], device: torch.device | str
) -> SemanticGraph:
    """Stack graphs into one batched SemanticGraph on ``device``: NumPy
    fields on the host (one transfer a field), tensor fields on their own
    device."""
    return SemanticGraph(
        *(
            torch.stack([torch.as_tensor(getattr(g, f)) for g in graphs]).to(device)
            for f in SemanticGraph._fields
        )
    )
