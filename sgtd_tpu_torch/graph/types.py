"""Semantic-graph keyframes as padded tensors (port of sgtd_tpu.graph.types).

Same padded layout as the reference: per keyframe ``max_nodes`` instance
slots with a validity mask. ``make_graph`` stays host-side NumPy (one
graph at a time, as the reference builds them); ``stack_graphs`` stacks a
list on the host and moves each field to the device in one transfer.
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
) -> SemanticGraph:
    """Padded SemanticGraph of NumPy arrays from variable-length host arrays.

    Graphs with more than ``max_nodes`` nodes keep the nodes nearest the
    sensor, in their original order (as the reference does).
    """
    centers = np.asarray(centers, dtype=np.float32).reshape(-1, 3)
    labels = np.asarray(labels, dtype=np.int32).reshape(-1)
    n = centers.shape[0]
    if n > max_nodes:
        order = np.argsort(np.linalg.norm(centers, axis=1), kind="stable")[:max_nodes]
        order = np.sort(order)
        centers, labels = centers[order], labels[order]
        n = max_nodes
    pad = max_nodes - n
    m = np.zeros(max_nodes, dtype=bool)
    m[:n] = True
    return SemanticGraph(
        centers=np.pad(centers, ((0, pad), (0, 0))),
        labels=np.pad(labels, (0, pad)),
        density=np.zeros(max_nodes, dtype=np.float32),
        mask=m,
        pose=np.asarray(pose, dtype=np.float32).reshape(4, 4),
    )


def stack_graphs(
    graphs: Sequence[SemanticGraph], device: torch.device | str
) -> SemanticGraph:
    """Stack host graphs into one batched SemanticGraph on ``device``."""
    return SemanticGraph(
        *(
            torch.from_numpy(
                np.stack([np.asarray(getattr(g, f)) for g in graphs])
            ).to(device)
            for f in SemanticGraph._fields
        )
    )
