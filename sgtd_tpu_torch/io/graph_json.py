"""Reference-compatible semantic-graph JSON (port of sgtd_tpu.io.graph_json).

Round-trips the reference's per-scan Graph JSON files
(``Graph::toJSON``/``fromJSON``, src/sgtd/include/Semantic_Graph.hpp:79-157):
keys ``nodes`` (int list), ``centers`` ([[x,y,z], ...]), ``poses`` (flat 12+
floats, row-major 3x4), plus ``edges``/``weights``/``volumes``/``densitys``
(written empty by the reference's builder, get_json.cpp:332). A file written
by either package reads back in the other with the same bits: float32
values are written as ``float(v)`` (the shortest repr of the float32
widened to float64) and read back as float32.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.graph.types import SemanticGraph, make_graph
from sgtd_tpu_torch.utils import host_array as _host


def pose_row_to_matrix(poses: List[float]) -> np.ndarray:
    """Flat row-major 3x4 (or longer) pose row -> 4x4 float32 matrix
    (layout per Semantic_Graph.hpp:496-505)."""
    p = np.asarray(poses, dtype=np.float32)
    T = np.eye(4, dtype=np.float32)
    T[0, :4] = p[0:4]
    T[1, :4] = p[4:8]
    T[2, :4] = p[8:12]
    return T


def matrix_to_pose_row(T) -> List[float]:
    T = _host(T).astype(np.float32)
    return [float(x) for x in T[:3, :4].reshape(-1)]


def read_graph_json(path: str, config: SGTDConfig, device: torch.device | str = "cuda") -> SemanticGraph:
    """One graph file as a padded SemanticGraph of tensors on ``device``."""
    with open(path) as f:
        j = json.load(f)
    nodes = np.asarray(j["nodes"], dtype=np.int32)
    centers = np.asarray(j["centers"], dtype=np.float32).reshape(-1, 3)
    pose = pose_row_to_matrix(j["poses"])
    density = np.asarray(j["densitys"], dtype=np.float32) if j.get("densitys") else None
    g = make_graph(centers, nodes, pose, config.caps.max_nodes, density)
    return SemanticGraph(*(torch.from_numpy(x).to(device) for x in g))


def write_graph_json(path: str, graph: SemanticGraph) -> None:
    """Write one graph (NumPy arrays or tensors on any device)."""
    mask = _host(graph.mask).astype(bool)
    j = {
        "nodes": [int(x) for x in _host(graph.labels)[mask]],
        "edges": [],
        "weights": [],
        "centers": [[float(v) for v in row] for row in _host(graph.centers)[mask]],
        "poses": matrix_to_pose_row(graph.pose),
        "volumes": [],
        "densitys": [float(x) for x in _host(graph.density)[mask]],
    }
    with open(path, "w") as f:
        json.dump(j, f)


def read_graph_dir(directory: str, config: SGTDConfig, device: torch.device | str = "cuda") -> List[SemanticGraph]:
    """Every .json graph of a directory, sorted by file name (the reference's
    map/query loading, semantic_graph_localization.cpp:379-403)."""
    files = sorted(os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(".json"))
    return [read_graph_json(f, config, device) for f in files]
