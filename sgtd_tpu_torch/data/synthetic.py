"""Synthetic semantic-instance worlds (port of sgtd_tpu.data.synthetic).

Pure NumPy, and draw for draw the same random stream as the reference, so
one seed gives bit-identical graphs in both packages: a field of labelled
instances, a looping map trajectory of keyframes, and revisit queries with
pose offsets, centroid noise, instance dropout and label corruption. The
reference module cannot be imported where the port runs (it pulls in JAX
through its graph types), hence this copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.graph.types import SemanticGraph, make_graph

# Remapped node labels 3..12 with urban instance frequencies.
NODE_LABELS = np.arange(3, 13)
LABEL_WEIGHTS = np.array([0.08, 0.05, 0.30, 0.08, 0.02, 0.12, 0.05, 0.20, 0.08, 0.02])


@dataclasses.dataclass
class SyntheticWorld:
    instance_xyz: np.ndarray  # (M, 3)
    instance_label: np.ndarray  # (M,)
    map_poses: np.ndarray  # (F, 4, 4)
    query_poses: np.ndarray  # (Q, 4, 4)
    instance_yaw: np.ndarray  # (M,) planar panel heading (for cloud renders)
    instance_size: np.ndarray  # (M, 2) panel width, height


def _pose_2d(x: float, y: float, yaw: float, z: float = 0.0) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    T[:3, 3] = (x, y, z)
    return T


def make_world(
    rng: np.random.Generator,
    extent_m: float = 400.0,
    instances_per_100m2: float = 1.2,
    num_map_frames: int = 50,
    num_queries: int = 20,
    keyframe_spacing_m: float = 8.0,
    query_offset_m: float = 3.0,
) -> SyntheticWorld:
    """A looping trajectory of radius extent/3 through a field of instances."""
    area = extent_m * extent_m
    m = int(area / 100.0 * instances_per_100m2)
    xyz = np.column_stack(
        [
            rng.uniform(-extent_m / 2, extent_m / 2, m),
            rng.uniform(-extent_m / 2, extent_m / 2, m),
            rng.uniform(0.0, 4.0, m),
        ]
    ).astype(np.float32)
    labels = rng.choice(NODE_LABELS, size=m, p=LABEL_WEIGHTS / LABEL_WEIGHTS.sum())
    yaws = rng.uniform(0.0, np.pi, m).astype(np.float32)
    sizes = np.column_stack(
        [rng.uniform(3.0, 8.0, m), rng.uniform(2.5, 6.0, m)]
    ).astype(np.float32)

    r = extent_m / 3.0
    thetas = np.linspace(0, 2 * np.pi, num_map_frames, endpoint=False)
    map_poses = np.stack(
        [_pose_2d(r * np.cos(t), r * np.sin(t), t + np.pi / 2) for t in thetas]
    )
    q_thetas = rng.uniform(0, 2 * np.pi, num_queries)
    query_poses = np.stack(
        [
            _pose_2d(
                r * np.cos(t) + rng.normal(0, query_offset_m),
                r * np.sin(t) + rng.normal(0, query_offset_m),
                t + np.pi / 2 + rng.normal(0, 0.15),
            )
            for t in q_thetas
        ]
    )
    return SyntheticWorld(
        instance_xyz=xyz,
        instance_label=labels,
        map_poses=map_poses,
        query_poses=query_poses,
        instance_yaw=yaws,
        instance_size=sizes,
    )


def observe(
    world: SyntheticWorld,
    pose: np.ndarray,
    config: SGTDConfig,
    rng: np.random.Generator,
    view_radius_m: float = 50.0,
    center_noise_m: float = 0.05,
    dropout: float = 0.0,
    label_corrupt_rate: float = 0.0,
) -> SemanticGraph:
    """The semantic graph (NumPy fields) a sensor at ``pose`` would produce."""
    Tinv = np.linalg.inv(pose)
    local = (world.instance_xyz @ Tinv[:3, :3].T) + Tinv[:3, 3]
    dist = np.linalg.norm(local[:, :2], axis=1)
    vis = dist < view_radius_m
    if dropout > 0:
        vis &= rng.uniform(size=vis.shape) > dropout
    centers = local[vis] + rng.normal(0, center_noise_m, (int(vis.sum()), 3))
    labels = world.instance_label[vis].copy()
    if label_corrupt_rate > 0:
        bad = rng.uniform(size=labels.shape) < label_corrupt_rate
        labels[bad] = rng.choice(NODE_LABELS, size=int(bad.sum()))
    return make_graph(
        centers.astype(np.float32), labels, pose, config.caps.max_nodes
    )


def make_map_and_queries(
    config: SGTDConfig,
    seed: int = 0,
    num_map_frames: int = 50,
    num_queries: int = 20,
    **obs_kw,
) -> Tuple[List[SemanticGraph], List[SemanticGraph], SyntheticWorld]:
    """Map keyframe graphs, query graphs (observed with ``obs_kw``), world."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, num_map_frames=num_map_frames, num_queries=num_queries)
    map_graphs = [observe(world, p, config, rng) for p in world.map_poses]
    query_graphs = [
        observe(world, p, config, rng, **obs_kw) for p in world.query_poses
    ]
    return map_graphs, query_graphs, world
