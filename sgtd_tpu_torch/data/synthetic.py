"""Synthetic semantic-instance worlds (port of sgtd_tpu.data.synthetic).

Pure NumPy, and draw for draw the same random stream as the reference, so
one seed gives bit-identical graphs and clouds in both packages: a field
of labelled instances, a looping map trajectory of keyframes, and revisit
queries with pose offsets, centroid noise, instance dropout and label
corruption; the aliased Manhattan-grid world (``make_hard_world``); and
LiDAR-like clouds sampled from the instances' planar panels
(``render_planar_cloud``) or as blobs (``render_cloud``). The
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


@dataclasses.dataclass
class HardWorld(SyntheticWorld):
    """Aliased Manhattan-grid world with planar surface geometry: a few
    block motifs tile a street grid (distinct places look alike to the
    descriptor matcher), a few unique instances per block keep the places
    discriminable, and every instance carries a fixed planar panel, so
    clouds rendered from any two poses sample the same surfaces."""


def make_hard_world(
    rng: np.random.Generator,
    n_motifs: int = 4,
    grid: Tuple[int, int] = (6, 6),
    block_m: float = 45.0,
    instances_per_block: int = 22,
    unique_per_block: int = 5,
    motif_jitter_m: float = 0.05,
    num_map_frames: int = 200,
    num_queries: int = 64,
    query_offset_m: float = 3.0,
    query_heading_sd: float = 0.15,
) -> HardWorld:
    """Tile ``grid`` city blocks from ``n_motifs`` repeated layouts; the map
    trajectory is a serpentine along the street lines, and queries revisit
    random points on it with lateral and heading offsets."""
    gx, gy = grid
    p_label = LABEL_WEIGHTS / LABEL_WEIGHTS.sum()
    motifs = []
    for _ in range(n_motifs):
        k = instances_per_block
        pos = np.column_stack(
            [
                rng.uniform(4.0, block_m - 4.0, k),
                rng.uniform(4.0, block_m - 4.0, k),
                rng.uniform(0.5, 3.0, k),
            ]
        )
        lab = rng.choice(NODE_LABELS, size=k, p=p_label)
        yaw = rng.uniform(0.0, np.pi, k)
        size = np.column_stack([rng.uniform(3.0, 8.0, k), rng.uniform(2.5, 6.0, k)])
        motifs.append((pos, lab, yaw, size))

    xyz, labels, yaws, sizes = [], [], [], []
    for bx in range(gx):
        for by in range(gy):
            pos, lab, yaw, size = motifs[int(rng.integers(n_motifs))]
            off = np.array([bx * block_m, by * block_m, 0.0])
            xyz.append(pos + off + rng.normal(0, motif_jitter_m, pos.shape))
            labels.append(lab)
            yaws.append(yaw)
            sizes.append(size)
            u = unique_per_block
            if u:
                xyz.append(
                    np.column_stack(
                        [
                            rng.uniform(4.0, block_m - 4.0, u),
                            rng.uniform(4.0, block_m - 4.0, u),
                            rng.uniform(0.5, 3.0, u),
                        ]
                    )
                    + off
                )
                labels.append(rng.choice(NODE_LABELS, size=u, p=p_label))
                yaws.append(rng.uniform(0.0, np.pi, u))
                sizes.append(
                    np.column_stack([rng.uniform(3.0, 8.0, u), rng.uniform(2.5, 6.0, u)])
                )
    xyz = np.concatenate(xyz).astype(np.float32)
    labels = np.concatenate(labels)
    yaws = np.concatenate(yaws).astype(np.float32)
    sizes = np.concatenate(sizes).astype(np.float32)

    # Serpentine trajectory along the horizontal street lines y = by*block_m.
    way = []
    for by in range(gy):
        y = by * block_m
        xs = (0.0, gx * block_m) if by % 2 == 0 else (gx * block_m, 0.0)
        way.append((xs[0], y))
        way.append((xs[1], y))
    way = np.asarray(way, dtype=np.float64)
    seg = np.diff(way, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = cum[-1]

    def pose_at(s: float, lateral: float = 0.0, dyaw: float = 0.0):
        s = np.clip(s, 0.0, total - 1e-6)
        i = int(np.searchsorted(cum, s, side="right") - 1)
        i = min(i, len(seg) - 1)
        t = (s - cum[i]) / max(seg_len[i], 1e-9)
        p = way[i] + t * seg[i]
        yaw = np.arctan2(seg[i][1], seg[i][0])
        n = np.array([-np.sin(yaw), np.cos(yaw)])
        p = p + lateral * n
        return _pose_2d(p[0], p[1], yaw + dyaw)

    map_poses = np.stack(
        [pose_at(s) for s in np.linspace(0, total, num_map_frames, endpoint=False)]
    )
    query_poses = np.stack(
        [
            pose_at(
                rng.uniform(0, total),
                lateral=rng.normal(0, query_offset_m),
                dyaw=rng.normal(0, query_heading_sd),
            )
            for _ in range(num_queries)
        ]
    )
    return HardWorld(
        instance_xyz=xyz,
        instance_label=labels,
        map_poses=map_poses,
        query_poses=query_poses,
        instance_yaw=yaws,
        instance_size=sizes,
    )


def _pad_cloud(cloud: np.ndarray, max_points: int):
    """Thin with a fixed stride past ``max_points``, then pad with a mask."""
    if len(cloud) > max_points:
        stride = -(-len(cloud) // max_points)
        cloud = cloud[::stride]
    out = np.zeros((max_points, 3), np.float32)
    mask = np.zeros(max_points, bool)
    out[: len(cloud)] = cloud
    mask[: len(cloud)] = True
    return out, mask


def render_planar_cloud(
    world: SyntheticWorld,
    pose: np.ndarray,
    rng: np.random.Generator,
    max_points: int = 4096,
    points_per_instance: int = 48,
    view_radius_m: float = 50.0,
    noise_m: float = 0.02,
):
    """A LiDAR-like cloud sampled from the world's fixed surfaces: points on
    each visible instance's vertical panel plus a ground plane, in the
    sensor frame, with Gaussian noise. Map and query renders sample the
    same geometry, so registration has a true optimum. Returns
    (points (max_points, 3) float32, mask (max_points,) bool)."""
    Tinv = np.linalg.inv(pose)
    local = (world.instance_xyz @ Tinv[:3, :3].T) + Tinv[:3, 3]
    vis = np.nonzero(np.linalg.norm(local[:, :2], axis=1) < view_radius_m)[0]
    pts_w = []
    for i in vis:
        c = world.instance_xyz[i]
        yaw = float(world.instance_yaw[i])
        w, h = world.instance_size[i]
        d = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        u = rng.uniform(-0.5 * w, 0.5 * w, points_per_instance)
        v = rng.uniform(0.0, h, points_per_instance)
        p = c[None, :] + u[:, None] * d[None, :]
        p[:, 2] = v
        pts_w.append(p)
    n_ground = max_points // 4
    g_local = np.column_stack(
        [
            rng.uniform(-view_radius_m, view_radius_m, n_ground),
            rng.uniform(-view_radius_m, view_radius_m, n_ground),
            np.zeros(n_ground),
        ]
    )
    g_world = (g_local @ pose[:3, :3].T) + pose[:3, 3]
    g_world[:, 2] = 0.0
    pts_w.append(g_world)
    cloud_w = np.concatenate(pts_w)
    cloud = (cloud_w @ Tinv[:3, :3].T) + Tinv[:3, 3]
    cloud = (cloud + rng.normal(0, noise_m, cloud.shape)).astype(np.float32)
    return _pad_cloud(cloud, max_points)


def render_cloud(
    world: SyntheticWorld,
    pose: np.ndarray,
    rng: np.random.Generator,
    max_points: int = 4096,
    points_per_instance: int = 60,
    view_radius_m: float = 50.0,
    noise_m: float = 0.03,
):
    """A structured cloud of vertical blobs around the visible instances plus
    ground points, in the sensor frame (the legacy GICP test input).
    Returns (points (max_points, 3) float32, mask (max_points,) bool)."""
    Tinv = np.linalg.inv(pose)
    local = (world.instance_xyz @ Tinv[:3, :3].T) + Tinv[:3, 3]
    vis = np.linalg.norm(local[:, :2], axis=1) < view_radius_m
    pts = []
    for c in local[vis]:
        k = points_per_instance
        pts.append(
            np.column_stack(
                [
                    c[0] + rng.normal(0, 0.15, k),
                    c[1] + rng.normal(0, 0.15, k),
                    rng.uniform(0, max(c[2] * 2, 1.0), k),
                ]
            )
        )
    n_ground = max_points // 3
    pts.append(
        np.column_stack(
            [
                rng.uniform(-view_radius_m, view_radius_m, n_ground),
                rng.uniform(-view_radius_m, view_radius_m, n_ground),
                rng.normal(0, noise_m, n_ground),
            ]
        )
    )
    cloud = np.concatenate(pts).astype(np.float32)
    cloud += rng.normal(0, noise_m, cloud.shape)
    return _pad_cloud(cloud, max_points)
