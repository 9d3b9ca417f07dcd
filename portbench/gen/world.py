"""The benchmark's inputs: a frozen NumPy copy of the port's synthetic
world (``sgtd_tpu_torch/data/synthetic.py``: ``make_world``, ``observe``,
``render_planar_cloud``), of the padded graph layout (``make_graph``) and of
the query-cloud preprocessing (``ops/voxel.load_query_cloud``).

Draw for draw the same random stream as the program's generator, so one
seed gives the same graphs and clouds (a CPU test holds the two equal);
kept here so that a later change to the program's generator cannot move
the yardstick. Everything is host NumPy; nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np

# Remapped node labels 3..12 with urban instance frequencies.
NODE_LABELS = np.arange(3, 13)
LABEL_WEIGHTS = np.array([0.08, 0.05, 0.30, 0.08, 0.02, 0.12, 0.05, 0.20, 0.08, 0.02])


class Graph(NamedTuple):
    """One keyframe's padded semantic graph (the program's SemanticGraph
    fields, NumPy): centers (N, 3) float32, labels (N,) int32, density (N,)
    float32, mask (N,) bool, pose (4, 4) float32."""

    centers: np.ndarray
    labels: np.ndarray
    density: np.ndarray
    mask: np.ndarray
    pose: np.ndarray


@dataclasses.dataclass
class World:
    instance_xyz: np.ndarray  # (M, 3)
    instance_label: np.ndarray  # (M,)
    map_poses: np.ndarray  # (F, 4, 4)
    query_poses: np.ndarray  # (Q, 4, 4)
    instance_yaw: np.ndarray  # (M,)
    instance_size: np.ndarray  # (M, 2)


def _pose_2d(x: float, y: float, yaw: float, z: float = 0.0) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    T[:3, 3] = (x, y, z)
    return T


def make_world(rng, extent_m=400.0, instances_per_100m2=1.2, num_map_frames=50, num_queries=20,
               keyframe_spacing_m=8.0, query_offset_m=3.0) -> World:
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
    sizes = np.column_stack([rng.uniform(3.0, 8.0, m), rng.uniform(2.5, 6.0, m)]).astype(np.float32)

    r = extent_m / 3.0
    thetas = np.linspace(0, 2 * np.pi, num_map_frames, endpoint=False)
    map_poses = np.stack([_pose_2d(r * np.cos(t), r * np.sin(t), t + np.pi / 2) for t in thetas])
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
    return World(xyz, labels, map_poses, query_poses, yaws, sizes)


def make_graph(centers, labels, pose, max_nodes: int) -> Graph:
    """Padded graph; more than ``max_nodes`` nodes keep the nearest, in
    their original order. Density is zero (the synthetic world has none)."""
    centers = np.asarray(centers, dtype=np.float32).reshape(-1, 3)
    labels = np.asarray(labels, dtype=np.int32).reshape(-1)
    n = centers.shape[0]
    if n > max_nodes:
        order = np.sort(np.argsort(np.linalg.norm(centers, axis=1), kind="stable")[:max_nodes])
        centers, labels = centers[order], labels[order]
        n = max_nodes
    pad = max_nodes - n
    mask = np.zeros(max_nodes, dtype=bool)
    mask[:n] = True
    return Graph(
        centers=np.pad(centers, ((0, pad), (0, 0))),
        labels=np.pad(labels, (0, pad)),
        density=np.zeros(max_nodes, dtype=np.float32),
        mask=mask,
        pose=np.asarray(pose, dtype=np.float32).reshape(4, 4),
    )


def observe(world: World, pose, max_nodes: int, rng, view_radius_m=50.0, center_noise_m=0.05,
            dropout=0.0, label_corrupt_rate=0.0) -> Graph:
    """The semantic graph a sensor at ``pose`` would produce."""
    Tinv = np.linalg.inv(pose)
    local = (world.instance_xyz @ Tinv[:3, :3].T) + Tinv[:3, 3]
    vis = np.linalg.norm(local[:, :2], axis=1) < view_radius_m
    if dropout > 0:
        vis &= rng.uniform(size=vis.shape) > dropout
    centers = local[vis] + rng.normal(0, center_noise_m, (int(vis.sum()), 3))
    labels = world.instance_label[vis].copy()
    if label_corrupt_rate > 0:
        bad = rng.uniform(size=labels.shape) < label_corrupt_rate
        labels[bad] = rng.choice(NODE_LABELS, size=int(bad.sum()))
    return make_graph(centers.astype(np.float32), labels, pose, max_nodes)


def make_map_and_queries(seed, num_map: int, num_queries: int, extent_m: float, max_nodes: int,
                         map_obs: dict, query_obs: dict) -> Tuple[List[Graph], List[Graph], World]:
    """Map keyframe graphs, query graphs and the world: the program's
    ``make_map_and_queries`` (and, with ``extent_m`` and ``map_obs`` set,
    the large-map world of ``tools/scale_bench.py``), one random stream."""
    rng = np.random.default_rng(seed_of(seed))
    world = make_world(rng, extent_m=extent_m, num_map_frames=num_map, num_queries=num_queries)
    maps = [observe(world, p, max_nodes, rng, **map_obs) for p in world.map_poses]
    queries = [observe(world, p, max_nodes, rng, **query_obs) for p in world.query_poses]
    return maps, queries, world


def _pad_cloud(cloud: np.ndarray, max_points: int):
    if len(cloud) > max_points:
        cloud = cloud[:: -(-len(cloud) // max_points)]
    out = np.zeros((max_points, 3), np.float32)
    mask = np.zeros(max_points, bool)
    out[: len(cloud)] = cloud
    mask[: len(cloud)] = True
    return out, mask


def render_planar_cloud(world: World, pose, rng, max_points=4096, points_per_instance=48,
                        view_radius_m=50.0, noise_m=0.02):
    """LiDAR-like cloud of the visible instances' vertical panels and the
    ground, in the sensor frame: (points (max_points, 3), mask)."""
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


_B = np.int64(1) << 20  # voxel coordinate offset; 21 bits an axis


def voxel_downsample(points: np.ndarray, leaf: float) -> np.ndarray:
    """Exact voxel-grid centroids, in key order."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if pts.shape[0] == 0:
        return pts
    c = np.floor(pts / leaf).astype(np.int64)
    key = ((c[:, 0] + _B) << 42) | ((c[:, 1] + _B) << 21) | (c[:, 2] + _B)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((uniq.shape[0], 3), np.float64)
    np.add.at(sums, inv, pts)
    cnt = np.bincount(inv, minlength=uniq.shape[0]).astype(np.float64)
    return (sums / cnt[:, None]).astype(np.float32)


def query_cloud(points: np.ndarray, leaf: float, max_points: int):
    """A query cloud as the reference node prepares it for GICP: drop
    near-origin points, voxel-downsample at ``leaf``, thin with a fixed
    stride past ``max_points``, pad: (cloud (max_points, 3), mask)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    pts = pts[np.sum(pts * pts, axis=1) >= 1e-3]
    if leaf > 0:
        pts = voxel_downsample(pts, leaf)
    if len(pts) > max_points:
        pts = pts[:: -(-len(pts) // max_points)][:max_points]
    out = np.zeros((max_points, 3), np.float32)
    mask = np.zeros(max_points, bool)
    out[: len(pts)] = pts
    mask[: len(pts)] = True
    return out, mask


def make_inputs(seed: int, config: dict, num_queries: int, with_clouds: bool):
    """Everything a cell hands to the program and to the reference, from
    the seed and the configuration's ``world`` block: map and query graphs,
    the world, and (``with_clouds``) keyframe clouds and prepared query
    clouds as stacked arrays."""
    w = config["world"]
    maps, queries, world = make_map_and_queries(
        seed, config["map_frames"], num_queries, w["extent_m"], w["max_nodes"], w["map_obs"], w["query_obs"]
    )
    out = {"maps": maps, "queries": queries, "world": world}
    if with_clouds:
        c = w["clouds"]
        rng = np.random.default_rng([abs(seed), int(seed < 0), c["rng_stream"]])
        mc, mm = zip(*(render_planar_cloud(world, p, rng, max_points=c["map_points"]) for p in world.map_poses))
        qc, qm = [], []
        for p in world.query_poses:
            pts, mask = render_planar_cloud(world, p, rng, max_points=c["map_points"])
            a, b = query_cloud(pts[mask], c["leaf_m"], c["query_points"])
            qc.append(a)
            qm.append(b)
        out.update(map_clouds=np.stack(mc), map_masks=np.stack(mm),
                   query_clouds=np.stack(qc), query_masks=np.stack(qm))
    return out


def seed_of(seed: int):
    """A NumPy seed for any whole number the driver passes (negative too)."""
    return seed if seed >= 0 else [-seed, 1]
