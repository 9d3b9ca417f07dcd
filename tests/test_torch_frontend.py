"""The port's front end against sgtd_tpu's on the same seeded inputs, on the
CPU: DCVC (``cluster.dcvc``), the graph builder (``graph.build``), local
maps (``graph.local_map``), the fixed-shape ``voxel_downsample`` and the
CLI's ``build-map`` from files, then the port's ``localize`` on the graphs
it wrote.

Integers (cluster slots, voxel coordinates, node labels and masks) are
equal, and so are the floats, bit for bit: the port follows the float32
arithmetic that XLA:CPU compiles for the reference (glibc's ``atan2f`` for
``arcsin`` and ``arctan2``, FMA sums of squares, the tree-reduction order
of the whole-class sums, segment sums in point order). Where a voxel
coordinate's quotient lies within 2 ulp of a rounding edge, the tests
print how many points do, so that a future flip shows.
"""

import contextlib
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtd_tpu import cli as jax_cli
from sgtd_tpu.cluster import dcvc as jdcvc
from sgtd_tpu.config import CapacityConfig as JCaps
from sgtd_tpu.config import DcvcConfig as JDcvc
from sgtd_tpu.graph import build as jbuild
from sgtd_tpu.graph import local_map as jlocal
from sgtd_tpu.io.readers import LEARNING_MAP, write_bin, write_label
from sgtd_tpu.ops import voxel as jvoxel
from sgtd_tpu_torch import cli, interop
from sgtd_tpu_torch.cluster import dcvc
from sgtd_tpu_torch.config import CapacityConfig, DcvcConfig
from sgtd_tpu_torch.data.synthetic import make_world
from sgtd_tpu_torch.graph import build, local_map
from sgtd_tpu_torch.ops import voxel
from sgtd_tpu_torch.utils import fma_f32, profiling, sq_norm_fma, sqrt_rn

torch.set_num_threads(1)

SMALL = dict(max_points=4096, max_voxels=4096, max_clusters=32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_same(got, want, name=""):
    """Equal values, dtypes and shapes (floats bit for bit)."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(got, want), (name, int((got != want).sum()))


def _pad(pts, n_max):
    pts = np.asarray(pts, np.float32)
    out = np.zeros((n_max, 3), np.float32)
    out[: len(pts)] = pts
    mask = np.zeros(n_max, bool)
    mask[: len(pts)] = True
    return out, mask


def _blob(rng, center, n, spread=0.3):
    return np.asarray(center) + rng.normal(0, spread, (n, 3))


def _dcvc_cloud(name):
    """The clouds of tests/test_cluster_graph.py, plus components of equal
    point counts (ties in the cluster-slot order) and a scan-like cloud with
    per-point groups and thresholds: (points, mask, min_seg, group)."""
    rng = np.random.default_rng(11)
    if name == "blobs":
        return (*_pad(np.concatenate([_blob(rng, [10, 0, 0], 200), _blob(rng, [-10, 5, 0], 150)]), 1024), 50, None)
    if name.startswith("min_seg"):
        pts = np.concatenate([_blob(rng, [10, 0, 0], 200), _blob(rng, [-10, 5, 1], 20)])
        return (*_pad(pts, 1024), 50 if name == "min_seg_50" else 5, None)
    if name == "range_gates":
        return (*_pad(np.concatenate([_blob(rng, [150, 0, 0], 100, 0.1), rng.normal(0, 0.1, (100, 3))]), 512), 10, None)
    if name == "azimuth_wrap":
        ang = np.deg2rad(rng.uniform(-2, 2, 150))
        r = rng.uniform(19.5, 20.5, 150)
        return (*_pad(np.column_stack([r * np.cos(ang), r * np.sin(ang), rng.normal(0, 0.2, 150)]), 512), 50, None)
    if name == "equal_counts":
        # Eight components of exactly 60 points (tight, one voxel's
        # neighbourhood each) and four of 40: slots are decided by ties.
        cents = [[8 * np.cos(a), 8 * np.sin(a), 0.5] for a in np.linspace(0, 2 * np.pi, 12, endpoint=False)]
        pts = np.concatenate([_blob(rng, c, 60 if i < 8 else 40, 0.02) for i, c in enumerate(cents)])
        return (*_pad(pts, 1024), 5, None)
    assert name == "scan"
    k = 1500
    ang, rr = rng.uniform(0, 2 * np.pi, k), rng.uniform(1, 60, k)
    clouds = [np.column_stack([rr * np.cos(ang), rr * np.sin(ang), rng.normal(-1.7, 0.05, k)])]
    clouds += [_blob(rng, np.r_[rng.uniform(-40, 40, 2), rng.uniform(-1, 3)], 75, 0.4) for _ in range(20)]
    pts, mask = _pad(np.concatenate(clouds), 4096)
    group = rng.integers(0, 20, 4096).astype(np.int32)
    min_seg = np.where(group % 3 == 0, 5.0, 30.0).astype(np.float32)
    return pts, mask, min_seg, group


DCVC_CASES = ["blobs", "min_seg_50", "min_seg_5", "range_gates", "azimuth_wrap", "equal_counts", "scan"]


def _near_edges(points, mask, cfg) -> dict:
    """Points whose pitch or azimuth quotient lies within 2 ulp of a
    rounding edge (k + 0.5), or whose range lies within 2 ulp of a radial
    bound, in the port's arithmetic."""
    p = torch.from_numpy(points)
    x, y, z = p.unbind(-1)
    az_idx, polar, pitch_idx, ok, _ = dcvc._voxel_coords(p, torch.from_numpy(mask), DcvcConfig(**cfg))
    r = sqrt_rn(sq_norm_fma(p))
    asin = dcvc.asinf((z / r.clamp(min=1e-6)).clamp(-1, 1))
    big = torch.full_like(r, 1e9)
    off = fma_f32(asin, torch.full_like(asin, dcvc._RAD2DEG),
                  -torch.where(ok, asin * dcvc._RAD2DEG, big).min().expand_as(asin))
    az = dcvc.atan2f(y, x) * dcvc._RAD2DEG
    az = torch.where(az < 0, az + 360.0, az)

    def ulp(q):
        return torch.nextafter(q.abs(), torch.full_like(q, np.inf)) - q.abs()

    def edge(q):
        return int((ok & ((q - torch.floor(q) - 0.5).abs() <= 2 * ulp(q))).sum())

    ks = torch.arange(1, 513, dtype=torch.float32)
    min_polar = torch.where(ok, r, big).min()
    bounds = fma_f32(ks, torch.full_like(ks, 0.35), min_polar.expand_as(ks)) - ks * 0.0004 * (ks + 1.0) * 0.5
    i = torch.searchsorted(bounds, r).clamp(1, 511)
    gap = torch.minimum((r - bounds[i]).abs(), (r - bounds[i - 1]).abs())
    inv = float(np.float32(1) / np.float32(1.2))
    return {"pitch": edge(off * inv), "azimuth": edge(az * inv), "polar": int((ok & (gap <= 2 * ulp(r))).sum())}


@pytest.mark.parametrize("name", DCVC_CASES)
def test_dcvc_equals_reference(name):
    points, mask, min_seg, group = _dcvc_cloud(name)
    want = jdcvc.dcvc_cluster(jnp.asarray(points), jnp.asarray(mask),
                              jnp.asarray(min_seg) if isinstance(min_seg, np.ndarray) else min_seg, JDcvc(**SMALL),
                              None if group is None else jnp.asarray(group))
    tracer = profiling.enable()
    try:
        got = dcvc.dcvc_cluster(_t(points), _t(mask), _t(min_seg) if isinstance(min_seg, np.ndarray) else min_seg,
                                DcvcConfig(**SMALL), None if group is None else _t(group))
    finally:
        profiling.disable()
    for f in dcvc.ClusterResult._fields:
        _assert_same(getattr(got, f), getattr(want, f), f)
    assert all(torch.equal(a, b) for a, b in zip(interop.cluster_result_from_numpy(want, "cpu"), got))
    (sweeps,) = [v for _, v in tracer.counters["dcvc.sweeps"]]
    assert sweeps >= 1
    if name == "equal_counts":
        assert got.counts[got.valid].tolist() == [60] * 8 + [40] * 4
    # The voxel coordinates themselves, against the reference's as one
    # compiled program (run op by op, XLA fuses no multiply-add: another
    # result on points near an edge).
    ref = jax.jit(functools.partial(jdcvc._voxel_coords, cfg=JDcvc(**SMALL)))(jnp.asarray(points), jnp.asarray(mask))
    port = dcvc._voxel_coords(_t(points), _t(mask), DcvcConfig(**SMALL))
    for label, a, b in zip(("azimuth", "polar", "pitch", "ok"), port[:4], ref[:4]):
        _assert_same(a, b, label)
    print(f"{name}: {int(mask.sum())} points, near a rounding edge: {_near_edges(points, mask, SMALL)}")


def test_dcvc_full_width_scan():
    """A rendered HDL-64-sized scan (chip_smoke.py phase 9's first map
    keyframe) at the default widths, classes as groups."""
    import chip_smoke

    world = chip_smoke.front_world()
    pts, sem, *_ = chip_smoke.render_labeled_scan(world, world.map_poses[0], (chip_smoke.FRONT_SEED, 0))
    points, mask = _pad(pts, 131072)
    group = np.zeros(131072, np.int32)
    group[: len(sem)] = sem
    want = jdcvc.dcvc_cluster(jnp.asarray(points), jnp.asarray(mask), 300, JDcvc(), jnp.asarray(group))
    got = dcvc.dcvc_cluster(_t(points), _t(mask), 300, DcvcConfig(), _t(group))
    for f in dcvc.ClusterResult._fields:
        _assert_same(getattr(got, f), getattr(want, f), f)
    assert int(got.valid.sum()) > 50
    print(f"full width: {int(mask.sum())} points, near a rounding edge: {_near_edges(points, mask, {})}")


def test_libm_emulation_equals_xla():
    """``atan2f`` and ``asinf`` give the bits of the reference's
    ``jnp.arctan2`` and ``jnp.arcsin`` on XLA:CPU, all quadrants, axes and
    zeros included."""
    rng = np.random.default_rng(5)
    y = np.concatenate([rng.normal(0, 10, 20000), rng.uniform(-1e-3, 1e-3, 2000), [0.0, -0.0, 0.0, -0.0, 3.0, -3.0],
                        rng.normal(0, 1e8, 500)]).astype(np.float32)
    x = np.concatenate([rng.normal(0, 10, 20000), rng.uniform(-1, 1, 2000), [1.0, 1.0, -1.0, -1.0, 0.0, 0.0],
                        rng.normal(0, 1e-6, 500)]).astype(np.float32)
    _assert_same(dcvc.atan2f(_t(y), _t(x)), jax.jit(jnp.arctan2)(y, x), "atan2")
    s = np.concatenate([rng.uniform(-1, 1, 20000), rng.normal(0, 1e-3, 2000), [-1.0, 1.0, 0.0, -0.0]]).astype(np.float32)
    _assert_same(dcvc.asinf(_t(s)), jax.jit(jnp.arcsin)(s), "arcsin")


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1001, 3000, 40007])
def test_row_sum_order_equals_xla(n):
    rng = np.random.default_rng(n)
    for x in (rng.normal(0, 30, (n, 3)).astype(np.float32), rng.normal(0, 30, n).astype(np.float32)):
        _assert_same(build._xla_row_sum(_t(x)), jax.jit(lambda v: jnp.sum(v, axis=0))(x), f"sum of {x.shape}")


def _routing_scene(kind: str, n_max: int):
    """tests/test_cluster_graph.py's scenes: ``mulran`` (sidewalk kept whole,
    DCVC poles, a dropped car, a building split by GT instance ids, one
    instance too small) and ``wild`` (dirt whole, a trunk, foliage
    dropped)."""
    rng = np.random.default_rng(42)
    clouds, sems, insts = [], [], []

    def add(p, s, i=0):
        clouds.append(p)
        sems.append(np.full(len(p), s))
        insts.append(np.full(len(p), i))

    ground = lambda k, e: np.column_stack([rng.uniform(-e, e, k), rng.uniform(-e, e, k), rng.normal(0, 0.05, k)])  # noqa: E731
    if kind == "mulran":
        add(ground(400, 30), 10)
        for c in ([12.0, 3.0, 1.0], [-8.0, -15.0, 1.0]):
            add(_blob(rng, c, 30, 0.15), 17)
        add(_blob(rng, [5.0, 5.0, 0.5], 100, 0.4), 0)
        add(_blob(rng, [20.0, -10.0, 3.0], 60, 1.0), 12, 7)
        add(_blob(rng, [-25.0, 8.0, 3.0], 10, 1.0), 12, 9)
        for k in range(6):  # more DCVC clusters, for the compaction case
            add(_blob(rng, [30 * np.cos(k), 30 * np.sin(k), 2.0], 40, 0.2), 15)
    else:
        add(ground(300, 20), 1)
        add(_blob(rng, [8.0, 3.0, 1.0], 150, 0.2), 12)
        add(_blob(rng, [-6.0, 5.0, 4.0], 200, 0.5), 11)
    pts = np.concatenate(clouds).astype(np.float32)
    points, mask = _pad(pts, n_max)
    sem = np.zeros(n_max, np.int32)
    sem[: len(pts)] = np.concatenate(sems)
    inst = np.zeros(n_max, np.int32)
    inst[: len(pts)] = np.concatenate(insts)
    return points, sem, inst, mask


@pytest.mark.parametrize("kind,max_nodes,n_max", [("mulran", 64, 2048), ("mulran", 3, 2048), ("wild", 64, 2048),
                                                   ("wild", 64, 1000)])
def test_build_graph_equals_reference(kind, max_nodes, n_max):
    """GT-instance, DCVC and whole-kept branches under both routings, and
    the compaction past ``max_nodes``."""
    points, sem, inst, mask = _routing_scene(kind, n_max)
    routing = build.WILD_ROUTING if kind == "wild" else build.MULRAN_ROUTING
    assert interop.routing_from_reference(jbuild.WILD_ROUTING if kind == "wild" else jbuild.MULRAN_ROUTING) == routing
    dkw = dict(max_points=n_max, max_voxels=n_max, max_clusters=16 if kind == "wild" else 32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.0, 2.0, 0.5]
    want = jbuild.build_graph(*(jnp.asarray(a) for a in (points, sem, inst, mask)), pose, JCaps(max_nodes=max_nodes),
                              JDcvc(**dkw), jbuild.WILD_ROUTING if kind == "wild" else jbuild.MULRAN_ROUTING)
    got = build.build_graph(*(_t(a) for a in (points, sem, inst, mask)), pose, CapacityConfig(max_nodes=max_nodes),
                            DcvcConfig(**dkw), routing)
    for f in got._fields:
        _assert_same(getattr(got, f), getattr(want, f), f)
    n_nodes = int(got.mask.sum())
    assert n_nodes == min(max_nodes, {"mulran": 10, "wild": 2}[kind])
    assert (build.WHOLE_CLASSES, build.INSTANCE_CLASSES, build.NODE_MAP) == (
        jbuild.WHOLE_CLASSES, jbuild.INSTANCE_CLASSES, jbuild.NODE_MAP)


def _poses_line(n, spacing):
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, 0, 3] = np.arange(n) * spacing
    return poses


def test_local_map_equals_reference():
    """tests/test_local_map.py's pole, seen by three scans 5 m apart: the
    neighbours, the merged cloud and the graphs at radii 0.1 m and 15 m."""
    poses = _poses_line(3, 5.0)
    pole = np.array([7.0, 3.0, 1.0])
    rng = np.random.default_rng(3)
    scans = []
    for j in range(3):
        T_inv = np.linalg.inv(poses[j])
        scans.append(((pole @ T_inv[:3, :3].T + T_inv[:3, 3] + rng.normal(0, 0.05, (3, 3))).astype(np.float32),
                      np.full(3, 17, np.int32), np.zeros(3, np.int32)))
    load = scans.__getitem__
    np.testing.assert_array_equal(local_map.neighbor_indices(poses, 1, 15.0), jlocal.neighbor_indices(poses, 1, 15.0))
    for a, b in zip(local_map.merge_scans(load, poses, 1, [0, 1, 2], 64, 2), jlocal.merge_scans(load, poses, 1, [0, 1, 2], 64, 2)):
        _assert_same(a, b)
    caps, dkw = CapacityConfig(max_nodes=32), dict(max_points=2048, max_voxels=2048, max_clusters=16)
    for radius, n_nodes in ((0.1, 0), (15.0, 1)):
        want = jlocal.build_local_map_graphs(load, poses, radius, JCaps(max_nodes=32), JDcvc(**dkw), keyframe_ids=[1, 2])
        got = local_map.build_local_map_graphs(load, poses, radius, caps, DcvcConfig(**dkw), keyframe_ids=[1, 2],
                                               device="cpu")
        for g, w in zip(got, want):
            for f in g._fields:
                _assert_same(getattr(g, f), getattr(w, f), f)
        assert int(got[0].mask.sum()) == n_nodes


@pytest.mark.parametrize("max_out", [1024, 40])
def test_voxel_downsample_equals_reference(max_out):
    rng = np.random.default_rng(9)
    pts = rng.uniform(-10, 10, (1024, 3)).astype(np.float32)
    mask = np.ones(1024, bool)
    mask[1000:] = False
    want = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 1.5, max_out)
    got = voxel.voxel_downsample(_t(pts), _t(mask), 1.5, max_out)
    for a, b in zip(got, want):
        _assert_same(a, b)
    assert int(got[1].sum()) == min(max_out, len(voxel.voxel_downsample_np(pts[mask], 1.5)))


# --- build-map from files -------------------------------------------------

# Raw SemanticKITTI labels of the reference's train classes 10-18.
_RAW_OF_TRAIN = {v - 1: k for k, v in sorted(LEARNING_MAP.items(), reverse=True) if v > 0}


def _render_labeled(world, pose, rng, gt_ids: bool, ppi=40, n_ground=400, view_radius=50.0):
    """tests/test_cli.py:103-130's renderer: instance blobs (train class
    ``min(label, 11) + 7``, GT instance ids or none) and a sidewalk sheet."""
    Tinv = np.linalg.inv(pose)
    local = world.instance_xyz @ Tinv[:3, :3].T + Tinv[:3, 3]
    vis = np.where(np.linalg.norm(local[:, :2], axis=1) < view_radius)[0]
    pts = [local[j] + rng.normal(0, 0.15, (ppi, 3)) for j in vis]
    sem = [np.full(ppi, min(int(world.instance_label[j]), 11) + 7) for j in vis]
    inst = [np.full(ppi, j + 1 if gt_ids else 0) for j in vis]
    pts.append(np.column_stack([rng.uniform(-view_radius, view_radius, (n_ground, 2)), rng.normal(0, 0.03, n_ground)]))
    sem.append(np.full(n_ground, 10))
    inst.append(np.zeros(n_ground))
    return np.concatenate(pts).astype(np.float32), np.concatenate(sem), np.concatenate(inst)


@pytest.fixture(scope="module")
def scan_files(tmp_path_factory):
    """Labeled scans of a small world (tests/test_cli.py's: 8 map keyframes
    and 2 queries; GT instance ids on even map scans) in the layouts of the
    ``raw``, ``kitti`` (raw SemanticKITTI labels), ``wild`` (3-float .bin,
    Wild-Places classes) and ``mulran`` (scans named by nanosecond stamps)
    profiles, with KITTI-layout poses, a calib file, and MulRan poses in
    UTM (the KAIST offset added)."""
    root = tmp_path_factory.mktemp("frontend")
    rng = np.random.default_rng(3)
    world = make_world(rng, extent_m=150.0, instances_per_100m2=0.5, num_map_frames=8, num_queries=2,
                       query_offset_m=2.0)
    dirs = {}
    for side, poses in (("map", world.map_poses), ("query", world.query_poses)):
        for layout in ("raw", "kitti", "wild", "mulran"):
            for kind in ("scans", "labels"):
                dirs[side, layout, kind] = str(root / f"{side}_{layout}_{kind}")
                os.makedirs(dirs[side, layout, kind])
        for i, p in enumerate(poses):
            pts, sem, inst = _render_labeled(world, p, rng, gt_ids=side == "map" and i % 2 == 0)
            name = f"{i:06d}"
            write_bin(os.path.join(dirs[side, "raw", "scans"], name + ".bin"), pts)
            write_label(os.path.join(dirs[side, "raw", "labels"], name + ".label"), sem, inst)
            write_bin(os.path.join(dirs[side, "kitti", "scans"], name + ".bin"), pts)
            write_label(os.path.join(dirs[side, "kitti", "labels"], name + ".label"),
                        np.vectorize(_RAW_OF_TRAIN.get)(sem), inst)
            pts.tofile(os.path.join(dirs[side, "wild", "scans"], name + ".bin"))
            write_label(os.path.join(dirs[side, "wild", "labels"], name + ".label"),
                        np.where(sem == 10, 1, sem - 7), inst)
            stamp = f"{1566279000000000000 + 100_000_000 * i + 7}"  # scans 7 ns after their poses
            write_bin(os.path.join(dirs[side, "mulran", "scans"], stamp + ".bin"), pts)
            write_label(os.path.join(dirs[side, "mulran", "labels"], stamp + ".label"), sem, inst)
        dirs[side, "poses"] = str(root / f"{side}_poses.txt")
        np.savetxt(dirs[side, "poses"], poses[:, :3, :].reshape(len(poses), 12))
        utm = poses.astype(np.float64)
        utm[:, :3, 3] += (353050.0, 4026791.0, 19.0)
        dirs[side, "mulran_poses"] = str(root / f"{side}_mulran_poses.csv")
        with open(dirs[side, "mulran_poses"], "w") as f:
            for i, T in enumerate(utm):
                f.write(f"{1566279000000000000 + 100_000_000 * i}," + ",".join(repr(float(v)) for v in T[:3].ravel()) + "\n")
    dirs["calib"] = str(root / "calib.txt")
    with open(dirs["calib"], "w") as f:
        f.write("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: 0 -1 0 0.1 0 0 -1 -0.05 1 0 0 -0.3\n")
    return root, dirs


def _graph_files(directory):
    return {f: open(os.path.join(directory, f)).read() for f in sorted(os.listdir(directory))}


@pytest.mark.parametrize("layout,extra", [
    ("raw", []), ("raw", ["--label-corrupt-rate", "0.05"]), ("kitti", ["--calib", "CALIB"]), ("wild", []),
    ("mulran", ["--sequence", "KAIST03"]), ("raw", ["--local-map-radius", "15"]),
])
def test_build_map_equals_reference(scan_files, tmp_path, layout, extra):
    """The port's build-map writes the reference CLI's files, byte for byte,
    under every ``--dataset`` profile and ``--local-map-radius``."""
    _, dirs = scan_files
    poses = dirs["map", "mulran_poses" if layout == "mulran" else "poses"]
    extra = [dirs["calib"] if a == "CALIB" else a for a in extra]
    args = ["build-map", "--scans", dirs["map", layout, "scans"], "--labels", dirs["map", layout, "labels"],
            "--dataset", layout, "--poses", poses, *extra]
    with contextlib.redirect_stdout(io.StringIO()):
        jax_cli.main(args + ["--out", str(tmp_path / "ref")])
        cli.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    want, got = _graph_files(tmp_path / "ref"), _graph_files(tmp_path / "port")
    assert list(got) == sorted(os.path.splitext(f)[0] + ".json" for f in os.listdir(dirs["map", layout, "scans"]))
    assert got == want
    assert sum(len(json.loads(v)["nodes"]) for v in got.values()) > 40


def test_build_map_then_localize(scan_files, tmp_path):
    """The port's build-map on map and query scans, then the port's
    localize on the graphs it wrote: every query found (tests/test_cli.py's
    round trip)."""
    _, dirs = scan_files
    for side in ("map", "query"):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["build-map", "--scans", dirs[side, "raw", "scans"], "--labels", dirs[side, "raw", "labels"],
                      "--dataset", "raw", "--poses", dirs[side, "poses"], "--out", str(tmp_path / side),
                      "--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["localize", "--map-graphs", str(tmp_path / "map"), "--query-graphs", str(tmp_path / "query"),
                  "--batch-size", "2", "--device", "cpu"])
    out = json.loads(buf.getvalue())
    assert out["total"] == 2 and out["success_rate"] == 1.0 and out["recall_at_1"] == 1.0, out


def test_build_map_rejects_bad_inputs(scan_files, tmp_path):
    _, dirs = scan_files
    base = ["build-map", "--scans", dirs["map", "raw", "scans"], "--out", str(tmp_path), "--device", "cpu"]
    with pytest.raises(SystemExit, match="requires --poses"):
        cli.main(base + ["--labels", dirs["map", "raw", "labels"], "--local-map-radius", "10"])
    with pytest.raises(SystemExit, match=".label files"):
        cli.main(base + ["--labels", str(tmp_path)])


# --- the stored reference of chip_smoke.py phase 9 --------------------------


def reference_frontend_graphs() -> dict:
    """The JAX reference's graphs (sgtd_tpu's build_graph on the CPU, as its
    CLI builds them) of chip_smoke.py's phase-9 map keyframes
    ``FRONT_REF_FRAMES``: padded labels and mask, the valid nodes' centres
    and densities."""
    import chip_smoke

    world = chip_smoke.front_world()
    out = {"frames": list(chip_smoke.FRONT_REF_FRAMES), "graphs": []}
    for i in chip_smoke.FRONT_REF_FRAMES:
        pts, sem, inst, *_ = chip_smoke.render_labeled_scan(world, world.map_poses[i], (chip_smoke.FRONT_SEED, i))
        points, mask = _pad(pts, 131072)
        s = np.zeros(131072, np.int32)
        s[: len(sem)] = sem
        g = jbuild.build_graph(jnp.asarray(points), jnp.asarray(s), jnp.zeros(131072, jnp.int32), jnp.asarray(mask),
                               world.map_poses[i].astype(np.float32))
        m = np.asarray(g.mask)
        out["graphs"].append({
            "labels": np.asarray(g.labels).tolist(), "mask": m.astype(int).tolist(),
            "centers": [[float(v) for v in row] for row in np.asarray(g.centers)[m]],
            "density": [float(v) for v in np.asarray(g.density)[m]],
        })
    return out


def test_reference_frontend_graphs():
    """``tests/data/frontend_reference.json``, which chip_smoke.py phase 9
    holds the card's graphs to, is what sgtd_tpu computes on the CPU; and
    the port on the CPU gives the same graphs, bit for bit."""
    import chip_smoke

    want = reference_frontend_graphs()
    with open(chip_smoke.FRONT_REF_FILE) as f:
        assert json.load(f) == want
    world = chip_smoke.front_world()
    i, ref = chip_smoke.FRONT_REF_FRAMES[1], want["graphs"][1]
    pts, sem, *_ = chip_smoke.render_labeled_scan(world, world.map_poses[i], (chip_smoke.FRONT_SEED, i))
    points, mask = _pad(pts, 131072)
    s = np.zeros(131072, np.int32)
    s[: len(sem)] = sem
    g = build.build_graph(_t(points), _t(s), torch.zeros(131072, dtype=torch.int32), _t(mask), world.map_poses[i])
    m = g.mask.numpy()
    assert g.labels.tolist() == ref["labels"] and m.astype(int).tolist() == ref["mask"]
    assert g.centers.numpy()[m].tolist() == np.asarray(ref["centers"], np.float32).tolist()
    assert g.density.numpy()[m].tolist() == np.asarray(ref["density"], np.float32).tolist()
