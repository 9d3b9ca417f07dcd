"""The port's file formats and native loader against sgtd_tpu's, on the
same files: scans, labels, pose tables, the SemanticKITTI remap, MulRan
UTM offsets and timestamp association, label corruption, the reference
YAML, graph JSON (bit-exact round trips, files of each package read by
the other) and the native C++ loader with its prefetcher. Every output is
required equal; no tolerance."""

import os

import numpy as np
import pytest
import torch

from sgtd_tpu.config import CapacityConfig as JaxCapacityConfig
from sgtd_tpu.config import SGTDConfig as JaxSGTDConfig
from sgtd_tpu.data.synthetic import make_map_and_queries as jax_make_map_and_queries
from sgtd_tpu.io import config_yaml as jax_config_yaml
from sgtd_tpu.io import graph_json as jax_graph_json
from sgtd_tpu.io import readers as jax_readers
from sgtd_tpu_torch import interop, native
from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.io import config_yaml, graph_json, readers

torch.set_num_threads(1)


def test_module_constants_match_reference():
    assert readers.LEARNING_MAP == jax_readers.LEARNING_MAP
    np.testing.assert_array_equal(readers._LUT, jax_readers._LUT)
    assert readers.MULRAN_UTM_OFFSETS == jax_readers.MULRAN_UTM_OFFSETS
    for name in ("MULRAN_BASE2OUSTER", "MCD_BASE2OUSTER"):
        np.testing.assert_array_equal(getattr(readers, name), getattr(jax_readers, name))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bin_and_label_files_cross_packages(tmp_path, writer):
    """write_bin / write_label of either package, read by both (.bin with
    and without intensity, the 3-float wild stride, .label halves)."""
    rng = np.random.default_rng(1)
    w = readers if writer == "port" else jax_readers
    pts = rng.normal(0, 10, (300, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, 300).astype(np.float32)
    sem = rng.integers(0, 260, 300)
    inst = rng.integers(0, 70000, 300)
    w.write_bin(str(tmp_path / "a.bin"), pts)
    w.write_bin(str(tmp_path / "b.bin"), pts, inten)
    w.write_label(str(tmp_path / "a.label"), sem, inst)
    w.write_label(str(tmp_path / "b.label"), sem)
    pts.tofile(tmp_path / "wild.bin")
    for r in (readers, jax_readers):
        a, b = r.read_bin(str(tmp_path / "a.bin")), r.read_bin(str(tmp_path / "b.bin"))
        np.testing.assert_array_equal(a[:, :3], pts)
        np.testing.assert_array_equal(a[:, 3], np.ones(300, np.float32))
        np.testing.assert_array_equal(b[:, 3], inten)
        np.testing.assert_array_equal(r.read_bin_wild(str(tmp_path / "wild.bin")), pts)
        s, i = r.read_label(str(tmp_path / "a.label"))
        np.testing.assert_array_equal(s, sem & 0xFFFF)
        np.testing.assert_array_equal(i, inst & 0xFFFF)
        s, i = r.read_label(str(tmp_path / "b.label"))
        assert s.dtype == np.int32 and not i.any()
    for f in ("a.bin", "b.bin", "wild.bin"):
        np.testing.assert_array_equal(readers.read_bin(str(tmp_path / f)), jax_readers.read_bin(str(tmp_path / f)))


def test_semantic_kitti_remap_and_label_corruption_match_reference():
    raw = np.arange(-3, 300)
    np.testing.assert_array_equal(readers.remap_semantic_kitti(raw), jax_readers.remap_semantic_kitti(raw))
    train = readers.remap_semantic_kitti(raw)
    np.testing.assert_array_equal(readers.to_reference_train_ids(train), jax_readers.to_reference_train_ids(train))
    sem = np.random.default_rng(2).integers(0, 19, 5000).astype(np.int32)
    for rate in (0.0, 0.05, 0.3, 1.0):
        got = readers.corrupt_labels(sem, rate, np.random.default_rng(3))
        want = jax_readers.corrupt_labels(sem, rate, np.random.default_rng(3))
        np.testing.assert_array_equal(got, want)


def test_kitti_poses_with_and_without_calib_match_reference(tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(5, 12))
    np.savetxt(tmp_path / "poses.txt", rows)
    (tmp_path / "calib.txt").write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: 0.1 -0.99 0 0.5 0.99 0.1 0 0.2 0 0 1 -0.1\n")
    (tmp_path / "nocalib.txt").write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    for calib in (None, str(tmp_path / "calib.txt")):
        got = readers.read_kitti_poses(str(tmp_path / "poses.txt"), calib)
        want = jax_readers.read_kitti_poses(str(tmp_path / "poses.txt"), calib)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="no Tr entry"):
        readers.read_kitti_poses(str(tmp_path / "poses.txt"), str(tmp_path / "nocalib.txt"))


def test_mulran_layout_matches_reference(tmp_path):
    """The MulRan on-disk layout of test_mulran_layout.py: nanosecond scan
    names, a pose.txt denser than the scans and offset in time, raw UTM
    translations; parsed, associated and offset by both packages."""
    rng = np.random.default_rng(12)
    ox, oy, oz = readers.MULRAN_UTM_OFFSETS["kaist"]
    stamps = 1_561_000_000_000_000_000 + np.arange(6, dtype=np.int64) * 100_000_000
    lines = []
    for i, s in enumerate(stamps):
        for dt, far in ((-23_000_000, 0.0), (27_000_000, 500.0)):
            q = np.eye(4)
            q[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            q[:3, 3] = rng.uniform(-50, 50, 3) + (ox + far, oy, oz)
            lines.append(f"{s + dt}," + ",".join(f"{v:.6f}" for v in q[:3, :].reshape(12)))
        readers.write_bin(str(tmp_path / f"{s}.bin"), rng.normal(size=(10, 3)))
    (tmp_path / "pose.txt").write_text("# header\n" + "\n".join(lines) + "\n")
    got_s, got_p = readers.read_mulran_poses(str(tmp_path / "pose.txt"))
    want_s, want_p = jax_readers.read_mulran_poses(str(tmp_path / "pose.txt"))
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_p, want_p)
    assert got_s[0] == stamps[0] - 23_000_000  # nanosecond stamps kept exact
    scans = readers.list_scans(str(tmp_path), ".bin")
    assert scans == jax_readers.list_scans(str(tmp_path), ".bin") and len(scans) == 6
    scan_stamps = np.asarray([int(os.path.basename(p)[:-4]) for p in scans], np.int64)
    idx = readers.associate_by_timestamp(scan_stamps, got_s)
    np.testing.assert_array_equal(idx, jax_readers.associate_by_timestamp(scan_stamps, want_s))
    np.testing.assert_array_equal(idx, np.arange(6) * 2)  # the near row, never the far one
    for seq in ("KAIST02", "dcc01", "Riverside03", "Sejong01", "unknown"):
        np.testing.assert_array_equal(
            readers.apply_mulran_utm_offset(got_p, seq), jax_readers.apply_mulran_utm_offset(want_p, seq)
        )
    edge = np.array([0, 100, 149, 151, 250, 10**18])
    table = np.array([100, 200, 300])
    np.testing.assert_array_equal(readers.associate_by_timestamp(edge, table),
                                  jax_readers.associate_by_timestamp(edge, table))


def test_config_from_yaml_matches_reference(tmp_path):
    (tmp_path / "cfg.yaml").write_text(
        "descriptor_near_num: 12\ndescriptor_min_len: 0.7\ndescriptor_max_len: 40\n"
        "std_side_resolution: 1\ncandidate_num: 30\nrough_dis_threshold: 0.05\nicp_threshold: 0.6\n"
        "SG_data:\n    leaf_size: 2.5\n    best_fitness: 10\n"
        "fast_gicp:\n    enable_gicp: true\n    num_neighbors: 15\n    max_iterations: 7\n"
    )
    (tmp_path / "empty.yaml").write_text("")
    for name in ("cfg.yaml", "empty.yaml"):
        got = config_yaml.config_from_yaml(str(tmp_path / name))
        want = jax_config_yaml.config_from_yaml(str(tmp_path / name))
        assert got == interop.config_from_reference(want)
    assert got == SGTDConfig()


@pytest.fixture(scope="module")
def graphs():
    """Three reference graphs of a small world as NumPy arrays, one given
    densities and one a pose whose floats have no short decimal form."""
    cfg = JaxSGTDConfig().replace(caps=JaxCapacityConfig(max_nodes=64))
    maps, _, _ = jax_make_map_and_queries(cfg, seed=5, num_map_frames=4, num_queries=1, center_noise_m=0.05)
    g = maps[1]
    dens = np.where(g.mask, np.random.default_rng(6).uniform(0.1, 9.0, g.mask.shape), 0).astype(np.float32)
    pose = maps[2].pose.copy()
    pose[:3] *= np.float32(1.0 / 3)  # values with no short decimal form
    return cfg, [maps[0], g._replace(density=dens), maps[2]._replace(pose=pose)]


def _assert_graph_equal(got, want):
    for f in want._fields:
        a = getattr(got, f)
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        w = np.asarray(getattr(want, f))
        assert a.dtype == w.dtype and a.shape == w.shape, f
        np.testing.assert_array_equal(a, w, err_msg=f)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_graph_json_round_trip_bit_exact_across_packages(graphs, tmp_path, writer):
    """float32 centres, poses and densities written as float(v) read back
    with the same bits, whichever package wrote the file."""
    jcfg, gs = graphs
    cfg = interop.config_from_reference(jcfg)
    for i, g in enumerate(gs):
        path = str(tmp_path / f"{i:06d}.json")
        if writer == "port":
            graph_json.write_graph_json(path, interop.graph_from_numpy(g, "cpu"))
        else:
            jax_graph_json.write_graph_json(path, g)
    with open(tmp_path / "000001.json") as f:
        text = f.read()
    if writer == "port":
        jax_graph_json.write_graph_json(str(tmp_path / "ref.json"), gs[1])
        assert text == (tmp_path / "ref.json").read_text()  # the same bytes
    got = graph_json.read_graph_dir(str(tmp_path), cfg, "cpu")
    want = jax_graph_json.read_graph_dir(str(tmp_path), jcfg)
    assert len(got) == len(want) == len(gs) + (writer == "port")
    for g, w, orig in zip(got, want, gs):
        assert g.centers.device.type == "cpu"
        _assert_graph_equal(g, w)
        _assert_graph_equal(g, orig)


def test_graph_json_pose_rows_match_reference():
    row = list(np.random.default_rng(7).normal(size=16))
    np.testing.assert_array_equal(graph_json.pose_row_to_matrix(row), jax_graph_json.pose_row_to_matrix(row))
    T = np.random.default_rng(8).normal(size=(4, 4)).astype(np.float32)
    assert graph_json.matrix_to_pose_row(torch.from_numpy(T)) == jax_graph_json.matrix_to_pose_row(T)


def test_graph_json_caps_nodes_as_reference(tmp_path):
    """A file with more nodes than max_nodes keeps the nearest, densities
    with them, as the reference's make_graph does."""
    rng = np.random.default_rng(9)
    jcfg = JaxSGTDConfig().replace(caps=JaxCapacityConfig(max_nodes=16))
    j = {"nodes": [int(x) for x in rng.integers(0, 13, 40)],
         "centers": [[float(v) for v in row] for row in rng.normal(0, 30, (40, 3)).astype(np.float32)],
         "poses": [float(v) for v in np.eye(4)[:3].reshape(-1)],
         "densitys": [float(v) for v in rng.uniform(0, 1, 40).astype(np.float32)]}
    import json

    (tmp_path / "g.json").write_text(json.dumps(j))
    got = graph_json.read_graph_json(str(tmp_path / "g.json"), interop.config_from_reference(jcfg), "cpu")
    _assert_graph_equal(got, jax_graph_json.read_graph_json(str(tmp_path / "g.json"), jcfg))


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """The files of test_native_loader.py: .bin scans with near-origin
    points and packed .label files."""
    root = tmp_path_factory.mktemp("scans")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(6):
        pts = rng.normal(0, 20, (500 + 17 * i, 4)).astype(np.float32)
        pts[:5, :3] = 1e-4
        sem = rng.integers(0, 20, len(pts)).astype(np.uint32)
        inst = rng.integers(0, 100, len(pts)).astype(np.uint32)
        b, l = root / f"{i:06d}.bin", root / f"{i:06d}.label"
        b.write_bytes(pts.tobytes())
        l.write_bytes(((sem & 0xFFFF) | (inst << 16)).astype(np.uint32).tobytes())
        paths.append((str(b), str(l)))
    return paths


def test_native_loader_builds_into_the_build_directory():
    assert native.native_available(), "native loader failed to build"
    path = native._library_path()
    assert path.exists() and path.parent.name == "sgtd_tpu_torch" and path.parent.parent.name == "build"


@pytest.mark.parametrize("min_norm", [0.0, 0.1])
def test_native_load_scan_matches_readers_and_reference(scans, min_norm):
    from sgtd_tpu import native as jax_native

    for b, l in scans[:3]:
        got = native.load_scan(b, l, min_norm=min_norm)
        want = jax_native.load_scan(b, l, min_norm=min_norm)
        pts = readers.read_bin(b)[:, :3]
        sem, inst = readers.read_label(l)
        keep = np.sum(pts * pts, axis=1) >= min_norm * min_norm
        for g, w, r in zip(got, want, (pts[keep], sem[keep], inst[keep])):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, r)
        assert len(got[0]) == len(pts) - (5 if min_norm else 0)
    xyz, sem, inst = native.load_scan(scans[0][0])  # no label file
    assert not sem.any() and not inst.any() and len(xyz) == len(readers.read_bin(scans[0][0]))


def test_numpy_fallback_equals_native(scans, monkeypatch):
    """Where g++ is missing the NumPy readers load the same arrays."""
    want = [native.load_scan(b, l, min_norm=0.1) for b, l in scans[:2]]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.native_available()
    for (b, l), w in zip(scans[:2], want):
        for g, x in zip(native.load_scan(b, l, min_norm=0.1), w):
            np.testing.assert_array_equal(g, x)
    with native.PrefetchingLoader([b for b, _ in scans], [l for _, l in scans]) as loader:
        assert loader._handle is None
        for g, x in zip(loader.get(1), native.load_scan(*scans[1])):
            np.testing.assert_array_equal(g, x)


def test_prefetching_loader_gives_the_frames_in_order(scans):
    bins = [b for b, _ in scans]
    labels = [l for _, l in scans]
    with native.PrefetchingLoader(bins, labels, n_threads=2, depth=3, min_norm=0.1) as loader:
        assert loader._handle is not None and len(loader) == 6
        for i in [0, 1, 2, 5, 3, 0, 4]:  # out-of-order access too
            for g, w in zip(loader.get(i), native.load_scan(bins[i], labels[i], min_norm=0.1)):
                np.testing.assert_array_equal(g, w)
    assert loader._handle is None
    loader = native.PrefetchingLoader(bins)  # scans only, as the CLI reads its queries
    try:
        for i in range(6):
            np.testing.assert_array_equal(loader.get(i)[0], readers.read_bin(bins[i])[:, :3])
    finally:
        loader.close()
