"""``localize_scan``: relocalization from raw labeled scans (CPU).

The port's front end against the plain reference front end of the
benchmark (``portbench/reference/frontend.py``, float64, written apart
from the port) on small seeded labeled scans; ``localize_scan`` against
the composition it stands for (the graphs built one scan at a time,
stacked and localized) and against the same graphs through the graph
JSON files; the front end's spans and counters with the tracer on and
off; and that the reference front end imports nothing of the program or
of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.gen import scans, world  # noqa: E402
from portbench.reference import frontend  # noqa: E402
from sgtd_tpu_torch.cluster import components  # noqa: E402
from sgtd_tpu_torch.config import CapacityConfig, SGTDConfig  # noqa: E402
from sgtd_tpu_torch.eval.runner import build_map_index  # noqa: E402
from sgtd_tpu_torch.graph.build import build_graph, build_graph_arrays  # noqa: E402
from sgtd_tpu_torch.graph.types import stack_graphs  # noqa: E402
from sgtd_tpu_torch.io.graph_json import read_graph_json, write_graph_json  # noqa: E402
from sgtd_tpu_torch.match import localize, localize_scan  # noqa: E402
from sgtd_tpu_torch.utils import profiling  # noqa: E402

# Small scans: blobs, a sidewalk sheet, 5% of points relabeled out of range.
SMALL = {"max_points": 8192, "target_points": 8000, "ground_points": 1000, "min_blob_points": 40,
         "blob_sigma_m": 0.15, "ground_noise_m": 0.03, "view_radius_m": 50.0}
# Float32 centroids of at most a few hundred points within 50 m, against
# float64 ones rounded once: a few float32 ulps at 50 m (3.8e-6 m each).
CENTROID_TOL_M = 1e-4
CFG = SGTDConfig().replace(caps=CapacityConfig(max_nodes=64, max_descriptors=512))


def _scan(seed: int, wd=None, pose=None, relabel: float = 0.05):
    """A padded small labeled scan from the seed: (points, sem, inst, mask)."""
    if wd is None:
        wd = world.make_world(np.random.default_rng(seed), extent_m=400.0, num_map_frames=8, num_queries=1)
        pose = wd.map_poses[seed % 8]
    p, s = scans.render(wd, pose, [seed, 5], SMALL, 0.1, relabel)
    n = SMALL["max_points"]
    out = np.zeros((n, 3), np.float32), np.zeros(n, np.int32), np.zeros(n, np.int32), np.zeros(n, bool)
    out[0][: len(p)], out[1][: len(p)], out[3][: len(p)] = p, s, True
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2**31 + 9, 77])
def test_front_end_equals_the_plain_reference(seed):
    points, sem, inst, mask = _scan(seed)
    c, lab, _, m = (x.numpy() for x in build_graph_arrays(*map(torch.from_numpy, (points, sem, inst, mask)),
                                                        CFG.caps))
    ref = frontend.build_graph(points, sem, mask, np.eye(4), CFG.caps.max_nodes, "cpu")
    assert m.sum() >= 10
    assert np.array_equal(m, ref.mask) and np.array_equal(lab, ref.labels)
    assert np.abs(c[m] - ref.centers[m]).max() <= CENTROID_TOL_M


@pytest.fixture(scope="module")
def site():
    """A map index of 16 small keyframe scans, their graphs built by the
    port's front end, and 4 query scans of the same world."""
    wd = world.make_world(np.random.default_rng(11), extent_m=400.0, num_map_frames=16, num_queries=4)
    maps = [build_graph(*map(torch.from_numpy, _scan(100 + i, wd, p, 0.0)), p, CFG.caps)
            for i, p in enumerate(wd.map_poses)]
    index = build_map_index(maps, CFG, "cpu")
    q = [_scan(200 + i, wd, p) for i, p in enumerate(wd.query_poses)]
    return index, [torch.from_numpy(np.stack(x)) for x in zip(*q)]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _composition(index, points, sem, inst, mask):
    """build-map's graphs, one scan at a time, stacked, then localize."""
    eye = torch.eye(4)
    graphs = [build_graph(points[b], sem[b], inst[b], mask[b], eye, index.config.caps, index.config.dcvc)
              for b in range(points.shape[0])]
    batch = stack_graphs(graphs, "cpu")
    return localize(index.db, batch, index.config), batch


@pytest.mark.parametrize("batch", [1, 4])
def test_localize_scan_is_the_composition_bit_for_bit(site, batch):
    index, q = site
    q = [x[:batch] for x in q]
    res, graphs = localize_scan(index.db, *q, index.config)
    want, want_graphs = _composition(index, *q)
    assert _equal(res, want) and _equal(graphs, want_graphs)
    assert bool(res.found.any())


def test_localize_scan_equals_the_graphs_through_json_files(site, tmp_path):
    index, q = site
    res, graphs = localize_scan(index.db, *q, index.config)
    read = []
    for b in range(q[0].shape[0]):
        path = str(tmp_path / f"{b:06d}.json")
        write_graph_json(path, type(graphs)(*(x[b] for x in graphs)))
        read.append(read_graph_json(path, index.config, "cpu"))
    batch = stack_graphs(read, "cpu")
    assert _equal(batch, graphs)
    assert _equal(localize(index.db, batch, index.config), res)


def _aten_ops(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("aten::")]


def test_spans_and_counters_add_no_operation(site):
    index, q = site
    off = _aten_ops(lambda: localize_scan(index.db, *q, index.config))
    profiling.enable()
    try:
        on = _aten_ops(lambda: localize_scan(index.db, *q, index.config))
    finally:
        profiling.disable()
    assert on == off == _aten_ops(lambda: _composition(index, *q))


def test_tracer_spans_nest_and_count_sweeps(site, monkeypatch):
    index, q = site
    sweeps = []

    def min_labels(*args):
        out = propagate(*args)
        sweeps.append(out[1])
        return out

    propagate = components.min_labels
    monkeypatch.setattr(components, "min_labels", min_labels)
    tracer = profiling.enable()
    try:
        _, graphs = localize_scan(index.db, *q, index.config)
        profiling.flush()
    finally:
        profiling.disable()
    spans = {s.id: s for s in tracer.spans}
    parent = lambda s: spans[s.parent].name if s.parent is not None else None  # noqa: E731
    by_name = {}
    for s in spans.values():
        by_name.setdefault(s.name, []).append(s)
    assert [s.name for s in spans.values() if s.parent is None] == ["localize_scan"]
    want = {"graph.build": "localize_scan", "cluster.dcvc": "graph.build", "dcvc.voxels": "cluster.dcvc",
            "dcvc.components": "cluster.dcvc", "dcvc.stats": "cluster.dcvc", "graph.gt_group": "graph.build",
            "graph.whole": "graph.build", "graph.compact": "graph.build", "localize": "localize_scan"}
    b = q[0].shape[0]
    for name, up in want.items():
        assert len(by_name[name]) == (1 if name == "localize" else b), name
        assert {parent(s) for s in by_name[name]} == {up}, name
    counts = {k: [v for _, v in tracer.counters[k]] for k in ("dcvc.sweeps", "dcvc.voxels", "graph.points",
                                                            "graph.nodes")}
    assert counts["dcvc.sweeps"] == sweeps and len(sweeps) == b and min(counts["dcvc.sweeps"]) >= 2
    assert counts["graph.points"] == [int(m.sum()) for m in q[3]]
    assert counts["graph.nodes"] == [int(m.sum()) for m in graphs.mask]
    assert all(0 < v < p for v, p in zip(counts["dcvc.voxels"], counts["graph.points"]))


def test_tracing_off_records_nothing(site):
    index, q = site
    assert profiling.active() is None
    tracer = profiling.enable()
    profiling.disable()
    localize_scan(index.db, *q, index.config)
    assert not tracer.spans and not tracer.counters and not tracer._pending


def test_the_reference_front_end_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from portbench.reference import frontend
from portbench.gen import scans, world
wd = world.make_world(np.random.default_rng(1), extent_m=400.0, num_map_frames=4, num_queries=1)
p, s = scans.render(wd, wd.map_poses[0], [1], {SMALL!r})
frontend.build_graph(p, s, np.ones(len(p), bool), np.eye(4), 64, "cpu")
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sgtd_tpu", "sgtd_tpu_torch")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
