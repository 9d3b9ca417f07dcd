"""The port's CLI (``python -m sgtd_tpu_torch.cli``) against sgtd_tpu.cli on
the same files, which the tests write themselves: ``localize``
descriptor-only, ``eval-synth`` with its plot and candidate PNGs,
``build-map`` (not ported: it raises), and a run in a process of its own
that loads no JAX and no sgtd_tpu module. The refined runs are in
tests/test_torch_cli_refined.py.

The summaries carry the reference's keys in its order. Counts, rates and
recalls are equal; pose errors agree within 1e-3 m / 1e-2 deg (the
descriptor-only rule of tests/test_torch_eval.py).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sgtd_tpu import cli as jax_cli
from sgtd_tpu.config import SGTDConfig
from sgtd_tpu.data.synthetic import make_map_and_queries, render_planar_cloud
from sgtd_tpu.io.graph_json import write_graph_json
from sgtd_tpu.io.readers import write_bin
from sgtd_tpu_torch import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING_KEYS = ("mean_time_ms", "map_build_seconds", "compile_seconds", "artifact_build_seconds",
               "query_cloud_load_seconds")
EXACT_KEYS = ("total", "success_rate", "recall_at_1", "recall_at_5", "recall_at_10", "db_rows")


def _run(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue())


def _assert_close(got, want, trans_atol, rot_atol):
    assert list(got) == list(want)
    for k in EXACT_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("rmse_trans_m", "mean_trans_m"):
        assert abs(got[k] - want[k]) <= trans_atol, (k, got[k], want[k])
    for k in ("rmse_rot_deg", "mean_rot_deg"):
        assert abs(got[k] - want[k]) <= rot_atol, (k, got[k], want[k])
    assert all(np.isfinite(got[k]) and got[k] >= 0 for k in TIMING_KEYS)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A small world as a user hands it to the CLI: graph JSONs of 8
    keyframes and 3 queries, and .bin scans of planar renders (1,024
    points)."""
    root = tmp_path_factory.mktemp("cli")
    maps, queries, world = make_map_and_queries(SGTDConfig(), seed=9, num_map_frames=8, num_queries=3,
                                                center_noise_m=0.05)
    rng = np.random.default_rng(5)
    dirs = {}
    for side, graphs, poses in (("map", maps, world.map_poses), ("query", queries, world.query_poses)):
        for kind in ("graphs", "scans"):
            dirs[f"{side}_{kind}"] = str(root / f"{side}_{kind}")
            os.makedirs(dirs[f"{side}_{kind}"])
        for i, (g, p) in enumerate(zip(graphs, poses)):
            write_graph_json(os.path.join(dirs[f"{side}_graphs"], f"{i:06d}.json"), g)
            cloud, mask = render_planar_cloud(world, p, rng, max_points=1024)
            write_bin(os.path.join(dirs[f"{side}_scans"], f"{i:06d}.bin"), cloud[mask])
    return root, dirs


def _localize_args(dirs):
    return ["localize", "--map-graphs", dirs["map_graphs"], "--query-graphs", dirs["query_graphs"],
            "--batch-size", "2"]


def test_localize_descriptor_only_matches_reference(files):
    _, dirs = files
    want = _run(jax_cli.main, _localize_args(dirs))
    got = _run(cli.main, _localize_args(dirs) + ["--device", "cpu"])
    _assert_close(got, want, 1e-3, 1e-2)
    assert got["total"] == 3 and got["success_rate"] == 1.0


def test_localize_rejects_mismatched_scans(files, tmp_path):
    _, dirs = files
    os.makedirs(tmp_path / "few")
    args = _localize_args(dirs) + ["--enable-gicp", "--map-scans", str(tmp_path / "few"), "--query-scans",
                                   dirs["query_scans"], "--device", "cpu"]
    with pytest.raises(SystemExit, match="scan/graph count mismatch"):
        cli.main(args)
    with pytest.raises(SystemExit, match="requires --query-scans"):
        cli.main(_localize_args(dirs) + ["--enable-gicp", "--device", "cpu"])


def test_eval_synth_matches_reference(tmp_path):
    args = ["eval-synth", "--map-frames", "10", "--queries", "3", "--seed", "4"]
    want = _run(jax_cli.main, args)
    got = _run(cli.main, args + ["--device", "cpu", "--plot", str(tmp_path / "traj.png"),
                                 "--viz-dir", str(tmp_path / "viz"), "--viz-queries", "1"])
    assert got["plot"] == str(tmp_path / "traj.png") and os.path.getsize(got["plot"]) > 0
    assert got["viz"] == [str(tmp_path / "viz" / "query_0000.png")] and os.path.getsize(got["viz"][0]) > 0
    _assert_close({k: v for k, v in got.items() if k not in ("plot", "viz")}, want, 1e-3, 1e-2)


def test_build_map_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="front end"):
        cli.main(["build-map", "--scans", str(tmp_path), "--labels", str(tmp_path), "--out", str(tmp_path)])


def test_cli_process_imports_no_jax(files):
    """``python -m sgtd_tpu_torch.cli`` in a process of its own, and every
    module this slice added, load no jax and no sgtd_tpu module."""
    _, dirs = files
    code = f"""
import contextlib, io, json, sys
from sgtd_tpu_torch import cli
import sgtd_tpu_torch.db.database, sgtd_tpu_torch.eval.oracle, sgtd_tpu_torch.eval.plotting
import sgtd_tpu_torch.io.config_yaml, sgtd_tpu_torch.io.graph_json, sgtd_tpu_torch.io.readers
import sgtd_tpu_torch.native, sgtd_tpu_torch.refine.vgicp
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    cli.main({_localize_args(dirs) + ["--device", "cpu"]!r})
assert json.loads(buf.getvalue())["total"] == 3
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sgtd_tpu"))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.slow
def test_reference_cli_vgicp(tmp_path):
    """REFERENCE_CLI_VGICP_SR, the floor of chip_smoke.py phase 8's VGICP
    gate, is what sgtd_tpu's CLI gives on the CPU on the same files (the
    bench world of write_cli_world, all 64 queries; about 7 minutes)."""
    import chip_smoke

    dirs = chip_smoke.write_cli_world(str(tmp_path))
    out = _run(jax_cli.main, chip_smoke.cli_args(dirs, "vgicp", str(tmp_path / "art.npz")))
    assert out["total"] == chip_smoke.NUM_QUERIES
    assert out["success_rate"] == chip_smoke.REFERENCE_CLI_VGICP_SR
