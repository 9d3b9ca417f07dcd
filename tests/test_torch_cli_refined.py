"""The port's CLI ``localize --enable-gicp`` against sgtd_tpu.cli on the
files of tests/test_torch_cli.py, with each engine: the port's build run
(map artifacts built and saved), its load run and a run without
artifacts.

Counts, rates and recalls are equal. Pose errors agree within 5e-3 m /
5e-2 deg with GICP (the refined rule of tests/test_torch_eval.py); with
VGICP within 5e-2 m / 0.5 deg: at a 3 m leaf a source keeps ~200 points,
few with a voxel in reach, and the LM loop is chaotic there: the
reference's jitted and op-by-op programs land up to 0.83 m apart on one
candidate of these files (measured), while the summaries of the two
packages differ by 5.9e-3 m. A load run equals its build run on every
key that holds no time.
"""

import os

import numpy as np
import pytest
import torch

from sgtd_tpu import cli as jax_cli
from sgtd_tpu_torch import cli
from tests.test_torch_cli import TIMING_KEYS, _assert_close, _localize_args, _run, files  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("engine", ["gicp", "vgicp"])
def test_localize_refined_matches_reference(files, engine):
    """--enable-gicp with each engine: the port's build run (artifacts built
    and saved) and load run against the reference CLI on the same files."""
    root, dirs = files
    args = _localize_args(dirs) + [
        "--enable-gicp", "--engine", engine, "--map-scans", dirs["map_scans"], "--query-scans",
        dirs["query_scans"], "--leaf-size", "3.0", "--gicp-max-points", "256", "--rerank-k", "2",
    ]
    want = _run(jax_cli.main, args)
    art = str(root / f"art_{engine}.npz")
    build = _run(cli.main, args + ["--map-artifacts", art, "--device", "cpu"])
    assert os.path.exists(art)
    with np.load(art) as z:
        assert ("vmap_keys" in z) == (engine == "vgicp")
    load = _run(cli.main, args + ["--map-artifacts", art, "--device", "cpu"])
    _assert_close(build, want, *((5e-3, 5e-2) if engine == "gicp" else (5e-2, 0.5)))
    assert {k: build[k] for k in build if k not in TIMING_KEYS} == {k: load[k] for k in load if k not in TIMING_KEYS}
    assert build["success_rate"] == 1.0
    # Without artifacts the rerank builds them inside: the same summary.
    _assert_close(_run(cli.main, args + ["--device", "cpu"]), build, 0.0, 0.0)


def test_rerank_without_artifacts_reproduces_the_reference_fault(files, tmp_path):
    """ROADMAP section 3: without --map-artifacts, evaluate asks the CLI's
    map_cloud_fn for every row of the DB's padded frame axis, so a map of
    7 keyframes (padded to 8) raises IndexError in both packages."""
    import shutil

    _, dirs = files
    few = {k: dirs[k] for k in ("query_graphs", "query_scans")}
    for k in ("map_graphs", "map_scans"):
        few[k] = str(tmp_path / k)
        os.makedirs(few[k])
        for name in sorted(os.listdir(dirs[k]))[:7]:
            shutil.copy(os.path.join(dirs[k], name), few[k])
    args = _localize_args(few) + ["--enable-gicp", "--map-scans", few["map_scans"], "--query-scans",
                                  few["query_scans"], "--gicp-max-points", "256"]
    with pytest.raises(IndexError):
        jax_cli.main(args)
    with pytest.raises(IndexError):
        cli.main(args + ["--device", "cpu"])
