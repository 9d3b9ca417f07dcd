"""The bench-world builder, the stage timers and the world launcher.

``build_bench_world`` at a small size against sgtd_tpu's; ``StageTimers``
fed the same samples as the reference's; ``device_trace`` on the CPU; and
``run_world`` when one rank of a gloo world fails.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sgtd_tpu.eval.benchworld import build_bench_world as jax_build_bench_world
from sgtd_tpu.utils import profiling as jax_profiling
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.eval.benchworld import build_bench_world
from sgtd_tpu_torch.parallel.multihost_check import FAIL_EXIT, run_world
from sgtd_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_bench_world_matches_reference(small_config):
    kw = dict(num_map=24, num_q=8, seed=2026, calibrate_n=8)
    want_cfg, want_db, want_q, want_rep, want_world = jax_build_bench_world(config=small_config, **kw)
    got_cfg, got_db, got_q, got_rep, got_world = build_bench_world(
        config=interop.config_from_reference(small_config), device="cpu", **kw)
    assert dataclasses.asdict(got_rep) == dataclasses.asdict(want_rep)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_cfg.caps.max_scan_slots == want_cfg.caps.max_scan_slots
    want_db = interop.db_from_numpy(want_db, "cpu")
    for f in got_db._fields:
        np.testing.assert_array_equal(getattr(got_db, f).numpy(), getattr(want_db, f).numpy(), err_msg=f)
    for f in got_q._fields:
        np.testing.assert_array_equal(getattr(got_q, f).numpy(), np.asarray(getattr(want_q, f)), err_msg=f)
    np.testing.assert_array_equal(got_world.query_poses, want_world.query_poses)


def _feed(timers, rng):
    for name in ("VM", "CS1", "extra", "PE", "SGC"):
        for ms in rng.uniform(0.1, 50.0, int(rng.integers(1, 9))):
            timers.add(name, float(ms))


def test_stage_timers_match_reference():
    got, want = profiling.StageTimers(), jax_profiling.StageTimers()
    _feed(got, np.random.default_rng(5))
    _feed(want, np.random.default_rng(5))
    with got.stage("GICP", sync="cpu"):
        pass
    want.add("GICP", got.samples["GICP"][0])
    assert got.summary() == want.summary()
    assert got.report() == want.report()
    assert profiling.STAGES == jax_profiling.STAGES


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert (tmp_path / "trace" / files[0]).stat().st_size > 0


def test_run_world_names_the_failing_rank(tmp_path):
    """Rank 2 exits before it joins the group; the others, waiting for it,
    are killed, and the error names rank 2 and shows its output."""
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[2\] of a 3-rank gloo world exited nonzero") as err:
        run_world(3, "gloo", "cpu", tmp_path, ["fail:2", "ping"], timeout=120)
    assert f"exit {FAIL_EXIT}" in str(err.value) and "as the fail leg asks" in str(err.value)


def test_run_world_ping(tmp_path):
    summary = run_world(2, "gloo", "cpu", tmp_path, ["ping"], timeout=120)
    assert summary["world"] == 2 and summary["foreign_modules"] == [] and summary["startup_s"] > 0
