"""The port's observation-sharded Schur BA against sgtd_tpu's, on the CPU.

tests/test_ba.py's ``test_ba_sharded_matches_cg`` problem (40 landmarks
padded to 48 with unobserved rows) goes through the reference's
``optimize_ba_sharded`` on a virtual 4-device "obs" mesh and through the
port's in one 4-rank gloo world of subprocesses (``run_world``, 12
landmarks a rank), started once for the module. The port is held to the
reference and to its own single-device ``optimize_ba_cg`` within 2e-3,
the reference test's tolerance between the sharded and single solves.
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from sgtd_tpu.backend import ba as jax_ba
from sgtd_tpu.parallel.sharded_ba import optimize_ba_sharded as jax_optimize_ba_sharded
from sgtd_tpu_torch.backend import ba
from sgtd_tpu_torch.interop import ba_problem_from_numpy
from sgtd_tpu_torch.parallel.multihost_check import read_outputs, run_world, write_inputs
from tests.test_ba import _make_problem

torch.set_num_threads(1)

N, L_PAD, ITERATIONS, CG = 4, 48, 6, 200
TOL = 2e-3


def _padded():
    p, _, _ = _make_problem(np.random.default_rng(42))
    p = jax_ba.BAProblem(*(np.asarray(x) for x in p))
    pad = L_PAD - p.landmarks.shape[0]
    grow = lambda a: np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return p._replace(landmarks=grow(p.landmarks), obs_frame=grow(p.obs_frame),
                      obs_local=grow(p.obs_local), obs_valid=grow(p.obs_valid))


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    problem = _padded()
    mesh = Mesh(np.asarray(jax.devices()[:N]).reshape(N), ("obs",))
    want = jax_optimize_ba_sharded(problem, mesh, axis="obs", iterations=ITERATIONS, cg_iterations=CG)
    tba = ba_problem_from_numpy(problem, "cpu")
    single = ba.optimize_ba_cg(tba, iterations=ITERATIONS, cg_iterations=CG)
    d = tmp_path_factory.mktemp("ba_world")
    write_inputs(d, ba=tba)
    leg = f"ba:{ITERATIONS}:{CG}"
    summary = run_world(N, "gloo", "cpu", d, [leg], timeout=300)
    got = read_outputs(d / "out", leg)
    return {f: np.asarray(v) for f, v in want._asdict().items()}, got, single, summary


@pytest.mark.parametrize("other", ["reference_sharded", "port_cg"])
def test_poses_and_landmarks_close(outputs, other):
    want, got, single, _ = outputs
    ref = want if other == "reference_sharded" else {f: v.numpy() for f, v in single._asdict().items()}
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["landmarks"][:40], ref["landmarks"][:40], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["costs"], ref["costs"], rtol=1e-3, atol=1e-8)


def test_result_is_whole(outputs):
    """Every rank's landmarks come back in rank order; padded rows, which
    no observation moves, stay where they started."""
    _, got, _, summary = outputs
    assert got["poses"].shape == (6, 4, 4) and got["landmarks"].shape == (L_PAD, 3)
    assert got["costs"].shape == (ITERATIONS,) and got["costs"][-1] < 1e-4 * got["costs"][0]
    np.testing.assert_array_equal(got["landmarks"][40:], 0.0)
    # Each GN step: cost, gradient, diagonal blocks, CG matvecs; then the
    # gather of the landmarks. The same count on every rank.
    calls = [r["collective_calls"] for r in summary["legs"][f"ba_{ITERATIONS}_{CG}"]]
    assert calls == [ITERATIONS * (3 + CG) + 1] * N
