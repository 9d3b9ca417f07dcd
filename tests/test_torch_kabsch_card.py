"""K1 ``triangle_hypotheses`` and K2 ``verify_epilogue`` on a CUDA card,
against their plain versions on the same card (chip_smoke.py's checks:
``check_k1``, ``check_votes_over_k1``, ``check_k2``).

- K1 at the three cells' shapes (16 x 50, 8 x 50 and 50 candidates of
  512 pairs, 50 hypotheses) on every slot, masked ones included: rotation
  entries within 2e-6, translations within 1e-5 m; B3's votes over its
  hypotheses equal B3's over the plain version's but by borderline pairs.
- K2 on the same votes and hypotheses: scores and inlier masks equal but
  on pairs within 1e-5 m of the threshold, the same polish choice, the
  sampled poses equal, the polished ones within 1e-5 and 1e-4 m.
- The edges (``chip_smoke.kabsch_edges``), under the same gates:
  valid-pair counts 0, 1, 2, 49-51 and more, collinear triangles and
  coincident points (where rounding decides the rotation, and K1 still
  gives the plain version's, taking its orders), candidates without
  inliers and with one, all-invalid candidates, P 513, 130 and 3, H 1.
  Then the launch counters.

Skipped without a card. This file imports no JAX, and tests/conftest.py
does, so on the card's machine (which has no JAX) run it with::

    python -m pytest tests/test_torch_kabsch_card.py --noconftest -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from sgtd_tpu_torch.config import SearchConfig  # noqa: E402
from sgtd_tpu_torch.ops import kabsch as kabsch_ops, launch_counts  # noqa: E402
from sgtd_tpu_torch.ops import verify  # noqa: E402

pytestmark = pytest.mark.card
SEARCH = SearchConfig()
THR, MIN_VOTES, H = SEARCH.verify_dis_threshold, SEARCH.min_hypothesis_votes, SEARCH.max_hypotheses


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 are CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [smoke.CHUNK * 50, smoke.SCALE_CHUNK * 50, 50])
def test_k1_b3_and_k2_against_their_plain_versions_at_the_cells_shapes(dev, n):
    rng = np.random.default_rng(n)
    vq, vdb, pv, cv = smoke.kabsch_problem(rng, n, H, 512, "prefix", dev)
    k1 = smoke.check_k1(f"N {n}", vq, vdb, pv, H)
    votes, _ = smoke.check_votes_over_k1(f"N {n}", k1, vq, vdb, pv, THR)
    smoke.check_k2(f"N {n}", votes, *k1["got"], vq, vdb, pv, cv, THR, MIN_VOTES, polished_min=1)


@pytest.mark.parametrize("case", range(11))
def test_k1_and_k2_at_the_edges(dev, case):
    smoke.check_kabsch_edge(*smoke.kabsch_edges(np.random.default_rng(case), dev, MIN_VOTES)[case], THR)


def test_the_edge_list_is_whole(dev):
    assert len(smoke.kabsch_edges(np.random.default_rng(0), dev, MIN_VOTES)) == 11


def test_launch_counters_count_each_launch(dev):
    vq, vdb, pv, cv = smoke.kabsch_problem(np.random.default_rng(1), 8, H, 64, "prefix", dev)
    k1, k2 = launch_counts()[8:10]
    rot_h, t_h = kabsch_ops.triangle_hypotheses(vq, vdb, pv, H)
    votes = verify.hypothesis_votes(rot_h, t_h, vq, vdb, pv, THR)
    out = kabsch_ops.verify_epilogue(votes, rot_h, t_h, vq, vdb, pv, cv, THR, MIN_VOTES)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x.float()).all()) for x in out)
    assert launch_counts()[8:10] == [k1 + 1, k2 + 1]
