"""The GICP rerank's LM trip as a CUDA graph (``refine.lsq.LmGraph``,
``refine.gicp._graphed``) on a card, against the same solves with their
trips run eagerly (chip_smoke.py's ``check_lm_graph``).

- At the rerank's shape (64 problems of 1,024 source x 4,096 target
  points, made with NumPy from a seed) and at the TRUNC_SCAN fallback's
  (4 problems): every field of ``gicp_align`` (transform, fitness,
  num_inliers, fitness_gated, inlier_frac) the same bits as the eager
  trips', on the solve that captures and on a later one; a solve on other
  inputs between two readings gives its own bits and leaves the first
  result as it was. The later solve moves ``ops.launch_counts()`` as the
  eager one does, replays once a trip (``lm.graph_replays`` equals
  ``lm.trips``) and captures nothing; a key is captured once.
- A batch that converges after 3 trips stops after 3 replays.

Skipped without a card. This file imports no JAX, and tests/conftest.py
does, so on the card's machine (which has no JAX) run it with::

    python -m pytest tests/test_torch_lm_graph_card.py --noconftest -q
"""

import collections
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from sgtd_tpu_torch.refine import gicp  # noqa: E402

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured and replayed only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def graphs(dev, monkeypatch):
    """A fresh, empty graph cache."""
    cache = collections.OrderedDict()
    monkeypatch.setattr(gicp, "_GRAPHS", cache)
    return cache


@pytest.mark.parametrize("p", [64, 4])
def test_graphed_gicp_align_equals_the_eager_trips_bit_for_bit(dev, graphs, p):
    rng = np.random.default_rng(p)
    problem, other = smoke.align_problem(rng, p, dev), smoke.align_problem(rng, p, dev)
    n = smoke.check_lm_graph(f"P {p}", problem, other=other)
    assert n["first"]["lm.graph_captures"] == 1 and len(graphs) == 1
    assert n["second"]["lm.graph_replays"] == n["second"]["lm.trips"] == n["eager"]["lm.trips"] > 0
    assert n["moved"][3] == n["second"]["lm.trips"] + 1  # B4: one a trip and the fitness pass


def test_a_batch_that_converges_early_stops_as_early(dev, graphs):
    problem = smoke.align_problem(np.random.default_rng(4), 4, dev, noise=0.0, offset=0.0, init=0.02, masked=0.0)
    n = smoke.check_lm_graph("converging after 3 trips", problem)
    assert n["eager"]["lm.trips"] == 3 and n["second"]["lm.graph_replays"] == 3
    assert n["first"]["lm.graph_replays"] == 3
