"""K3 ``grouped_sums`` on a CUDA card (chip_smoke.py's ``check_grouped``).

- K3 against its plain version on the same card and on the CPU, bit for
  bit, two launches for the same bits: at the cell ``hdl64.scan.b1``'s
  shape (131,072 rows, 256 slots, more than 80% of the rows left out,
  slots of -1, S and int32's largest among them), with no row left out,
  and at S 1.
- ``build_graph`` launches it twice a scan (DCVC's sums and the instance
  grouping's), and gives on the card the arrays it gives on the CPU for a
  scan of the cell's kind (``portbench/gen/scans.py``).

Skipped without a card. This file imports no JAX, and tests/conftest.py
does, so on the card's machine (which has no JAX) run it with::

    python -m pytest tests/test_torch_grouped_card.py --noconftest -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from sgtd_tpu_torch.graph.build import build_graph_arrays  # noqa: E402
from sgtd_tpu_torch.ops import launch_counts  # noqa: E402

pytestmark = pytest.mark.card
N, S = smoke.GROUPED_ROWS, smoke.GROUPED_SLOTS


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is a CUDA kernel")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scan():
    return smoke.hdl64_scan(7)


@pytest.mark.parametrize("shape, kept, dropped", [((N, S), 0.15, (0.8 * N, N)), ((N, S), 1.0, (0, 0)),
                                                   ((4099, 1), 0.5, (1, 4099))],
                         ids=["the cell's shape", "no row left out", "S 1"])
def test_k3_gives_the_plain_versions_bits(dev, shape, kept, dropped):
    points, slot = smoke.grouped_problem(np.random.default_rng(shape[1]), *shape, kept, dev)
    got = smoke.check_grouped(f"{shape}, kept {kept}", points, slot, shape[1])
    assert dropped[0] <= got["dropped"] <= dropped[1]


def test_build_graph_launches_k3_twice_a_scan(dev, scan):
    before = launch_counts()[10]
    calls = smoke.grouped_calls(dev, scan)
    torch.cuda.synchronize()
    assert launch_counts()[10] == before + 2 and [c[2] for c in calls] == [S, S]
    for label, (points, slot, s) in zip(("dcvc.stats", "graph.gt_group"), calls):
        smoke.check_grouped(label, points, slot, s)


def test_build_graph_on_the_card_equals_the_cpu(dev, scan):
    cpu = build_graph_arrays(*(torch.from_numpy(a) for a in scan))
    card = build_graph_arrays(*(torch.from_numpy(a).to(dev) for a in scan))
    assert int(cpu[3].sum()) > 10
    for name, a, b in zip(("centers", "labels", "density", "node_mask"), card, cpu):
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))
