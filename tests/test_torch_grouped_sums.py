"""K3 ``grouped_sums`` (sgtd_tpu_torch/ops/grouped.py) on the CPU.

CPU tensors take the plain version, which must give, bit for bit, what the
front end's cluster sums gave before the kernel: three ``segment_sum``
calls over the slot vector with the rows left out sent to one extra
segment (``_three_segment_sums`` below, the code of ``dcvc.stats`` and
``_group_by_key`` before K3). The CUDA kernel runs only on a card
(tests/test_torch_grouped_card.py, chip_smoke.py); here the arithmetic it
implements (csrc/grouped.cu: one stable sort, each slot's run found by two
32-way searches of the sorted slot vector, five columns added from zero in
row order, the square column as float64 products and sums rounded to
float32) is written out in NumPy and held against the plain version. The
wrapper's contract raises before any work, and its counters count the rows
summed and left out.
"""

import numpy as np
import pytest
import torch

from sgtd_tpu_torch.graph.build import build_graph
from sgtd_tpu_torch.ops import grouped, launch_counts
from sgtd_tpu_torch.utils import profiling, segment_sum, sq_norm_fma

I32 = np.iinfo(np.int32)


def _three_segment_sums(points, slot, s: int):
    """The cluster sums as the front end took them before K3."""
    pc = torch.where((slot >= 0) & (slot < s), slot, -1)
    seg = torch.where(pc >= 0, pc, s)
    ones = (pc >= 0).to(torch.float32)
    counts = segment_sum(ones, seg, s + 1)[:s]
    sums = segment_sum(points * ones[:, None], seg, s + 1)[:s]
    sq = segment_sum(sq_norm_fma(points) * ones, seg, s + 1)[:s]
    return counts, sums, sq


def _blobs(rng, n: int, s: int, kept: float) -> np.ndarray:
    """Slots as a scan's clusters lie: runs of consecutive rows a slot, a
    share ``kept`` of the rows in runs, the others left out (-1)."""
    slot = np.full(n, -1, np.int32)
    i = 0
    while i < n:
        run = int(rng.integers(50, 2000))
        if rng.uniform() < kept:
            slot[i : i + run] = rng.integers(0, s)
        i += run
    return slot


def _case(name: str):
    """(points (N, 3) float32, slot (N,) int32, S) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, s = {"mixed": (1000, 7), "empty slots": (500, 64), "all left out": (4099, 256), "none left out": (777, 1),
            "S 256": (2049, 256), "the cell's shape": (131072, 256), "one row": (1, 1)}[name]
    if name == "mixed":  # -1 and slots of S and above, int32's ends among them
        slot = rng.choice(np.array([-1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 1000, I32.max, I32.min], np.int32), n)
    elif name == "empty slots":
        slot = rng.choice(np.array([0, 5, 63, -1], np.int32), n)
    elif name == "all left out":
        slot = np.full(n, -1, np.int32)
    elif name in ("none left out", "one row"):
        slot = np.zeros(n, np.int32)
    elif name == "S 256":
        slot = rng.integers(0, s, n).astype(np.int32)
    else:
        slot = _blobs(rng, n, s, 0.15)
    points = (rng.normal(size=(n, 3)) * np.array([30.0, 30.0, 2.0])).astype(np.float32)
    points[::97] = -0.0  # signed zeros: a sum starts from +0.0
    return torch.from_numpy(points), torch.from_numpy(slot), s


CASES = ["mixed", "empty slots", "all left out", "none left out", "S 256", "the cell's shape", "one row"]


def _same_bits(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("name", CASES)
def test_plain_version_equals_the_three_segment_sums_bit_for_bit(name):
    points, slot, s = _case(name)
    want = _three_segment_sums(points, slot, s)
    before = launch_counts()
    _same_bits(grouped.grouped_sums(points, slot, s), want)
    _same_bits(grouped.grouped_sums_plain(points, slot, s), want)
    assert launch_counts() == before
    if name == "empty slots":
        assert int((want[0] == 0).sum()) == s - 3
    if name == "all left out":
        assert not bool(torch.cat([w.reshape(-1) for w in want]).ne(0).any())


def _warp_lower_bound(sorted_slot: np.ndarray, lo: int, hi: int, v: int) -> int:
    """csrc/grouped.cu's warp_lower_bound, its 32 lanes as a vector."""
    lanes = np.arange(32)
    probe = lambda pos: (pos < hi) & (sorted_slot[np.minimum(pos, len(sorted_slot) - 1)] < v)  # noqa: E731
    while hi - lo > 32:
        stride = (hi - lo + 31) // 32
        below = probe(lo + (lanes + 1) * stride - 1)
        k = int(below.sum())
        assert below[:k].all()  # a ballot of a prefix: the vector is sorted
        hi = min(hi, lo + (k + 1) * stride - 1)
        lo += k * stride
    return lo + int(probe(lo + lanes).sum())


def _kernel_emulation(points: np.ndarray, slot: np.ndarray, s: int):
    """K3's arithmetic in NumPy: one stable sort, each slot's run by the
    warp's searches, five float32 columns added from +0.0 in row order."""
    order = np.argsort(slot, kind="stable")
    sorted_slot = slot[order]
    x, y, z = (points[:, k] for k in range(3))
    xx = x * x
    yy = (y.astype(np.float64) * y.astype(np.float64) + xx.astype(np.float64)).astype(np.float32)
    sq = (z.astype(np.float64) * z.astype(np.float64) + yy.astype(np.float64)).astype(np.float32)
    cols = np.column_stack([np.ones_like(x), x, y, z, sq])
    out = np.zeros((s, 5), np.float32)
    n = len(slot)
    for c in range(s):
        start = _warp_lower_bound(sorted_slot, 0, n, c)
        end = _warp_lower_bound(sorted_slot, start, n, c + 1)
        assert (sorted_slot[start:end] == c).all() and np.array_equal(order[start:end], np.sort(order[start:end]))
        run = np.concatenate([np.zeros((1, 5), np.float32), cols[order[start:end]]])
        out[c] = np.add.accumulate(run, axis=0, dtype=np.float32)[-1]
    return torch.from_numpy(out[:, 0]), torch.from_numpy(out[:, 1:4]), torch.from_numpy(out[:, 4])


@pytest.mark.parametrize("name", CASES)
def test_the_kernel_arithmetic_equals_the_plain_version(name):
    points, slot, s = _case(name)
    _same_bits(_kernel_emulation(points.numpy(), slot.numpy(), s), grouped.grouped_sums_plain(points, slot, s))


def test_the_searches_find_every_run_at_the_edges():
    for sorted_slot in (np.array([-5, -1, 0, 0, 1, 3, 3, 3, 9]), np.repeat(np.arange(40), 33), np.full(1000, 7),
                        np.arange(-3, 5000)):
        n = len(sorted_slot)
        for v in (-6, -1, 0, 1, 2, 3, 7, 8, 39, 40, 4999, 5000):
            assert _warp_lower_bound(sorted_slot, 0, n, v) == int(np.searchsorted(sorted_slot, v, "left"))


P, S = torch.zeros(8, 3), torch.zeros(8, dtype=torch.int32)


@pytest.mark.parametrize("case", [
    ("float64 points", (P.double(), S, 4), TypeError),
    ("int64 slots", (P, S.long(), 4), TypeError),
    ("points (N, 2)", (P[:, :2], S, 4), ValueError),
    ("slot (N, 1)", (P, S[:, None], 4), ValueError),
    ("lengths differ", (P[:7], S, 4), ValueError),
    ("slot on another device", (P, S.to("meta"), 4), ValueError),
    ("neither on the CPU nor a card", (P.to("meta"), S.to("meta"), 4), ValueError),
    ("no slots", (P, S, 0), ValueError),
], ids=lambda c: c[0])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(case):
    _, args, err = case
    with pytest.raises(err, match="grouped_sums"):
        grouped.grouped_sums(*args)


@pytest.mark.parametrize("name", ["mixed", "the cell's shape"])
def test_the_counters_count_rows_summed_and_left_out(name):
    points, slot, s = _case(name)
    kept = int(((slot >= 0) & (slot < s)).sum())
    tracer = profiling.enable()
    try:
        grouped.grouped_sums(points, slot, s)
        profiling.flush()
    finally:
        profiling.disable()
    counts = {k: [v for _, v in tracer.counters[k]] for k in ("grouped.rows", "grouped.dropped")}
    assert counts == {"grouped.rows": [kept], "grouped.dropped": [len(slot) - kept]}
    if name == "the cell's shape":
        assert counts["grouped.dropped"][0] > 0.8 * len(slot)


def test_a_scan_is_two_groupings_and_the_instance_one_drops_every_row():
    rng = np.random.default_rng(5)
    n = 4096
    points = torch.from_numpy((rng.normal(size=(n, 3)) * 10).astype(np.float32))
    sem = torch.from_numpy(rng.choice(np.array([10, 11, 13, 15], np.int32), n))
    inst, mask = torch.zeros(n, dtype=torch.int32), torch.from_numpy(np.arange(n) < 4000)
    tracer = profiling.enable()
    try:
        build_graph(points, sem, inst, mask, np.eye(4, dtype=np.float32))
        profiling.flush()
    finally:
        profiling.disable()
    rows = [v for _, v in tracer.counters["grouped.rows"]]
    dropped = [v for _, v in tracer.counters["grouped.dropped"]]
    assert len(rows) == 2 and [r + d for r, d in zip(rows, dropped)] == [n, n]
    assert rows[1] == 0  # no instance ids: the GT grouping keeps no row
