"""B4 ``nn1`` and B5 ``knn``: the port's plain versions against the JAX
Pallas kernels (interpret mode on the CPU, as tests/test_pallas_nn.py runs
them).

The plain versions take the reference's expansion and FMA order (ops/nn.py),
so indices are equal and squared distances bit-equal on every case here.
The CUDA kernels run only on a card, where chip_smoke.py holds them
against these plain versions; here a lane-by-lane NumPy model of the knn
kernel's warp-level selection is held against the plain version too, and a
step-by-step NumPy model of the nn1 scan (several queries a thread, the
deferred argmin over groups of 16 references, the reference range split
over a block's warps and its combine) against the plain version and the
Pallas kernel at every launch shape the wrapper can choose.
"""

import re
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.ops.pallas_nn import knn as jax_knn, nn1 as jax_nn1
from sgtd_tpu_torch.ops import _build, gicp as gicp_ops, launch_counts, nn

torch.set_num_threads(1)


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        q = rng.uniform(-50, 50, (256, 3))
        r = rng.uniform(-50, 50, (2048, 3))
    elif name == "ties":  # exact duplicates in the refs, queries on them
        r0 = rng.uniform(-20, 20, (300, 3))
        r = np.concatenate([r0, r0[::-1], r0[:50]])
        q = np.concatenate([r0[:100], r0[100:200] + 0.01])
    elif name == "masked":  # displaced masked points, as refine.gicp does
        q = rng.uniform(-50, 50, (128, 3))
        r = rng.uniform(-50, 50, (512, 3))
        q[rng.uniform(size=128) < 0.2] = 1e6
        r[rng.uniform(size=512) < 0.3] = 1e6
    else:  # "odd_rows": no tile divisor (pallas_nn.py:45-49)
        q = rng.uniform(-50, 50, (100, 3))
        r = rng.uniform(-50, 50, (203, 3))
    return q.astype(np.float32), r.astype(np.float32)


CASES = ["random", "ties", "masked", "odd_rows"]


@pytest.mark.parametrize("case", CASES)
def test_nn1_plain_equals_pallas(case):
    q, r = _case(case)
    want_i, want_d = (np.asarray(a) for a in jax_nn1(jnp.asarray(q), jnp.asarray(r)))
    got_i, got_d = nn.nn1(torch.from_numpy(q), torch.from_numpy(r))
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)  # bit-equal


@pytest.mark.parametrize("case", CASES)
def test_knn_plain_equals_pallas(case):
    q, r = _case(case)
    k = 20
    want = np.asarray(jax_knn(jnp.asarray(q), jnp.asarray(r), k))
    got = nn.knn(torch.from_numpy(q), torch.from_numpy(r), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


EDGE_CASES = ["k1", "k20", "k32", "T=k1", "T=k20", "T=k32", "T33", "T1000", "all_equal",
              "masked30_self", "self"]


def _edge_case(name):
    """(query, ref, k) where a k-selection can go wrong: k at its ends, as
    many references as k, reference counts off any tile, one repeated
    point, long runs of equal distances (30% of a cloud at the masked
    coordinate), self queries (zero and negative distances)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cloud = lambda n: rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    if name.startswith("T=k"):
        return cloud(64), cloud(int(name[3:])), int(name[3:])
    if name.startswith("k"):
        return cloud(64), cloud(1000), int(name[1:])
    if name.startswith("T"):
        return cloud(64), cloud(int(name[1:])), 20
    if name == "all_equal":
        r = np.repeat(cloud(1), 100, axis=0)
    elif name == "masked30_self":
        r = cloud(300)
        r[rng.uniform(size=300) < 0.3] = 1e6
    else:  # "self"
        r = cloud(256)
    return r, r, 20


@pytest.mark.parametrize("case", EDGE_CASES)
def test_knn_plain_equals_pallas_on_edge_shapes(case):
    q, r, k = _edge_case(case)
    want = np.asarray(jax_knn(jnp.asarray(q), jnp.asarray(r), k))
    got = nn.knn(torch.from_numpy(q), torch.from_numpy(r), k)
    assert got.dtype == torch.int32 and got.shape == (q.shape[0], k)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "all_equal":
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.arange(k), got.shape))


def _warp_select(d, k):
    """The CUDA kernel's selection (csrc/nn.cu, knn_kernel) on one query's
    float32 distances, lane by lane: the 32 best sorted across a warp, a
    stripe of 32 references a step, the ballot of ``d < threshold``, the
    passing lanes inserted in ascending order by a shift of the tail."""
    inf = np.float32(np.inf)
    ld, li, thr = np.full(32, inf, np.float32), np.zeros(32, np.int32), inf
    lane = np.arange(32)
    for j0 in range(0, len(d), 32):
        stripe = np.full(32, inf, np.float32)
        stripe[: len(d) - j0] = d[j0 : j0 + 32]
        for src in np.nonzero(stripe < thr)[0]:
            cd = stripe[src]
            if cd < thr:
                ud, ui = np.roll(ld, 1), np.roll(li, 1)  # shfl_up: lane 0 keeps its own
                ud[0], ui[0] = ld[0], li[0]
                move = ld > cd
                here = move & ((lane == 0) | (ud <= cd))
                ld = np.where(here, cd, np.where(move, ud, ld))
                li = np.where(here, j0 + src, np.where(move, ui, li))
                thr = ld[k - 1]
    return li[:k]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_knn_warp_selection_model_equals_plain(case):
    q, r, k = _edge_case(case)
    q = q[:: max(1, len(q) // 8)]  # a few queries: the model is a Python loop
    d = nn.sq_dists_plain(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    want = nn.knn_plain(torch.from_numpy(q), torch.from_numpy(r), k).numpy()
    got = np.stack([_warp_select(row, k) for row in d])
    np.testing.assert_array_equal(got, want)


def test_knn_warp_selection_orders_as_floats_and_breaks_ties_by_index():
    tiny = np.float32(1e-45)  # subnormal
    d = np.array([0.0, 3e38, -0.0, tiny, 1.0, -1e-7, 0.0, -tiny, 1.0, -1e-7, 3e38, -0.0] * 4, np.float32)
    for k in (1, 5, 32):
        np.testing.assert_array_equal(_warp_select(d, k), np.argsort(d, kind="stable")[:k])
    # -0.0 and +0.0 are one distance: the index decides.
    np.testing.assert_array_equal(_warp_select(np.array([0.0, -0.0, 0.0, -0.0], np.float32), 4), np.arange(4))


def test_self_knn_and_ties_pick_lowest_index():
    q, r = _case("ties")
    idx, d = nn.nn1(torch.from_numpy(q[:100]), torch.from_numpy(r))
    # Queries 0..99 sit exactly on r0[i], duplicated at 599 - i and 600 + i.
    np.testing.assert_array_equal(idx.numpy(), np.arange(100))
    got = nn.knn(torch.from_numpy(r), torch.from_numpy(r), 3)
    want = np.asarray(jax_knn(jnp.asarray(r), jnp.asarray(r), 3))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:50, 0] == torch.arange(50)).all()


def test_leading_batch_axis_matches_vmapped_pallas():
    rng = np.random.default_rng(3)
    q = rng.uniform(-50, 50, (2, 3, 64, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (2, 3, 96, 3)).astype(np.float32)
    flat = lambda a: jnp.asarray(a.reshape((6,) + a.shape[2:]))
    wi, wd = jax.vmap(jax_nn1)(flat(q), flat(r))
    wk = jax.vmap(lambda a, b: jax_knn(a, b, 5))(flat(q), flat(r))
    gi, gd = nn.nn1(torch.from_numpy(q), torch.from_numpy(r))
    gk = nn.knn(torch.from_numpy(q), torch.from_numpy(r), 5)
    assert gi.shape == (2, 3, 64) and gk.shape == (2, 3, 64, 5)
    np.testing.assert_array_equal(gi.reshape(6, 64).numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.reshape(6, 64).numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gk.reshape(6, 64, 5).numpy(), np.asarray(wk))


def test_plain_blocks_give_the_unblocked_result(monkeypatch):
    q, r = _case("random")
    whole = nn.nn1(torch.from_numpy(q), torch.from_numpy(r))
    whole_k = nn.knn(torch.from_numpy(q), torch.from_numpy(r), 4)
    monkeypatch.setattr(nn, "_PLAIN_BLOCK", 3000)  # several rows per block
    blocked = nn.nn1(torch.from_numpy(q), torch.from_numpy(r))
    monkeypatch.setattr(nn, "_PLAIN_BLOCK", 100)  # one row per block
    blocked_k = nn.knn(torch.from_numpy(q), torch.from_numpy(r), 4)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)
    assert torch.equal(whole_k, blocked_k)


def test_knn_rejects_k_above_ref_count_and_cpu_never_launches():
    q = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="k=5"):
        nn.knn(q, q, 5)
    before = launch_counts()[3:5]
    nn.nn1(q, q)
    nn.knn(q, q, 2)
    assert launch_counts()[3:5] == before == [0, 0]


def test_non_cpu_tensor_never_falls_back_to_plain():
    q = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors required"):
        nn.nn1(q, q)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        nn.knn(q, q, 2)


# --- the nn1 scan of csrc/nn_common.cuh (B4, and B7's correspondences). ---

GROUP, TILE = 16, 1024  # kGroup, kTile
INF = np.float32(np.inf)


def _scan_model(d, queries, warps):
    """``nearest`` of csrc/nn_common.cuh on one problem's float32 distances
    d (N, T), step for step: blocks of 32 x ``queries`` slots; tiles of
    1,024 references padded to whole groups of 16 with +inf; warp w takes
    groups w, w + warps, ... of every tile, folds a group with fminf and
    records the group's number where its minimum is < the warp's running
    one; the warps' (minimum, group) pairs are combined by (smaller minimum,
    then lower group); thread t rescans slot t's winning group in ascending
    index with a strict <. Returns (idx (N,), sqd (N,))."""
    n, t = d.shape
    slots = 32 * queries
    out_i, out_d = np.zeros(n, np.int32), np.full(n, INF, np.float32)
    with np.errstate(invalid="ignore"):
        for n0 in range(0, n, slots):
            rows = d[n0 : n0 + slots]
            best = np.full((warps, len(rows)), INF, np.float32)
            grp = np.zeros((warps, len(rows)), np.int32)
            for base in range(0, t, TILE):
                length = min(TILE, t - base)
                groups = -(-length // GROUP)
                tile = np.full((len(rows), groups * GROUP), INF, np.float32)
                tile[:, :length] = rows[:, base : base + length]
                for w in range(warps):
                    for g in range(w, groups, warps):
                        m = tile[:, g * GROUP]
                        for i in range(1, GROUP):
                            m = np.fmin(m, tile[:, g * GROUP + i])  # fminf: a NaN loses
                        hit = m < best[w]
                        best[w] = np.where(hit, m, best[w])
                        grp[w] = np.where(hit, base // GROUP + g, grp[w])
            b, g_win = np.full(len(rows), INF, np.float32), np.zeros(len(rows), np.int32)
            for w in range(warps):
                take = (best[w] < b) | ((best[w] == b) & (grp[w] < g_win))
                b, g_win = np.where(take, best[w], b), np.where(take, grp[w], g_win)
            for s in range(len(rows)):
                for j in range(g_win[s] * GROUP, min((g_win[s] + 1) * GROUP, t)):
                    if rows[s, j] < out_d[n0 + s]:
                        out_d[n0 + s], out_i[n0 + s] = rows[s, j], j
    return out_i, out_d


def _sequential(d):
    """A running minimum over ascending indices with a strict <."""
    out_i, out_d = np.zeros(len(d), np.int32), np.full(len(d), INF, np.float32)
    with np.errstate(invalid="ignore"):
        for s, row in enumerate(d):
            for j, v in enumerate(row):
                if v < out_d[s]:
                    out_d[s], out_i[s] = v, j
    return out_i, out_d


# Every launch shape scan_plan can choose: 4 or 1 queries a thread, and a
# block of 4, 8 or 16 warps that split the reference range.
PLANS = [(q, w) for q in (nn.SCAN_WIDE_QUERIES, 1) for w in (4, 8, 16)]
SCAN_CASES = ["duplicates", "all_equal", "masked", "ragged", "T1", "two_tiles", "T7"]


def _scan_case(name):
    """(query, ref): planted duplicates; one repeated point; masked points
    at 1e6 on both sides; N and T that divide neither group, tile nor any
    split; one reference; a reference range that crosses a tile with a
    ragged tail; fewer references than a group."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cloud = lambda n: rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    if name == "duplicates":
        r0 = cloud(300)
        return np.concatenate([r0[:100], r0[100:140] + 0.01]), np.concatenate([r0, r0[::-1], r0[:50]])
    if name == "all_equal":
        return cloud(40), np.repeat(cloud(1), 100, axis=0)
    if name == "masked":
        q, r = cloud(130), cloud(515)
        q[rng.uniform(size=130) < 0.2] = 1e6
        r[rng.uniform(size=515) < 0.3] = 1e6
        return q, r
    n, t = {"ragged": (37, 203), "T1": (33, 1), "two_tiles": (5, 1029), "T7": (3, 7)}[name]
    return cloud(n), cloud(t)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_nn1_scan_model_equals_plain_and_pallas(case):
    q, r = _scan_case(case)
    want_i, want_d = (x.numpy() for x in nn.nn1_plain(torch.from_numpy(q), torch.from_numpy(r)))
    jax_i, jax_d = (np.asarray(a) for a in jax_nn1(jnp.asarray(q), jnp.asarray(r)))
    np.testing.assert_array_equal(want_i, jax_i)
    np.testing.assert_array_equal(want_d.view(np.int32), jax_d.view(np.int32))
    d = nn.sq_dists_plain(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    for queries, warps in PLANS:
        got_i, got_d = _scan_model(d, queries, warps)
        np.testing.assert_array_equal(got_i, want_i, err_msg=f"{queries} queries, {warps} warps")
        np.testing.assert_array_equal(got_d.view(np.int32), want_d.view(np.int32))
    if case == "all_equal":
        assert not want_i.any()


def test_nn1_scan_model_orders_as_floats_and_keeps_the_winner_bits():
    """+0.0 and -0.0 are one distance (the lower index wins and its own
    sign comes out), a NaN never wins, a row of NaN or +inf gives (+inf,
    0), subnormal and negative distances order as floats: the model and a
    sequential scan agree bit for bit at every launch shape."""
    tiny, nan = np.float32(1e-45), np.float32(np.nan)
    rows = [
        [0.0, -0.0, 0.0, -0.0], [-0.0, 0.0, 1.0, -0.0], [5.0, 3.0, nan, 3.0, 0.0, -0.0, nan],
        [nan] * 9, [INF] * 9, [nan, INF, nan, 7.0], [tiny, 0.0, -tiny, -tiny, 1e-7, -1e-7],
        [3e38, -3e38, 3e38, -3e38], [1.0] * 20 + [-0.0] + [1.0] * 20 + [0.0],
    ]
    rng = np.random.default_rng(4)
    long = rng.uniform(0, 1, 2100).astype(np.float32)
    long[[5, 1030, 2099]] = -0.0  # the minimum three times, a tile apart
    long[1500] = 0.0
    for row in rows + [long]:
        # The same distances at every slot of two blocks, shifted a slot
        # each, so every lane and warp meets every position.
        row = np.asarray(row, np.float32)
        d = np.stack([np.roll(row, s) for s in range(min(len(row), 40))])
        want_i, want_d = _sequential(d)
        for queries, warps in PLANS:
            got_i, got_d = _scan_model(d, queries, warps)
            np.testing.assert_array_equal(got_i, want_i, err_msg=f"{queries} queries, {warps} warps")
            np.testing.assert_array_equal(got_d.view(np.int32), want_d.view(np.int32))


def _exact_f32(x: Fraction) -> np.float32:
    """x rounded once to float32 (x must be exact in float64)."""
    assert Fraction(float(x)) == x
    return np.float32(float(x))


def test_distance_tail_as_one_fma_has_the_same_bits():
    """fma(-2, c, s) == s - 2 * c in float32: doubling is exact, so both
    round the exact s - 2c once. Random, equal-magnitude (cancelling) and
    subnormal operands, the fused form evaluated exactly in rationals."""
    rng = np.random.default_rng(9)
    s = rng.uniform(0, 2e4, 4000).astype(np.float32)
    c = (s / 2 * rng.uniform(0.99, 1.01, 4000)).astype(np.float32)  # d near 0, either sign
    s = np.concatenate([s, rng.uniform(-1, 1, 2000).astype(np.float32) * np.float32(1e-38)])
    c = np.concatenate([c, rng.uniform(-1, 1, 2000).astype(np.float32) * np.float32(3e-39)])
    assert (np.abs(c[-2000:]) < np.finfo(np.float32).tiny).any()  # subnormal products among them
    two_step = s - np.float32(2.0) * c  # float32 throughout: FMUL by 2, FSUB
    fused = np.array([_exact_f32(Fraction(float(a)) - 2 * Fraction(float(b))) for a, b in zip(s, c)])
    np.testing.assert_array_equal(two_step.view(np.int32), fused.view(np.int32))
    # The plain version's tail is that two-step form.
    q = torch.tensor([[[1.5, -2.25, 3.0]]])
    r = torch.tensor([[[0.5, 4.0, -1.0]]])
    assert float(nn.sq_dists_plain(q, r)) == float(((q - r) ** 2).sum())


def _header_constants():
    text = (_build.CSRC / "nn_common.cuh").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_scan_plan_mirrors_the_header_and_has_no_problem_limit():
    """The wrappers' grid arithmetic, a pure function: the constants are the
    header's, the rerank's shapes get the launch shapes the kernels were
    measured at, 70,000 and 2^20 problems fit the grid, and only more than
    2^31 - 1 blocks raise."""
    k = _header_constants()
    assert (k["kWideQueries"], k["kWideBlocks"], k["kMinWarps"], k["kMaxWarps"], k["kWarpsWanted"]) == (
        nn.SCAN_WIDE_QUERIES, nn.SCAN_WIDE_BLOCKS, nn.SCAN_MIN_WARPS, nn.SCAN_MAX_WARPS, nn.SCAN_WARPS_WANTED)
    assert (k["kGroup"], k["kTile"]) == (GROUP, TILE)
    assert not hasattr(nn, "MAX_PROBLEMS") and not hasattr(gicp_ops, "MAX_PROBLEMS")
    assert nn.scan_plan(64, 1024) == (4, 8, 512)  # a chunk of 16 queries x 4 candidates
    assert nn.scan_plan(160, 1024) == (4, 4, 1280)  # the hard world's 10 candidates
    assert nn.scan_plan(4, 1024) == (1, 16, 128)  # one query: a block for (nearly) every SM
    assert nn.scan_plan(70000, 8) == (1, 4, 70000)
    assert nn.scan_plan(1 << 20, 8) == (1, 4, 1 << 20)
    for p, n in [(1, 1), (3, 31), (5, 33), (16, 1024), (33, 1024), (132, 128), (131, 128), (2, 100000)]:
        queries, warps, blocks = nn.scan_plan(p, n)
        assert queries in (1, nn.SCAN_WIDE_QUERIES) and blocks == p * -(-n // (32 * queries))
        assert warps in (4, 8, 16) and 32 * queries <= 32 * warps  # thread t resolves slot t
        assert blocks * warps >= nn.SCAN_WARPS_WANTED or warps == nn.SCAN_MAX_WARPS
        assert warps == nn.SCAN_MIN_WARPS or blocks * warps // 2 < nn.SCAN_WARPS_WANTED
        if queries == nn.SCAN_WIDE_QUERIES:
            assert blocks >= nn.SCAN_WIDE_BLOCKS and n >= 32 * queries
        # B7's scratch holds a row for every block of a problem at either width.
        assert -(-n // 32) >= blocks // p
    for name in ("nn1", "linearize_gicp"):
        nn.check_scan_grid(name, 70000, 8)
        nn.check_scan_grid(name, 1 << 20, 1024)
        nn.check_scan_grid(name, (1 << 31) - 1, 32)
        with pytest.raises(ValueError, match=f"{name}: .* exceed the kernel's grid"):
            nn.check_scan_grid(name, 1 << 28, 1024)
        with pytest.raises(ValueError, match="exceed the kernel's grid"):
            nn.check_scan_grid(name, 1 << 31, 32)


def test_nn1_takes_more_problems_than_a_grid_axis_holds():
    """70,000 problems (more than 65,535): the plain version here, and the
    CUDA wrapper's own checks pass the count on (a meta tensor stops at the
    device check, not at a problem limit)."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.uniform(-5, 5, (70000, 2, 3)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(-5, 5, (70000, 5, 3)).astype(np.float32))
    idx, sqd = nn.nn1(q, r)
    assert idx.shape == sqd.shape == (70000, 2)
    for p in (0, 31337, 69999):
        one_i, one_d = nn.nn1(q[p], r[p])
        assert torch.equal(idx[p], one_i) and torch.equal(sqd[p], one_d)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        nn._nn1_cuda(q.to("meta"), r.to("meta"))
