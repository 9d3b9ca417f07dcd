"""B4 ``nn1`` and B5 ``knn``: the port's plain versions against the JAX
Pallas kernels (interpret mode on the CPU, as tests/test_pallas_nn.py runs
them).

The plain versions take the reference's expansion and FMA order (ops/nn.py),
so indices are equal and squared distances bit-equal on every case here.
The CUDA kernels run only on a card, where chip_smoke.py holds them
against these plain versions; here a lane-by-lane NumPy model of the knn
kernel's warp-level selection is held against the plain version too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.ops.pallas_nn import knn as jax_knn, nn1 as jax_nn1
from sgtd_tpu_torch.ops import nn

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
    before = (nn.NN1_LAUNCHES, nn.KNN_LAUNCHES)
    nn.nn1(q, q)
    nn.knn(q, q, 2)
    assert (nn.NN1_LAUNCHES, nn.KNN_LAUNCHES) == before == (0, 0)


def test_non_cpu_tensor_never_falls_back_to_plain():
    q = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors required"):
        nn.nn1(q, q)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        nn.knn(q, q, 2)
