"""The port's NDT (``refine.ndt``), Bertsekas auction and legacy graph
matcher (``match.graph_match``) and LAPJV (``match.lapjv``) against
sgtd_tpu's on the same seeded inputs, on the CPU.

Assignments and matches are equal. NDT maps: keys, means, validity and the
voxel size equal bit for bit (the covariances too, with XLA's fused
multiply-adds); the information matrices within 2e-4 of each voxel's
largest entry, because the port's closed-form eigen-decomposition
(``ops.linalg3.sym_eig3x3``, float32 Cardano) and the einsum that rebuilds
the regularized covariance round differently from XLA's, and the nearly
equal eigenvalues of a planar voxel magnify that (2e-6 at 2 m voxels,
9.4e-5 at 4 m). The aligned
transforms agree within 1e-5 (metres and rotation entries), the scores
within a relative 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtd_tpu.geom import se3 as jse3
from sgtd_tpu.match import graph_match as jgm
from sgtd_tpu.match.lapjv import lapjv as jax_lapjv
from sgtd_tpu.refine import ndt as jndt
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.match import graph_match
from sgtd_tpu_torch.match.lapjv import lapjv
from sgtd_tpu_torch.refine import build_ndt_map, ndt_align

torch.set_num_threads(1)


def _scene(rng, n=2048):
    """tests/test_ndt.py's ground plane and three walls."""
    n_g = n // 2
    ground = np.column_stack([rng.uniform(-20, 20, n_g), rng.uniform(-20, 20, n_g), rng.normal(0, 0.03, n_g)])
    walls = []
    n_w = n - n_g
    for i, (cx, cy, ax) in enumerate([(10, 0, 0), (-5, 8, 1), (0, -12, 0)]):
        k = n_w // 3 if i < 2 else n_w - 2 * (n_w // 3)
        u, z = rng.uniform(-6, 6, k), rng.uniform(0, 4, k)
        if ax == 0:
            walls.append(np.column_stack([np.full(k, cx) + rng.normal(0, 0.03, k), cy + u, z]))
        else:
            walls.append(np.column_stack([cx + u, np.full(k, cy) + rng.normal(0, 0.03, k), z]))
    return np.concatenate([ground] + walls).astype(np.float32)


@pytest.fixture(scope="module")
def ndt_case():
    tgt = _scene(np.random.default_rng(7))
    mask = np.ones(len(tgt), bool)
    mask[-40:] = False
    xi = np.array([0.4, -0.3, 0.05, 0.01, -0.02, 0.04], np.float32)
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Tinv = np.linalg.inv(T_true)
    src = (tgt @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
    return tgt, mask, src, T_true


@pytest.mark.parametrize("voxel_size,max_voxels", [(2.0, 4096), (4.0, 64)])
def test_ndt_map_equals_reference(ndt_case, voxel_size, max_voxels):
    tgt, mask, _, _ = ndt_case
    want = jndt.build_ndt_map(jnp.asarray(tgt), jnp.asarray(mask), voxel_size=voxel_size, max_voxels=max_voxels)
    got = build_ndt_map(torch.from_numpy(tgt), torch.from_numpy(mask), voxel_size=voxel_size, max_voxels=max_voxels)
    for f in ("keys", "mean", "valid", "voxel_size"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    w_info, g_info = np.asarray(want.info), got.info.numpy()
    scale = np.abs(w_info).reshape(-1, 9).max(1)[:, None, None]
    assert (np.abs(g_info - w_info) <= 2e-4 * scale).all()
    assert int(got.valid.sum()) > (50 if max_voxels > 64 else 20)


def test_ndt_align_equals_reference(ndt_case):
    tgt, mask, src, T_true = ndt_case
    m = jnp.asarray(mask)
    ref_map = jndt.build_ndt_map(jnp.asarray(tgt), m, voxel_size=2.0, max_voxels=4096)
    want = jndt.ndt_align(jnp.asarray(src), m, ref_map, jnp.eye(4, dtype=jnp.float32))
    port_map = build_ndt_map(torch.from_numpy(tgt), torch.from_numpy(mask), voxel_size=2.0, max_voxels=4096)
    for ndt in (port_map, interop.ndt_map_from_numpy(ref_map, "cpu")):
        got = ndt_align(torch.from_numpy(src), torch.from_numpy(mask), ndt, torch.eye(4))
        assert np.abs(got.transform.numpy() - np.asarray(want.transform)).max() <= 1e-5
        assert abs(float(got.score) - float(want.score)) <= 1e-5 * abs(float(want.score))
    T = got.transform.numpy()
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.1
    assert np.linalg.norm(T[:3, :3] - T_true[:3, :3]) < 0.02


def test_auction_equals_reference():
    rng = np.random.default_rng(42)
    for n, m in ((12, 15), (12, 15), (8, 8), (20, 31), (5, 9)):
        cost = rng.uniform(0, 10, (n, m)).astype(np.float32)
        valid = rng.uniform(size=n) < 0.9
        cost[rng.uniform(size=(n, m)) < 0.1] = 1e9  # forbidden pairs
        want = np.asarray(jgm.auction_assignment(jnp.asarray(cost), jnp.asarray(valid)))
        got = graph_match.auction_assignment(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert (got[~valid] == -1).all()


def _graph(seed, n_max=32, k=20, extent=40.0):
    r = np.random.default_rng(seed)
    centers = np.zeros((n_max, 3), np.float32)
    centers[:k] = r.uniform(-extent, extent, (k, 3))
    labels = np.zeros(n_max, np.int32)
    labels[:k] = r.integers(3, 12, k)
    density = np.zeros(n_max, np.float32)
    density[:k] = r.uniform(0.5, 2.0, k)
    mask = np.zeros(n_max, bool)
    mask[:k] = True
    return centers, labels, density, mask


def _moved(g, seed):
    r = np.random.default_rng(seed)
    return (g[0] + r.normal(0, 0.3, g[0].shape).astype(np.float32), g[1], g[2], g[3])


@pytest.mark.parametrize("pair", ["identical", "unrelated", "noisy", "wide"])
def test_graph_match_equals_reference(pair):
    """tests/test_graph_match.py's identical and unrelated graphs, one with
    noisy centres, and one spread past the 50 m gate."""
    a = _graph(1, extent=70.0 if pair == "wide" else 40.0)
    b = {"identical": a, "unrelated": _graph(99), "noisy": _moved(a, 5), "wide": _moved(a, 6)}[pair]
    want = jgm.graph_match(*(jnp.asarray(x) for x in a), *(jnp.asarray(x) for x in b))
    got = graph_match.graph_match(*(torch.from_numpy(x) for x in a), *(torch.from_numpy(x) for x in b))
    assert np.array_equal(got.matches.numpy(), np.asarray(want.matches))
    assert got.matches.dtype == torch.int32 and float(got.score) == float(want.score)
    hist_w = jgm.node_histograms(*(jnp.asarray(x) for x in (a[0], a[1], a[3])))
    hist_g = graph_match.node_histograms(*(torch.from_numpy(x) for x in (a[0], a[1], a[3])))
    assert np.array_equal(hist_g.numpy(), np.asarray(hist_w))
    if pair == "identical":
        assert float(got.score) > 0.9
    if pair == "unrelated":
        assert float(got.score) < 0.5


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(1, 1), (5, 5), (20, 20), (7, 13), (32, 64)])
def test_lapjv_equals_reference(seed, shape):
    """tests/test_lapjv.py's cases: the same assignment both ways and the
    same total as the reference's."""
    cost = np.random.default_rng(seed).uniform(0, 10, shape)
    got, want = lapjv(cost), jax_lapjv(cost)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]) and got[2] == want[2]


def test_lapjv_ties_and_bad_shapes():
    cost = np.random.default_rng(3).integers(0, 4, (16, 16)).astype(float)
    got, want = lapjv(cost), jax_lapjv(cost)
    assert np.array_equal(got[0], want[0]) and got[2] == want[2]
    with pytest.raises(ValueError):
        lapjv(np.zeros((3, 2)))
    with pytest.raises(ValueError):
        lapjv(np.zeros(3))
