"""The port's FEC (``cluster.fec``) against sgtd_tpu's on tests/test_fec.py's
clouds, on the CPU, where B5 (``ops.nn.knn``) takes its plain version and
the reference's Pallas ``knn`` runs in interpret mode. Labels and counts
are equal, and so are the neighbour lists of FEC's one (N, N) problem,
whose padded points all sit at 1e6 m and tie (the lowest index wins)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtd_tpu.cluster.fec import fec_cluster as jax_fec
from sgtd_tpu.ops import pallas_nn
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.cluster import fec
from sgtd_tpu_torch.ops import nn

torch.set_num_threads(1)


def _blobs(rng, centers, per, spread=0.3):
    return np.concatenate([c + rng.normal(0, spread, (per, 3)) for c in centers]).astype(np.float32)


def _cloud(name):
    """(points (N, 3), mask (N,), tolerance, min size, max_n)."""
    rng = np.random.default_rng(0)
    if name == "separated_blobs":
        pts, n, args = _blobs(rng, np.array([[0, 0, 0], [20, 0, 0], [0, 25, 0], [15, 15, 5]]), 60), 256, (2.0, 10, 16)
    elif name == "min_size_filter":
        pts = np.concatenate([_blobs(rng, np.zeros((1, 3)), 50), _blobs(rng, np.array([[30, 0, 0]]), 5)])
        n, args = 64, (2.0, 10, 16)
    elif name == "single_linkage":
        pts, n, args = rng.uniform(0, 30, (120, 3)).astype(np.float32), 128, (3.0, 1, 64)
    elif name == "empty":
        pts, n, args = np.zeros((0, 3), np.float32), 64, (1.0, 5, 16)
    elif name.startswith("max_n"):
        # Dense clumps along x: max_n 16 binds (the component splits), 64 not.
        pts = _blobs(rng, np.array([[0.5 * i, 0.0, 0.0] for i in range(8)]), 32, 0.05)
        n, args = 256, (0.6, 10, int(name.split("_")[-1]))
    else:
        assert name == "many_clusters"
        pts, n, args = _blobs(rng, rng.uniform(-30, 30, (40, 3)), 50, 0.5), 4096, (1.0, 5, 16)
    cloud = np.zeros((n, 3), np.float32)
    mask = np.zeros(n, bool)
    cloud[: len(pts)] = pts
    mask[: len(pts)] = True
    return cloud, mask, *args


CASES = ["separated_blobs", "min_size_filter", "single_linkage", "empty", "max_n_16", "max_n_64", "many_clusters"]


@pytest.mark.parametrize("name", CASES)
def test_fec_equals_reference(name, monkeypatch):
    cloud, mask, tol, min_size, max_n = _cloud(name)
    want = jax_fec(jnp.asarray(cloud), jnp.asarray(mask), tol, min_size, max_n=max_n)
    calls = []
    knn = nn.knn
    monkeypatch.setattr(nn, "knn", lambda q, r, k: calls.append(k) or knn(q, r, k))
    got = fec.fec_cluster(torch.from_numpy(cloud), torch.from_numpy(mask), tol, min_size, max_n=max_n)
    assert calls == [max_n]  # one B5 call, the (N, N) problem
    for g, w, field in zip(got, want, fec.FecResult._fields):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), field
    as_port = interop.fec_result_from_numpy(want, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(as_port, got))
    n_clusters = int((got.counts > 0).sum())
    assert n_clusters == {"separated_blobs": 4, "min_size_filter": 1, "empty": 0, "max_n_64": 1,
                          "many_clusters": 40}.get(name, n_clusters)
    if name == "max_n_16":
        assert n_clusters > 1


@pytest.mark.parametrize("name", ["separated_blobs", "many_clusters"])
def test_fec_neighbours_equal_reference(name):
    """B5's input on FEC's path: the padded cloud against itself, far points
    and all; the lists equal the reference kernel's (interpret mode)."""
    cloud, mask, _, _, max_n = _cloud(name)
    eff = np.where(mask[:, None], cloud, np.float32(1e6))
    want = np.asarray(pallas_nn.knn(jnp.asarray(eff), jnp.asarray(eff), max_n))
    got = nn.knn(torch.from_numpy(eff), torch.from_numpy(eff), max_n).numpy()
    assert np.array_equal(got, want)
    pad = ~mask
    assert (got[pad][:, 0] == np.nonzero(pad)[0][0]).all()  # ties among far points: the lowest index first
