"""Descriptor construction: the port against sgtd_tpu.desc on the same graphs.

Integer outputs (mask, labels, node ids, probe cells and gates) must be
equal; float outputs within 1e-5 (float32 rounding of the same
expressions).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.desc import keys as jax_keys
from sgtd_tpu.desc.keys import probe_cells as jax_probe_cells
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.graph.types import make_graph as jax_make_graph
from sgtd_tpu_torch.desc import keys
from sgtd_tpu_torch.desc.keys import probe_cells
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.interop import config_from_reference, graph_from_numpy

torch.set_num_threads(1)

_INT_FIELDS = ("mask", "labels", "node_ids")
_FLOAT_FIELDS = ("sides", "angles", "vertices", "center")


def _stack(graphs):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *graphs)


def _assert_descriptors_match(got, want):
    for f in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    # Padding slots hold degenerate triangles (angles divide by ~eps):
    # their float values are don't-care, so compare the real descriptors.
    m = np.asarray(want.mask)
    for f in _FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).numpy()[m], np.asarray(getattr(want, f))[m],
            atol=1e-5, rtol=0, err_msg=f,
        )


@pytest.fixture(scope="module")
def graphs(small_config):
    maps, queries, _ = make_map_and_queries(
        small_config, seed=7, num_map_frames=24, num_queries=8,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    return maps + queries


@pytest.mark.parametrize("batching", ["per_graph", "vmapped"])
def test_build_descriptors_matches_reference(graphs, small_config, batching):
    cfg = small_config
    fn = functools.partial(jax_build_descriptors, cfg=cfg.desc, caps=cfg.caps)
    batch = _stack(graphs)
    if batching == "vmapped":
        want = jax.jit(jax.vmap(fn))(batch)
    else:
        want = _stack([fn(g) for g in graphs])
    pcfg = config_from_reference(cfg)
    got = build_descriptors(graph_from_numpy(batch, "cpu"), pcfg.desc, pcfg.caps)
    assert int(got.mask.sum()) > 1000
    _assert_descriptors_match(got, want)


def test_probe_cells_matches_reference(small_config):
    rng = np.random.default_rng(3)
    sides = rng.uniform(0.0, 52.0, (300, 3)).astype(np.float32)
    sides[:50] = np.round(sides[:50])  # on cell boundaries
    sides[50:60] = rng.uniform(-1.0, 0.4, (10, 3))  # below the first cell
    labels = rng.integers(-1, 14, (300, 3)).astype(np.int32)
    want = jax_probe_cells(jnp.asarray(sides), jnp.asarray(labels), small_config.desc)
    got = probe_cells(torch.from_numpy(sides), torch.from_numpy(labels), config_from_reference(small_config).desc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _key_inputs():
    rng = np.random.default_rng(4)
    sides = rng.uniform(0.0, 52.0, (400, 3)).astype(np.float32)
    sides[:50] = np.round(sides[:50])  # on cell boundaries
    sides[50:100] = np.floor(sides[50:100]) + 0.5  # round-half-up ties
    sides[100:110] = rng.uniform(-1.0, 0.4, (10, 3))  # below the first cell
    sides[110:120] = rng.uniform(52.0, 60.0, (10, 3))  # past the last cell
    labels = rng.integers(-1, 14, (400, 3)).astype(np.int32)
    return sides, labels


@pytest.mark.parametrize("fn", ["db_keys", "probe_keys"])
def test_keys_match_reference(small_config, fn):
    """Integer keys (and the probe gate) equal to the reference's."""
    sides, labels = _key_inputs()
    want = getattr(jax_keys, fn)(jnp.asarray(sides), jnp.asarray(labels), small_config.desc)
    got = getattr(keys, fn)(torch.from_numpy(sides), torch.from_numpy(labels), config_from_reference(small_config).desc)
    for g, w in zip(*((got, want) if fn == "probe_keys" else ((got,), (want,)))):
        assert g.dtype == torch.int32 or g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_key_matches_reference():
    rng = np.random.default_rng(5)
    xyz = rng.integers(-3, 60, (3, 500)).astype(np.int32)
    code = rng.integers(0, 2197, 500).astype(np.int32)
    want = jax_keys.pack_key(*(jnp.asarray(v) for v in xyz), jnp.asarray(code), 52)
    got = keys.pack_key(*(torch.from_numpy(v) for v in xyz), torch.from_numpy(code), 52)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["empty_graph", "fewer_nodes_than_near_num"])
def test_build_descriptors_edge_cases(small_config, case):
    rng = np.random.default_rng(5)
    cfg = small_config
    if case == "empty_graph":
        g = jax_make_graph(np.zeros((0, 3)), np.zeros(0), np.eye(4), cfg.caps.max_nodes)
    else:  # 8 node slots < near_num = 10
        g = jax_make_graph(
            rng.uniform(-15, 15, (6, 3)), rng.integers(3, 13, 6), np.eye(4), max_nodes=8
        )
    want = _stack([jax_build_descriptors(g, cfg.desc, cfg.caps)])
    pcfg = config_from_reference(cfg)
    got = build_descriptors(graph_from_numpy(_stack([g]), "cpu"), pcfg.desc, pcfg.caps)
    assert got.mask.shape == np.asarray(want.mask).shape
    _assert_descriptors_match(got, want)
    if case == "empty_graph":
        assert not got.mask.any()
    else:
        assert got.mask.any()
