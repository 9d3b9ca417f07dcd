"""Plain PyTorch versions of the port's kernels against the JAX kernels.

The CUDA kernels (sgtd_tpu_torch/csrc) run only on a card; there
chip_smoke.py holds each against the plain version tested here. On the
CPU each wrapper takes its plain version, and these tests require it to
equal the JAX package's kernel exactly (Pallas in interpret mode, as the
package's own tests run it).
"""

import contextlib
import ctypes
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.ops.pallas_expand import expand_jobs as jax_expand_jobs
from sgtd_tpu.ops.pallas_probe import frame_votes as jax_frame_votes
from sgtd_tpu.ops.pallas_verify import hypothesis_votes as jax_hypothesis_votes
from sgtd_tpu_torch.ops import _build, expand, launch_counts, probe, reset_launch_counts, verify

torch.set_num_threads(1)


@pytest.mark.parametrize("f_pad", [8, 208, 1024, 2048])
def test_frame_votes_matches_pallas(f_pad):
    rng = np.random.default_rng(f_pad)
    l = 5000
    hit = rng.uniform(size=l) < 0.3
    # Sentinel ids (== f_pad) must contribute nothing.
    frame = rng.integers(0, f_pad + 1, size=l, dtype=np.int32)
    want = np.asarray(jax_frame_votes(jnp.asarray(hit), jnp.asarray(frame), f_pad))
    got = probe.frame_votes(torch.from_numpy(hit)[None], torch.from_numpy(frame)[None], f_pad)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), want)


def _jax_expand_formulation(length, payload, l_max):
    """match.search's XLA path (search.py:261-265), one channel at a time."""
    length = jnp.asarray(length)
    heads = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(length, dtype=jnp.int32)]
    )[:-1]

    def one(per_job):
        delta = jnp.concatenate([per_job[:1], per_job[1:] - per_job[:-1]])
        buf = jnp.zeros(l_max, jnp.int32).at[heads].add(delta, mode="drop")
        return jnp.cumsum(buf)

    return np.stack([np.asarray(one(jnp.asarray(payload[:, c]))) for c in range(payload.shape[1])])


def _expand_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    nj, l_max = 700, 8192
    if name.startswith("skewed"):
        seed = int(name[-1])
        l_max = 16384 if seed == 1 else 8192
        length = np.where(
            rng.uniform(size=nj) < 0.6,
            0,
            rng.pareto(1.2, nj).astype(np.int32) * (40 if seed == 2 else 8) + 1,
        )
        payload = rng.integers(0, 1 << 24, (nj, 4), dtype=np.int32)
    elif name == "all_empty":
        length = np.zeros(100)
        payload = np.arange(400, dtype=np.int32).reshape(100, 4)
    elif name == "giant_job":
        length = np.zeros(64)
        length[3] = l_max + 500
        payload = np.full((64, 2), 7, np.int32)
        payload[3] = (123, 456)
    else:  # "negative": any sign, as the port's row-base channel carries
        length = np.where(rng.uniform(size=nj) < 0.5, 0, rng.integers(1, 30, nj))
        payload = rng.integers(-(1 << 30), 1 << 30, (nj, 5), dtype=np.int32)
    return length.astype(np.int32), payload, l_max


@pytest.mark.parametrize(
    "case", ["skewed0", "skewed1", "skewed2", "all_empty", "giant_job", "negative"]
)
def test_expand_jobs_matches_reference(case):
    length, payload, l_max = _expand_case(case)
    got = expand.expand_jobs(
        torch.from_numpy(length)[None], torch.from_numpy(payload)[None], l_max
    )[0].numpy()
    assert got.shape == (payload.shape[1], l_max)
    # The plain version IS the XLA formulation: equal on every slot.
    np.testing.assert_array_equal(got, _jax_expand_formulation(length, payload, l_max))
    # The Pallas kernel (values in [0, 2^24) only) agrees on valid slots.
    if payload.min() >= 0:
        total = min(int(length.sum()), l_max)
        want = np.asarray(jax_expand_jobs(jnp.asarray(length), jnp.asarray(payload), l_max))
        np.testing.assert_array_equal(got[:, :total], want[:, :total])
    if case == "giant_job":
        np.testing.assert_array_equal(got[0], np.full(l_max, 123))


def _rand_rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(n, 3, 3)


def test_hypothesis_votes_matches_pallas():
    rng = np.random.default_rng(11)
    c, h, p, thr = 7, 50, 64, 3.0
    rot = _rand_rot(rng, c * h).reshape(c, h, 3, 3).astype(np.float32)
    t = rng.normal(0, 5, (c, h, 3)).astype(np.float32)
    vq = rng.normal(0, 10, (c, p, 3, 3)).astype(np.float32)
    vdb = rng.normal(0, 10, (c, p, 3, 3)).astype(np.float32)
    for ci in range(c):  # half the pairs near hypothesis 0
        moved = vq[ci, : p // 2] @ rot[ci, 0].T + t[ci, 0]
        vdb[ci, : p // 2] = moved + rng.normal(0, 1.5, moved.shape)
    valid = rng.uniform(size=(c, p)) > 0.2
    want = np.asarray(
        jax_hypothesis_votes(*(jnp.asarray(a) for a in (rot, t, vq, vdb, valid)), thr)
    )
    got = verify.hypothesis_votes(*(torch.from_numpy(a) for a in (rot, t, vq, vdb, valid)), thr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] > 0).all()  # the planted hypothesis collects votes


def test_cpu_tensors_take_plain_versions_without_launching():
    before = launch_counts()[:3]
    probe.frame_votes(torch.ones(1, 16, dtype=torch.bool), torch.zeros(1, 16, dtype=torch.int32), 8)
    expand.expand_jobs(torch.ones(1, 4, dtype=torch.int32), torch.zeros(1, 4, 2, dtype=torch.int32), 8)
    verify.hypothesis_votes(
        torch.eye(3).expand(1, 2, 3, 3), torch.zeros(1, 2, 3), torch.zeros(1, 4, 3, 3),
        torch.zeros(1, 4, 3, 3), torch.ones(1, 4, dtype=torch.bool), 3.0,
    )
    assert launch_counts()[:3] == before == [0, 0, 0]


def test_non_cpu_tensor_never_falls_back_to_plain():
    """Off the CPU a wrapper launches its kernel or raises: a meta tensor
    (no CUDA) must raise, not take the plain version."""
    with pytest.raises(ValueError, match="CUDA tensors required"):
        probe.frame_votes(
            torch.ones(1, 16, dtype=torch.bool, device="meta"),
            torch.zeros(1, 16, dtype=torch.int32, device="meta"), 8,
        )
    with pytest.raises(ValueError, match="CUDA tensors required"):
        expand.expand_jobs(
            torch.ones(1, 4, dtype=torch.int32, device="meta"),
            torch.zeros(1, 4, 2, dtype=torch.int32, device="meta"), 8,
        )


def test_library_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "missing" / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library()
    finally:
        _build.library.cache_clear()
    assert not (tmp_path / "build").exists()


_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _c_kind(param: str):
    """The ctypes type a C parameter declaration binds to."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.split()[:-1]  # drop the name
    if words[-2:] == ["long", "long"]:
        return ctypes.c_longlong
    return {"int": ctypes.c_int, "float": ctypes.c_float}[words[-1]]


def _declared_entry_points():
    found = {}
    for name in _build.sources():
        for entry, params in _ENTRY.findall((_build.CSRC / name).read_text()):
            assert entry not in found, f"{entry} defined twice"
            found[entry] = tuple(_c_kind(p) for p in params.split(","))
    return found


_SIGNATURES = {name: argtypes for name, _, argtypes in _build.KERNELS}


def test_sources_and_headers_exist_and_includes_are_hashed():
    for name in _build.sources() + _build.HEADERS:
        assert (_build.CSRC / name).is_file(), name
    on_disk = {p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert on_disk == set(_build.sources() + _build.HEADERS)
    for name in _build.sources():
        local = re.findall(r'#include "([^"]+)"', (_build.CSRC / name).read_text())
        assert set(local) <= set(_build.HEADERS), (name, local)


def test_entry_points_of_the_sources_are_the_bound_signatures():
    assert set(_declared_entry_points()) == set(_SIGNATURES)


@pytest.mark.parametrize("entry", sorted(_SIGNATURES))
def test_signature_matches_the_c_declaration(entry):
    """Same number of parameters, and pointer / int / float / long long
    kinds in order: a mismatch would show only as a crash on the card."""
    assert _declared_entry_points()[entry] == _SIGNATURES[entry]
    assert _SIGNATURES[entry][-1] is ctypes.c_void_p  # the stream, which launch() appends


def test_the_kernel_table_holds_b1_to_b8_then_k1_to_k3():
    """The table's order is launch_counts()'s, which readers index
    (portbench/program.py: nn1 at 3, knn at 4); each row's source defines
    its entry point, and every name a wrapper launches is a row."""
    names = [name for name, _, _ in _build.KERNELS]
    assert names == [f"sgtd_{k}" for k in (
        "frame_votes", "expand_jobs", "hypothesis_votes", "nn1", "knn", "frame_votes_wide", "linearize_gicp",
        "gather_rows", "triangle_hypotheses", "verify_epilogue", "grouped_sums")]
    assert names.index("sgtd_nn1") == 3 and names.index("sgtd_knn") == 4
    assert list(_build.COUNTS) == names and len(launch_counts()) == 11
    for name, source, _ in _build.KERNELS:
        assert (_build.CSRC / source).is_file(), source
        assert name in dict(_ENTRY.findall((_build.CSRC / source).read_text())), (name, source)
    launched = set()
    for path in (_build.CSRC.parents[0] / "ops").glob("*.py"):
        launched |= set(re.findall(r'_build\.launch\(\s*"(\w+)"', path.read_text()))
    assert launched == set(names)


def test_launch_appends_the_stream_and_raises_on_an_error_code(monkeypatch):
    calls = []
    entries = {"sgtd_ok": lambda *a: calls.append(a) or 0, "sgtd_bad": lambda *a: 700}
    monkeypatch.setattr(_build, "entry_points", lambda: entries)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 1, raising=False)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    for name in entries:
        monkeypatch.setitem(_build.COUNTS, name, 0)
    _build.launch("sgtd_ok", torch.device("cuda", 1), 5, 6)
    assert calls == [(5, 6, 1001)] and _build.COUNTS["sgtd_ok"] == 1
    with pytest.raises(RuntimeError, match="sgtd_bad: CUDA error 700"):
        _build.launch("sgtd_bad", torch.device("cuda", 0))
    assert _build.COUNTS["sgtd_bad"] == 0


def test_reset_zeroes_every_count(monkeypatch):
    for name in list(_build.COUNTS)[::5]:
        monkeypatch.setitem(_build.COUNTS, name, 3)
    assert sum(launch_counts()) == 9
    reset_launch_counts()
    assert launch_counts() == [0] * 11


def test_every_wrapper_launches_through_the_one_helper():
    ops = _build.CSRC.parents[0] / "ops"
    for path in sorted(ops.glob("*.py")):
        text = path.read_text()
        if path.name == "_build.py":
            assert text.count("_cuda_getCurrentRawStream(") == 1
            continue
        assert "current_stream" not in text and "library()" not in text and "ctypes" not in text, path.name
    for name in ("probe", "expand", "verify", "nn", "gicp", "kabsch", "grouped"):
        assert "_build.launch(" in (ops / f"{name}.py").read_text(), name
