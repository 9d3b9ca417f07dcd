"""B4 ``nn1`` and B5 ``knn``: brute-force nearest neighbours between point
clouds (port of sgtd_tpu.ops.pallas_nn; kernels in ``csrc/nn.cu``).

Both take the squared distance in the reference's expansion and rounding
order, ``d = (|q|^2 + |r|^2) - 2 q.r`` with every square and dot product
a chain of fused multiply-adds (see :func:`sq_dists_plain`), so the plain
versions here equal the JAX kernels on the CPU bit for bit, and the
kernels equal the plain versions on the card. Masked points arrive
displaced to a far coordinate by the caller.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version. There is no fallback between the two.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from sgtd_tpu_torch.ops import _build

# Kernel launches since the last reset (the main-path check reads them).
NN1_LAUNCHES = 0
KNN_LAUNCHES = 0

MAX_K = 32  # the knn kernel's list: one entry a lane of a warp
KNN_QUERIES_PER_BLOCK = 32  # csrc/nn.cu: kKnnWarps x kKnnQueries
MAX_KNN_BLOCKS = (1 << 31) - 1  # grid.x of the knn kernel, problems x query tiles
# The nn1 scan's launch shape (csrc/nn_common.cuh: kWideQueries, kWideBlocks,
# kMinWarps, kMaxWarps, kWarpsWanted), shared with ops.gicp's kernel.
SCAN_WIDE_QUERIES, SCAN_WIDE_BLOCKS = 4, 132
SCAN_MIN_WARPS, SCAN_MAX_WARPS, SCAN_WARPS_WANTED = 4, 16, 4096
MAX_SCAN_BLOCKS = (1 << 31) - 1  # grid.x of the scan, problems x query tiles
# Distances per block of the plain versions: a few float64 (rows, T)
# temporaries of 2^24 entries (128 MB each) bound their memory.
_PLAIN_BLOCK = 1 << 24


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add, emulated in float64: the product is exact
    there, and the sum rounds to float64 and then float32, which differs
    from one true rounding only in rare halfway cases."""
    return (a.double() * b.double() + c.double()).float()


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p.unbind(-1)
    return _fma(z, z, _fma(y, y, x * x))


def sq_dists_plain(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., T, 3) -> (..., N, T) float32 squared distances,
    ``(qsq + rsq) - 2 * cross`` with qsq, rsq and cross as FMA chains
    (``fma(z, z', fma(y, y', x * x'))``), as XLA:CPU evaluates the
    reference's ``pallas_nn._sq_dists``."""
    qx, qy, qz = (c[..., :, None] for c in q.unbind(-1))
    rx, ry, rz = (c[..., None, :] for c in r.unbind(-1))
    cross = _fma(qz, rz, _fma(qy, ry, qx * rx))
    return (_sq_norm(q)[..., :, None] + _sq_norm(r)[..., None, :]) - 2.0 * cross


def _blocks(p: int, n: int, t: int) -> Iterator[Tuple[slice, slice]]:
    """(problem, query-row) slices of at most ``_PLAIN_BLOCK`` distances."""
    if n * t <= _PLAIN_BLOCK:
        step = max(1, _PLAIN_BLOCK // max(n * t, 1))
        for s in range(0, p, step):
            yield slice(s, s + step), slice(None)
    else:
        step = max(1, _PLAIN_BLOCK // t)
        for s in range(p):
            for r in range(0, n, step):
                yield slice(s, s + 1), slice(r, r + step)


def _flat(query: torch.Tensor, ref: torch.Tensor, name: str):
    if query.shape[-1:] != (3,) or ref.shape[-1:] != (3,) or query.dim() < 2:
        raise ValueError(f"{name}: (..., N, 3) and (..., T, 3) points, got "
                         f"{tuple(query.shape)}/{tuple(ref.shape)}")
    if query.shape[:-2] != ref.shape[:-2]:
        raise ValueError(f"{name}: leading dims differ, {tuple(query.shape)}/{tuple(ref.shape)}")
    if ref.shape[-2] < 1:
        raise ValueError(f"{name}: empty reference cloud")
    batch = query.shape[:-2]
    return batch, query.reshape(-1, query.shape[-2], 3), ref.reshape(-1, ref.shape[-2], 3)


def nn1_plain(query: torch.Tensor, ref: torch.Tensor):
    """Plain version: per block of rows the dense distances, then the first
    index attaining the row minimum (``pallas_nn.py:74``)."""
    batch, q, r = _flat(query, ref, "nn1")
    p, n, t = q.shape[0], q.shape[1], r.shape[1]
    idx = torch.empty((p, n), dtype=torch.int32, device=q.device)
    sqd = torch.empty((p, n), dtype=torch.float32, device=q.device)
    cols = torch.arange(t, dtype=torch.int32, device=q.device)
    for ps, rs in _blocks(p, n, t):
        d = sq_dists_plain(q[ps, rs], r[ps])
        dmin = d.min(-1, keepdim=True).values
        idx[ps, rs] = torch.where(d <= dmin, cols, t).min(-1).values
        sqd[ps, rs] = dmin[..., 0]
    return idx.reshape(batch + (n,)), sqd.reshape(batch + (n,))


def knn_plain(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: a stable ascending sort of each row of distances,
    truncated to k — what the reference's k min-extraction passes give
    (``torch.topk`` leaves ties unspecified)."""
    batch, q, r = _flat(query, ref, "knn")
    p, n, t = q.shape[0], q.shape[1], r.shape[1]
    _check_k(k, t)
    idx = torch.empty((p, n, k), dtype=torch.int32, device=q.device)
    for ps, rs in _blocks(p, n, t):
        d = sq_dists_plain(q[ps, rs], r[ps])
        idx[ps, rs] = torch.sort(d, dim=-1, stable=True).indices[..., :k].to(torch.int32)
    return idx.reshape(batch + (n, k))


def _check_k(k: int, t: int) -> None:
    # At T < k the reference repeats index 0; no path reaches that case.
    if not 1 <= k <= t:
        raise ValueError(f"knn: k={k} needs 1 <= k <= T={t}")


def scan_plan(p: int, n: int) -> Tuple[int, int, int]:
    """How the scan of ``csrc/nn_common.cuh`` lays ``p`` problems of ``n``
    queries over the card (its ``scan_plan``, in Python): (queries a
    thread, warps a block, blocks). A thread holds 4 queries where that
    still gives every SM a block, else 1; a block takes 32 x queries of one
    problem, and its warps (a power of two) split the reference range so
    that about ``SCAN_WARPS_WANTED`` warps are in flight."""
    wide = 32 * SCAN_WIDE_QUERIES
    queries = SCAN_WIDE_QUERIES if n >= wide and p * -(-n // wide) >= SCAN_WIDE_BLOCKS else 1
    blocks = p * -(-n // (32 * queries))
    warps = SCAN_MIN_WARPS
    while warps < SCAN_MAX_WARPS and blocks * warps < SCAN_WARPS_WANTED:
        warps *= 2
    return queries, warps, blocks


def check_scan_grid(name: str, p: int, n: int) -> None:
    """Raise where ``p`` problems of ``n`` queries exceed the scan's grid."""
    if scan_plan(p, n)[2] > MAX_SCAN_BLOCKS:
        raise ValueError(f"{name}: {p} problems of {n} queries exceed the kernel's grid")


def nn1(query: torch.Tensor, ref: torch.Tensor):
    """Nearest ``ref`` point of each ``query`` point: (..., N, 3) x
    (..., T, 3) float32 (same leading dims) -> (idx (..., N) int32,
    sqd (..., N) float32). Ties go to the lowest index."""
    if query.device.type == "cpu":
        return nn1_plain(query, ref)
    return _nn1_cuda(query, ref)


def knn(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k nearest ``ref`` points of each ``query`` point in
    ascending distance, ties to the lowest index: (..., N, k) int32."""
    if query.device.type == "cpu":
        return knn_plain(query, ref, k)
    return _knn_cuda(query, ref, k)


def _check_cuda(query: torch.Tensor, ref: torch.Tensor, name: str):
    if query.device.type != "cuda" or ref.device != query.device:
        raise ValueError(f"{name}: CUDA tensors required, got {query.device}/{ref.device}")
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"{name}: float32 points, got {query.dtype}/{ref.dtype}")
    batch, q, r = _flat(query, ref, name)
    return batch, q.contiguous(), r.contiguous()


def _nn1_cuda(query: torch.Tensor, ref: torch.Tensor):
    global NN1_LAUNCHES
    batch, q, r = _check_cuda(query, ref, "nn1")
    p, n, t = q.shape[0], q.shape[1], r.shape[1]
    check_scan_grid("nn1", p, n)
    idx = q.new_empty((p, n), dtype=torch.int32)
    sqd = q.new_empty((p, n))
    _build.launch("sgtd_nn1", q.device, q.data_ptr(), r.data_ptr(), idx.data_ptr(), sqd.data_ptr(), p, n, t)
    NN1_LAUNCHES += 1
    return idx.reshape(batch + (n,)), sqd.reshape(batch + (n,))


def _knn_cuda(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    global KNN_LAUNCHES
    batch, q, r = _check_cuda(query, ref, "knn")
    p, n, t = q.shape[0], q.shape[1], r.shape[1]
    _check_k(k, t)
    if k > MAX_K:
        raise ValueError(f"knn: k={k} exceeds the kernel's {MAX_K}")
    if p * -(-n // KNN_QUERIES_PER_BLOCK) > MAX_KNN_BLOCKS:
        raise ValueError(f"knn: {p} problems of {n} queries exceed the kernel's grid")
    idx = q.new_empty((p, n, k), dtype=torch.int32)
    _build.launch("sgtd_knn", q.device, q.data_ptr(), r.data_ptr(), idx.data_ptr(), p, n, t, k)
    KNN_LAUNCHES += 1
    return idx.reshape(batch + (n, k))
