"""Build and bind the port's CUDA kernels (``sgtd_tpu_torch/csrc/*.cu``).

nvcc compiles every source for ``sm_90a`` (Hopper) at first use, one
process per source, all started together, and links the objects into one
shared library with a plain C interface; ctypes loads it. A file
with a plain C interface builds in seconds, where one that includes
PyTorch's headers takes minutes. The library lands in
``build/sgtd_tpu_torch/`` under a name that carries a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.

Every entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches.

One table, :data:`KERNELS`, lists the entry points: each row's name, its
source and its ``argtypes``. The sources built and hashed, the bindings and
the launch counts all come from it, so a new kernel is its ``.cu`` file,
one row and its wrapper.

:func:`launch` is the one place a wrapper goes through to start a kernel,
so what a launch costs the host is written once: the entry points are
bound once with their ``argtypes`` (:func:`entry_points`), the current
stream is read as a raw handle (no ``torch.cuda.Stream`` object is built),
the return code is checked, and the launch is counted (:func:`launch_counts`).
A wrapper checks its tensors through :func:`check` and keeps beside it the
limits of its own kernel (sizes, alignment), allocates its outputs anew on
every call from an input (``x.new_empty``: cheaper on the host than
``torch.empty(..., device=...)``), and calls ``.contiguous()`` on its inputs
(which hands back the tensor itself where it already is contiguous, for
less than a Python-side ``is_contiguous()`` test costs).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from sgtd_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgtd_tpu_torch"
# Headers the sources include: hashed with them, never compiled alone.
HEADERS = ("nn_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# One row an entry point, B1-B8 then K1-K3 (the order of launch_counts):
# its name, its source under csrc/ and its argument types (pointers and
# the stream as void*).
KERNELS = (
    # hit, frame, out float32 counts (written whole), B, L, f_pad, stream
    ("sgtd_frame_votes", "probe.cu", (_P, _P, _P, _I, _I, _I, _P)),
    # offsets, payload, out, B, NJ, C, l_max, stream
    ("sgtd_expand_jobs", "expand.cu", (_P, _P, _P, _I, _I, _I, _I, _P)),
    # rot, t, vq, vdb, pair_valid, out, N, H, P, thr2, stream
    ("sgtd_hypothesis_votes", "verify.cu", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P)),
    # query, ref, out_idx, out_sqd, P, N, T, stream
    ("sgtd_nn1", "nn.cu", (_P, _P, _P, _P, _I, _I, _I, _P)),
    # query, ref, out_idx, P, N, T, k, stream
    ("sgtd_knn", "nn.cu", (_P, _P, _P, _I, _I, _I, _I, _P)),
    # hit, frame, int32 counts (zeroed by the caller), B, L, f_pad, stream
    ("sgtd_frame_votes_wide", "probe.cu", (_P, _P, _P, _I, _I, _I, _P)),
    # T, src, src_cov6, src_mask, tgt_eff, payload, partial, sums, aux,
    # P, S, Tn, gate2, stream
    ("sgtd_linearize_gicp", "gicp.cu", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P)),
    # table, idx, out, L, W, stream
    ("sgtd_gather_rows", "probe.cu", (_P, _P, _P, ctypes.c_longlong, _I, _P)),
    # vq, vdb, pair_valid, rot_h, t_h, N, H, P, stream
    ("sgtd_triangle_hypotheses", "kabsch.cu", (_P, _P, _P, _P, _P, _I, _I, _I, _P)),
    # votes, rot_h, t_h, vq, vdb, pair_valid, cand_valid, score, rot, trans,
    # inliers, polished, N, H, P, thr, min_votes, stream
    ("sgtd_verify_epilogue", "kabsch.cu",
     (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P)),
    # points, sorted_slot, order, counts, sums, sq, N, S, stream
    ("sgtd_grouped_sums", "grouped.cu", (_P, _P, _P, _P, _P, _P, _I, _I, _P)),
)
# Launches of each entry point since the last reset_launch_counts, in the
# table's order; launch() adds one after each call that reports no error.
COUNTS = {name: 0 for name, _, _ in KERNELS}


def sources() -> tuple:
    """The table's sources, each once, in the order they first appear."""
    return tuple(dict.fromkeys(source for _, source, _ in KERNELS))


def launch_counts() -> list:
    """Every entry point's launches since the last reset, B1-B8, K1-K3."""
    return list(COUNTS.values())


def reset_launch_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def check(name: str, *specs) -> torch.device:
    """The one device of the tensors of ``specs`` ((key, tensor, shape,
    dtype) each; shape the exact shape, an int, the number of dimensions,
    or None where the caller checks it). Raises ValueError unless every
    tensor is on that device and it is a card or the CPU, TypeError unless
    each tensor has its dtype, ValueError unless each has its shape; the
    messages name ``name``, the wrapper. Reads nothing of the device, and
    touches only attributes that cost the host little (``device.type``
    costs more than the rest together)."""
    first = specs[0][1]
    dev, known = first.device, first.is_cuda or first.is_cpu
    for key, a, shape, dtype in specs:
        if not known or a.device != dev:
            raise ValueError(f"{name}: CUDA tensors required, all on one device (or CPU tensors for the plain "
                             f"version), got {key} on {a.device}, {specs[0][0]} on {dev}")
        if a.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {a.dtype}")
        if shape is not None and (a.ndim if type(shape) is int else a.shape) != shape:
            want = f"{shape} dimensions" if type(shape) is int else f"shape {tuple(shape)}"
            raise ValueError(f"{name}: {key} of {want} required, got {tuple(a.shape)}")
    return dev


NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError(
        "nvcc not found: the sgtd_tpu_torch CUDA kernels build only where the "
        "CUDA toolkit is installed (CPU tensors take the plain PyTorch versions)"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources() + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _library_path() -> Path:
    return BUILD_DIR / f"libsgtd_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.

    Each source compiles in its own nvcc process (all run at once) into a
    temporary directory; the link writes a temporary name that is renamed
    into place, so concurrent builds never load a half-written file. The
    compilers' output (ptxas register and shared-memory use) is kept
    beside the library as ``.log``.
    """
    out = _library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sources()
        objs = [Path(tmp) / f"{Path(s).stem}.o" for s in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(srcs, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        link = None
        if all(p.returncode == 0 for p in procs):
            lib = Path(tmp) / out.name
            link = subprocess.run(
                [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(lib), *map(str, objs)],
                capture_output=True, text=True,
            )
            logs.append(link.stdout + link.stderr)
        text = "".join(logs)
        out.with_suffix(".log").write_text(text)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{text}")
        os.replace(lib, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; RuntimeError without nvcc.

    Records ``ops.load`` (``profiling.loads``): ``seconds`` to load and
    bind the library, ``build_s`` to find or build it, and ``compiled``,
    whether nvcc ran."""
    t0 = time.perf_counter()
    compiled = not _library_path().exists()
    path = build()
    t1 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    for name, _, argtypes in KERNELS:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    profiling.record_load("ops.load", time.perf_counter() - t1, build_s=t1 - t0, compiled=compiled)
    return lib


@functools.cache
def entry_points() -> dict:
    """Entry point name -> bound C function, for every row of KERNELS."""
    lib = library()
    return {name: getattr(lib, name) for name, _, _ in KERNELS}


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` with ``args`` and, last, the current stream
    of ``device`` (a CUDA device with an index, as a tensor's is); raise
    where it reports a CUDA error, else count the launch. The entry points launch on the current
    device, so where ``device`` is another card the call runs inside
    ``torch.cuda.device(device.index)``.

    ``torch._C._cuda_getCurrentRawStream`` returns the stream's handle as
    an int without building a ``torch.cuda.Stream`` (Triton's launcher
    reads the stream the same way), and ``torch._C._cuda_getDevice`` the
    current device without ``torch.cuda.current_device``'s Python checks.
    CUDA builds of torch have both (2.11 was checked); CPU-only builds do
    not, and never come here."""
    index = device.index
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            rc = _start(name, index, args)
    else:
        rc = _start(name, index, args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    COUNTS[name] += 1


def _start(name: str, index: int, args: tuple) -> int:
    return entry_points()[name](*args, torch._C._cuda_getCurrentRawStream(index))
