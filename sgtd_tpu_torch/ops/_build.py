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
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgtd_tpu_torch"
SOURCES = ("probe.cu", "expand.cu", "verify.cu", "nn.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry point -> argument types (pointers and the stream as void*).
SIGNATURES = {
    # hit, frame, out_counts, B, L, f_pad, stream
    "sgtd_frame_votes": (_P, _P, _P, _I, _I, _I, _P),
    # offsets, payload, out, B, NJ, C, l_max, stream
    "sgtd_expand_jobs": (_P, _P, _P, _I, _I, _I, _I, _P),
    # rot, t, vq, vdb, pair_valid, out, N, H, P, thr2, stream
    "sgtd_hypothesis_votes": (_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
    # query, ref, out_idx, out_sqd, P, N, T, stream
    "sgtd_nn1": (_P, _P, _P, _P, _I, _I, _I, _P),
    # query, ref, out_idx, P, N, T, k, stream
    "sgtd_knn": (_P, _P, _P, _I, _I, _I, _I, _P),
}


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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.

    Each source compiles in its own nvcc process (all run at once) into a
    temporary directory; the link writes a temporary name that is renamed
    into place, so concurrent builds never load a half-written file. The
    compilers' output (ptxas register and shared-memory use) is kept
    beside the library as ``.log``.
    """
    out = BUILD_DIR / f"libsgtd_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{Path(s).stem}.o" for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(SOURCES, objs)
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
    """The loaded kernel library, built on first use; RuntimeError without nvcc."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
