"""Device meshes, DB sharding and the collectives of the multi-device paths
(port of sgtd_tpu.parallel.mesh).

The scaling axes of the reference:

  * ``db`` — descriptor-database rows sharded across ranks (the map-size
             axis);
  * ``dp`` — data parallelism over query scans.

Where the reference runs one SPMD program under ``shard_map``, the port
runs one process a rank under ``torch.distributed``: a ``DeviceMesh`` of
shape (dp, db) over an initialized process group, whose per-dim groups
carry the collectives below. Each collective is a small function taking a
mesh and a dim name; with one rank on that dim it is the identity.

The group's backend decides where the bytes travel, and nothing else does:
an NCCL group reduces tensors on the card; a gloo group carries host
tensors, so a CUDA tensor is copied to the host for the collective and its
result copied back. NCCL takes one rank a card, so several ranks on one
card form a gloo world.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sgtd_tpu_torch.db.database import DescriptorDB, db_from_arrays

# The DescriptorDB fields that hold one entry a DB row and shard over the
# ``db`` dim (the reference's ``db_sharding`` puts them on P("db")); every
# other field is replicated.
ROW_FIELDS = ("keys", "codes", "packed2", "vertices", "frame_ids")


@dataclasses.dataclass
class CollectiveClock:
    """Calls of the collective helpers and the host seconds spent inside
    them. With ``sync`` each helper synchronizes the card of a CUDA tensor
    before its clock starts and before it stops, so the span is the
    collective's own and holds no work queued before it."""

    sync: bool = False
    calls: int = 0
    seconds: float = 0.0

    def reset(self, sync: bool = False) -> None:
        self.sync, self.calls, self.seconds = sync, 0, 0.0


CLOCK = CollectiveClock()


def make_mesh(dp: int = 1, db: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A (dp, db) mesh with dim names ("dp", "db") over the initialized
    default process group; ``db`` defaults to the ranks left after ``dp``.
    Every rank calls it with the same arguments. Raises unless dp * db is
    the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the process group first (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if db is None:
        if n % dp:
            raise ValueError(f"{n} ranks not divisible by dp={dp}")
        db = n // dp
    if dp * db != n:
        raise ValueError(f"mesh {dp}x{db} needs {dp * db} ranks, the world has {n}")
    return init_device_mesh(device_type, (dp, db), mesh_dim_names=("dp", "db"))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current card of a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return dist.get_world_size(mesh.get_group(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def shard_rows(arrays: dict, fields: Sequence[str], mesh: DeviceMesh, axis: str, what: str):
    """``arrays`` with each of ``fields`` cut to this rank's contiguous
    slice of its leading axis along ``axis``, and the global index of the
    slice's first row. NumPy arrays (memory-mapped ones too) are sliced
    before any copy, so a rank reads only its rows."""
    n = axis_size(mesh, axis)
    m = arrays[fields[0]].shape[0]
    if m % n:
        raise ValueError(f"{what} rows ({m}) must be divisible by the '{axis}' axis ({n})")
    per = m // n
    lo = axis_index(mesh, axis) * per
    out = dict(arrays)
    for f in fields:
        out[f] = arrays[f][lo : lo + per]
    return out, lo


def shard_database(db, mesh: DeviceMesh, axis: str = "db"):
    """(this rank's DescriptorDB on its device, the global row of its first
    row). ``db``: the whole DB, as a DescriptorDB or the reference's field
    arrays (``db_to_arrays``; memory-mapped ``.npy`` files read only this
    rank's rows). The five ``ROW_FIELDS`` are this rank's contiguous slice
    along ``axis`` (``db``; the ring's blocks lie along ``dp``), every
    other field replicated. Rows are key-sorted globally, so each slice is
    sorted and the shard's probes, given the offset, stay exact; a bucket
    split across shards is scanned partly on each side. Raises when the
    rows do not divide the axis (the builds pad rows to a multiple of 128).
    """
    fields = db._asdict() if isinstance(db, DescriptorDB) else {f: db[f] for f in DescriptorDB._fields}
    local, offset = shard_rows(fields, ROW_FIELDS, mesh, axis, "DB")
    return db_from_arrays(local, rank_device(mesh)), offset


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``x`` on the device ``group`` carries: the host
    for gloo, ``x``'s own device otherwise."""
    carrier = torch.device("cpu") if dist.get_backend(group) == "gloo" else x.device
    return x.to(carrier, memory_format=torch.contiguous_format, copy=True)


@contextlib.contextmanager
def _clocked(device: torch.device):
    """Count one collective call and its host seconds on ``CLOCK``."""
    if CLOCK.sync and device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if CLOCK.sync and device.type == "cuda":
        torch.cuda.synchronize(device)
    CLOCK.calls += 1
    CLOCK.seconds += time.perf_counter() - t0


def _all_reduce(x: torch.Tensor, mesh: DeviceMesh, axis: str, op) -> torch.Tensor:
    group = mesh.get_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    with _clocked(x.device):
        buf = _staged(x, group)
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(x.device)


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``jax.lax.psum``); every
    rank gets the same bits. On a gloo group a CUDA tensor goes through the
    host."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axis`` (``jax.lax.pmax``).
    On a gloo group a CUDA tensor goes through the host."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``); every rank passes the
    same shape. The list form of ``all_gather``, which every backend and
    torch version takes. On a gloo group a CUDA tensor goes through the
    host."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.dtype == torch.bool:  # carried as bytes: not every backend takes bool
        return all_gather(x.to(torch.uint8), mesh, axis, dim).bool()
    with _clocked(x.device):
        buf = _staged(x, group)
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
        return torch.cat(parts, dim).to(x.device)


def ppermute_next(tensors: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str) -> list:
    """Send each tensor to the next rank of ``axis`` and receive the
    previous rank's (``jax.lax.ppermute`` with perm i -> i + 1 mod n), in
    one ``batch_isend_irecv``. With one rank on the axis the tensors come
    back as they are (torch refuses a send to oneself). On a gloo group
    CUDA tensors go through the host."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = axis_index(mesh, axis)
    dst = dist.get_global_rank(group, (me + 1) % n)
    src = dist.get_global_rank(group, (me - 1) % n)
    with _clocked(tensors[0].device):
        send = [_staged(t, group) for t in tensors]
        recv = [torch.empty_like(b) for b in send]
        ops = [dist.P2POp(dist.isend, b, dst, group) for b in send]
        ops += [dist.P2POp(dist.irecv, r, src, group) for r in recv]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(t.device) for r, t in zip(recv, tensors)]
