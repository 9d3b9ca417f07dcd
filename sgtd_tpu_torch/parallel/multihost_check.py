"""The ranks of a multi-device world and the launcher that starts them (the
counterpart of tools/multihost_check.py, which runs the reference's sharded
localizer from several JAX controllers).

    python -m sgtd_tpu_torch.parallel.multihost_check --inputs DIR --outputs DIR \\
        --legs LEG [LEG ...] [--backend nccl|gloo] [--device cuda:N|cpu]

is one rank. It reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), so ``torchrun
--nproc-per-node N -m sgtd_tpu_torch.parallel.multihost_check ...`` starts a
world on N cards; ``run_world`` starts one from Python. The backend
defaults to NCCL and the device to ``cuda:<LOCAL_RANK>``. NCCL takes one rank
a card; ranks that share a card (or run on the CPU) use gloo, whose
collectives pass through the host.

Each rank joins the process group, runs the legs on the inputs written by
:func:`write_inputs` (one ``.npy`` a field, opened memory-mapped so a rank
reads its own rows and the replicated fields only), and rank 0 writes the
outputs: each leg's results gathered over ``dp`` (``<leg>/<field>.npy``)
and ``summary.json`` with every rank's kernel launches, seconds and
collective seconds (a localizer leg runs twice and keeps the second pass;
the first, which pays the process's first calls, is ``first_s``). Legs:

  sharded:DPxDB[:CHUNK]  ``make_sharded_localizer`` on a (DP, DB) mesh
  ring[:CHUNK]           ``make_ring_localizer`` on a (world, 1) mesh
  ba:ITERS:CG            ``optimize_ba_sharded`` on a 1-D "obs" mesh
  ping                   one all_reduce over the world
  fail:RANK              rank RANK exits with code 3 before it joins the
                         group (a check of the launcher)

CHUNK is the number of a rank's queries a call localizes (all by default).
A localizer or BA leg may end in ``@NAME``: it then reads the inputs
written under the subdirectory NAME, so one world can run legs on several
maps.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sgtd_tpu_torch.ops import launch_counts, reset_launch_counts

REPO = Path(__file__).resolve().parents[2]
FAIL_EXIT = 3


@dataclasses.dataclass(frozen=True)
class Leg:
    """One leg of a world: its kind, its integer arguments and the
    subdirectory of the inputs it reads ("" for the inputs themselves)."""

    kind: str
    args: tuple
    data: str = ""

    @property
    def name(self) -> str:
        """The leg's key in the summary and its output directory."""
        return "_".join((self.kind,) + tuple(str(a) for a in self.args) + ((self.data,) if self.data else ()))

    @staticmethod
    def parse(text: str) -> "Leg":
        spec, _, data = text.partition("@")
        kind, *rest = spec.split(":")
        if kind == "sharded" and 1 <= len(rest) <= 2:
            dp, db = (int(v) for v in rest[0].split("x"))
            return Leg(kind, (dp, db, int(rest[1]) if len(rest) > 1 else 0), data)
        if kind == "ring" and len(rest) <= 1:
            return Leg(kind, (int(rest[0]) if rest else 0,), data)
        if kind == "ba" and len(rest) == 2:
            return Leg(kind, tuple(int(v) for v in rest), data)
        if kind == "ping" and not rest and not data:
            return Leg(kind, ())
        if kind == "fail" and len(rest) == 1 and not data:
            return Leg(kind, (int(rest[0]),))
        raise ValueError(f"unknown leg {text!r} (sharded:DPxDB[:CHUNK][@DATA], ring[:CHUNK][@DATA], "
                         "ba:ITERS:CG[@DATA], ping, fail:RANK)")


def _save_fields(directory: Path, fields: dict) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    for k, v in fields.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        np.save(directory / f"{k}.npy", a)


def _load_fields(directory: Path) -> dict:
    return {p.stem: np.load(p, mmap_mode="r") for p in sorted(directory.glob("*.npy"))}


def write_inputs(directory, db=None, graphs=None, config=None, ba=None) -> None:
    """Write a world's inputs under ``directory``: the whole DB (a
    DescriptorDB, saved as the reference's field arrays), the query batch
    (a stacked SemanticGraph), the config (an SGTDConfig) and a BA problem
    (a BAProblem), each where given."""
    from sgtd_tpu_torch.db.database import db_to_arrays

    d = Path(directory)
    if db is not None:
        _save_fields(d / "db", db_to_arrays(db))
    if graphs is not None:
        _save_fields(d / "graphs", graphs._asdict())
    if ba is not None:
        _save_fields(d / "ba", ba._asdict())
    if config is not None:
        d.mkdir(parents=True, exist_ok=True)
        (d / "config.pkl").write_bytes(pickle.dumps(config))


def read_outputs(directory, leg: str) -> dict:
    """``{field: array}`` of one leg's results written by rank 0."""
    return {k: np.asarray(v) for k, v in _load_fields(Path(directory) / Leg.parse(leg).name).items()}


# ------------------------------------------------------------------ ranks


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _localize_leg(leg: Leg, inputs: Path, dev: torch.device):
    """Run a localizer leg; (result of this rank's queries gathered over
    dp, stats)."""
    from sgtd_tpu_torch.graph.types import SemanticGraph
    from sgtd_tpu_torch.match.pipeline import LocalizationResult
    from sgtd_tpu_torch.parallel import mesh as pm
    from sgtd_tpu_torch.parallel.ring_sweep import make_ring_localizer
    from sgtd_tpu_torch.parallel.sharded_match import make_sharded_localizer

    config = pickle.loads((inputs / "config.pkl").read_bytes())
    if leg.kind == "sharded":
        dp, n_db, chunk = leg.args
    else:
        dp, n_db, chunk = dist.get_world_size(), 1, leg.args[0]
    mesh = pm.make_mesh(dp, n_db, device_type=dev.type)
    t0 = time.perf_counter()
    db_arrays = _load_fields(inputs / "db")
    if leg.kind == "sharded":
        db_local, offset = pm.shard_database(db_arrays, mesh)
        fn = make_sharded_localizer(mesh, config)
        call = lambda g: fn(db_local, offset, g)
    else:
        db_local, _ = pm.shard_database(db_arrays, mesh, axis="dp")
        fn = make_ring_localizer(mesh, config)
        call = lambda g: fn(db_local, g)
    graphs, _ = pm.shard_rows(_load_fields(inputs / "graphs"), SemanticGraph._fields, mesh, "dp", "query")
    g_local = SemanticGraph(*(torch.from_numpy(np.array(graphs[f])).to(dev) for f in SemanticGraph._fields))
    _sync(dev)
    load_s = time.perf_counter() - t0
    q = g_local.centers.shape[0]
    chunk = chunk or q
    run = lambda: [call(SemanticGraph(*(x[i : i + chunk] for x in g_local))) for i in range(0, q, chunk)]

    # A first pass pays the process's first calls (the kernel library, the
    # device code of torch's operations); the second is timed and kept.
    dist.barrier()
    t0 = time.perf_counter()
    run()
    _sync(dev)
    first_s = time.perf_counter() - t0
    dist.barrier()
    reset_launch_counts()
    pm.CLOCK.reset(sync=True)
    _sync(dev)
    t0 = time.perf_counter()
    outs = run()
    _sync(dev)
    stats = {"seconds": time.perf_counter() - t0, "first_s": first_s, "load_s": load_s, "launches": launch_counts(),
             "collective_s": pm.CLOCK.seconds, "collective_calls": pm.CLOCK.calls,
             "rows": int(db_local.keys.shape[0]), "queries": q}
    res = LocalizationResult(*(torch.cat(xs) for xs in zip(*outs)))
    return {f: pm.all_gather(getattr(res, f), mesh, "dp", dim=0) for f in res._fields}, stats


def _ba_leg(leg: Leg, inputs: Path, dev: torch.device):
    from torch.distributed.device_mesh import init_device_mesh

    from sgtd_tpu_torch.parallel import mesh as pm
    from sgtd_tpu_torch.parallel.sharded_ba import optimize_ba_sharded, shard_ba_problem

    iterations, cg_iterations = leg.args
    mesh = init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=("obs",))
    t0 = time.perf_counter()
    ba = shard_ba_problem(_load_fields(inputs / "ba"), mesh, "obs")
    _sync(dev)
    load_s = time.perf_counter() - t0
    dist.barrier()
    reset_launch_counts()
    pm.CLOCK.reset(sync=True)
    _sync(dev)
    t0 = time.perf_counter()
    res = optimize_ba_sharded(ba, mesh, "obs", iterations=iterations, cg_iterations=cg_iterations)
    _sync(dev)
    stats = {"seconds": time.perf_counter() - t0, "load_s": load_s, "launches": launch_counts(),
             "collective_s": pm.CLOCK.seconds, "collective_calls": pm.CLOCK.calls,
             "landmarks": int(ba.landmarks.shape[0])}
    return res._asdict(), stats


def _ping_leg(dev: torch.device):
    x = torch.ones(1, device=dev)
    dist.all_reduce(x)
    if int(x.item()) != dist.get_world_size():
        raise RuntimeError(f"ping: all_reduce of ones gave {x.item()} on {dist.get_world_size()} ranks")
    return {}, {}


def _foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sgtd_tpu"))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--inputs", required=True, help="directory written by write_inputs")
    parser.add_argument("--outputs", required=True, help="directory rank 0 writes the results to")
    parser.add_argument("--legs", nargs="+", required=True)
    parser.add_argument("--backend", default="nccl")
    parser.add_argument("--device", default=None, help="this rank's device (default cuda:<LOCAL_RANK>)")
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds a collective may wait")
    args = parser.parse_args(argv)
    legs = [Leg.parse(t) for t in args.legs]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if any(leg.kind == "fail" and leg.args[0] == rank for leg in legs):
        print(f"rank {rank}: exiting with {FAIL_EXIT} as the fail leg asks", file=sys.stderr, flush=True)
        sys.exit(FAIL_EXIT)
    dev = torch.device(args.device or f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
    if dev.type == "cuda":
        # The card is current before the mesh is made: DeviceMesh then keeps
        # it, whatever LOCAL_RANK says.
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        from sgtd_tpu_torch.utils import disable_tf32

        disable_tf32()
    inputs, outputs = Path(args.inputs), Path(args.outputs)
    dist.init_process_group(args.backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=args.timeout))
    try:
        ready_at = time.time()
        results, stats = {}, {}
        for leg in legs:
            if leg.kind in ("sharded", "ring"):
                results[leg.name], stats[leg.name] = _localize_leg(leg, inputs / leg.data, dev)
            elif leg.kind == "ba":
                results[leg.name], stats[leg.name] = _ba_leg(leg, inputs / leg.data, dev)
            elif leg.kind == "ping":
                results[leg.name], stats[leg.name] = _ping_leg(dev)
        foreign = _foreign_modules()
        if foreign:
            raise RuntimeError(f"rank {rank}: modules of JAX or of the JAX package were loaded: {foreign}")
        mine = {"rank": rank, "ready_at": ready_at, "device": str(dev), "legs": stats}
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            for name, fields in results.items():
                _save_fields(outputs / name, fields)
            summary = {
                "world": world, "backend": dist.get_backend(), "ready_at": max(r["ready_at"] for r in every),
                "device": str(dev), "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "legs": {leg.name: [r["legs"][leg.name] for r in every] for leg in legs if leg.kind != "fail"},
                "foreign_modules": foreign,
            }
            (outputs / "summary.json").write_text(json.dumps(summary, indent=1))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------- launcher


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 3000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-n:]


def run_world(n: int, backend: str, device: str | None, inputs, legs, timeout: float, outputs=None) -> dict:
    """Start ``n`` ranks of this module as subprocesses (``OMP_NUM_THREADS=1``,
    a free port on localhost), wait for all of them, and return rank 0's
    summary with ``startup_s``: the seconds from the first start to the
    last rank's joining the group. ``device`` is every rank's device (None:
    each its ``cuda:<rank>``). When one rank exits nonzero the others are
    killed and RuntimeError names the failing ranks with the end of their
    output; past ``timeout`` seconds every rank is killed and TimeoutError
    raised. Output of each rank goes to ``<outputs>/rank<r>.log``;
    ``outputs`` defaults to ``<inputs>/out``."""
    inputs = Path(inputs)
    outputs = Path(outputs) if outputs is not None else inputs / "out"
    outputs.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    cmd = [sys.executable, "-m", "sgtd_tpu_torch.parallel.multihost_check", "--inputs", str(inputs),
           "--outputs", str(outputs), "--backend", backend, "--timeout", str(timeout),
           *(["--device", device] if device else []), "--legs", *legs]
    logs = [outputs / f"rank{r}.log" for r in range(n)]
    procs = []
    t0 = time.time()
    try:
        for r in range(n):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                                              stdout=log, stderr=subprocess.STDOUT))
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                tails = "\n".join(f"--- rank {r} (exit {codes[r]}):\n{_tail(logs[r])}" for r in failed)
                raise RuntimeError(f"rank(s) {failed} of a {n}-rank {backend} world exited nonzero:\n{tails}")
            if all(c == 0 for c in codes):
                break
            if time.time() - t0 > timeout:
                raise TimeoutError(f"a {n}-rank {backend} world ran past {timeout} s; ranks still running: "
                                   f"{[r for r, c in enumerate(codes) if c is None]}\n--- rank 0:\n{_tail(logs[0])}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    summary = json.loads((outputs / "summary.json").read_text())
    summary["startup_s"] = summary["ready_at"] - t0
    return summary


if __name__ == "__main__":
    main()
