"""Drive the PyTorch port's localization path on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

0. Device: requires a CUDA card, prints its name and power limit, turns
   TF32 off.
1. Build: compiles the hand-written kernels (``sgtd_tpu_torch/csrc``) with
   nvcc and prints the seconds taken.
2. Kernels against their plain PyTorch versions at the bench shapes, on
   inputs seeded from NumPy: B1 and B2 must be equal, B3 equal except on
   pairs whose float64 d^2 lies within 1e-3 of thr^2. Median times of
   kernel and plain version over 20 synchronized runs each.
3. The main path on the bench world (seed 2026, 200 map keyframes, 64
   queries): descriptors, on-device DB build and scan-slot calibration,
   then descriptor-only localization of all queries in chunks of 16.
   Gates: zero TRUNC_SCAN, success rate >= 0.95, every kernel launched.
   One chunk re-runs with the plain versions and must give the same
   candidates and votes. Prints DB build seconds and steady-state scans/s.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

SEED = 2026
NUM_MAP, NUM_QUERIES, CHUNK, N_SAMPLE, REPS = 200, 64, 16, 16, 3
SR_GATE = 0.95


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def timed_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def median_times(kernel_fn, plain_fn, runs: int = 20):
    """Median ms of each over ``runs`` synchronized runs after a warm-up,
    taken in turns (plain, kernel, kernel, plain) on the same card."""
    kernel_fn(), plain_fn()
    t_k, t_p = [], []
    half = runs // 2
    for order in ((plain_fn, t_p), (kernel_fn, t_k), (kernel_fn, t_k), (plain_fn, t_p)):
        fn, acc = order
        acc.extend(timed_ms(fn) for _ in range(half))
    return statistics.median(t_k), statistics.median(t_p)


def check_kernels(dev, card: str):
    """Phase 2: each kernel against its plain version at the bench shapes."""
    from sgtd_tpu_torch.ops import expand, probe, verify

    rng = np.random.default_rng(SEED)
    records = []

    # B1 frame_votes: (16, 98,304) slots, 200 frames, sentinel ids included.
    b, l, f_pad = CHUNK, 98304, 200
    hit = torch.from_numpy(rng.uniform(size=(b, l)) < 0.3).to(dev)
    frame = torch.from_numpy(rng.integers(-1, f_pad + 2, (b, l), dtype=np.int32)).to(dev)
    got = probe.frame_votes(hit, frame, f_pad)
    want = probe.frame_votes_plain(hit, frame, f_pad)
    err = (got - want).abs().max().item()
    if err != 0:
        fail(f"B1 frame_votes differs from its plain version (max |err| {err})")
    ms, plain_ms = median_times(
        lambda: probe.frame_votes(hit, frame, f_pad),
        lambda: probe.frame_votes_plain(hit, frame, f_pad),
    )
    log(f"B1 frame_votes ({b}, {l}) f_pad {f_pad}: equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
    records.append(("frame_votes", "probe.cu", "sgtd_tpu/ops/pallas_probe.py:67", probe, err, ms, plain_ms))

    # B2 expand_jobs: 16 x 55,296 jobs (2048 descriptors x 27 probes), 5
    # channels (one of any sign), 98,304 slots; skewed lengths, many empty.
    nj, c, l_max = 2048 * 27, 5, 98304
    length = np.where(rng.uniform(size=(b, nj)) < 0.7, 0, rng.geometric(0.3, (b, nj)))
    length[0, 100] = l_max  # one query overflows the cap
    length = torch.from_numpy(length.astype(np.int32)).to(dev)
    payload = rng.integers(0, 1 << 20, (b, nj, c), dtype=np.int32)
    payload[..., 0] -= 1 << 19
    payload = torch.from_numpy(payload).to(dev)
    got = expand.expand_jobs(length, payload, l_max)
    want = expand.expand_jobs_plain(length, payload, l_max)
    total = length.sum(-1).clamp(max=l_max)
    valid = torch.arange(l_max, device=dev) < total[:, None]  # (B, L)
    err = ((got - want).abs() * valid[:, None]).max().item()
    if err != 0:
        fail(f"B2 expand_jobs differs from its plain version on valid slots (max |err| {err})")
    ms, plain_ms = median_times(
        lambda: expand.expand_jobs(length, payload, l_max),
        lambda: expand.expand_jobs_plain(length, payload, l_max),
    )
    log(f"B2 expand_jobs ({b}, {nj} jobs, {c} ch) -> {l_max} slots: equal on valid slots; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
    records.append(("expand_jobs", "expand.cu", "sgtd_tpu/ops/pallas_expand.py:73", expand, err, ms, plain_ms))

    # B3 hypothesis_votes: 16 x 50 candidates, 50 hypotheses, 512 pairs;
    # a quarter of each candidate's pairs planted near hypothesis 0.
    n, h, p, thr = CHUNK * 50, 50, 512, 3.0
    quat = rng.normal(size=(n * h, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    w, x, y, z = quat.T
    rot = np.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
         2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
         2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        axis=-1,
    ).reshape(n, h, 3, 3).astype(np.float32)
    t = rng.normal(0, 5, (n, h, 3)).astype(np.float32)
    vq = rng.normal(0, 20, (n, p, 3, 3)).astype(np.float32)
    vdb = rng.normal(0, 20, (n, p, 3, 3)).astype(np.float32)
    moved = np.einsum("nij,npkj->npki", rot[:, 0], vq[:, : p // 4]) + t[:, 0, None, None]
    vdb[:, : p // 4] = moved + rng.normal(0, 1.5, moved.shape)
    pair_valid = np.arange(p)[None] < rng.integers(0, p + 1, (n, 1))
    args = [torch.from_numpy(a).to(dev) for a in (rot, t, vq, vdb, pair_valid)]
    got = verify.hypothesis_votes(*args, thr)
    want = verify.hypothesis_votes_plain(*args, thr)
    # Pairs whose float64 d^2 lies within 1e-3 of thr^2 may round either way.
    r64, t64, q64, d64 = (a.double() for a in args[:4])
    d2 = ((torch.einsum("nhij,npaj->nhpai", r64, q64) + t64[:, :, None, None]
           - d64[:, None]) ** 2).sum(-1)
    near = ((d2 - thr * thr).abs() < 1e-3).any(-1) & args[4][:, None]
    n_near = int(near.sum())
    diff = (got - want).abs()
    err = diff.max().item()
    if bool((diff > near.sum(-1)).any()):
        fail(f"B3 hypothesis_votes differs beyond its {n_near} borderline pairs (max |err| {err})")
    ms, plain_ms = median_times(
        lambda: verify.hypothesis_votes(*args, thr),
        lambda: verify.hypothesis_votes_plain(*args, thr),
    )
    log(f"B3 hypothesis_votes ({n} cand, {h} hyp, {p} pairs): max |err| {err} "
        f"({n_near} borderline pairs); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
    records.append(("hypothesis_votes", "verify.cu", "sgtd_tpu/ops/pallas_verify.py:83", verify, err, ms, plain_ms))
    return records


def main_path(dev, card: str):
    """Phase 3: the bench world through the port's public entry points."""
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.data.synthetic import make_map_and_queries
    from sgtd_tpu_torch.db.database import tuned_config
    from sgtd_tpu_torch.db.device_build import build_database_calibrated
    from sgtd_tpu_torch.desc.triangles import build_descriptors
    from sgtd_tpu_torch.eval.metrics import success_rate
    from sgtd_tpu_torch.graph.types import stack_graphs
    from sgtd_tpu_torch.match.pipeline import localize
    from sgtd_tpu_torch.match.search import TRUNC_SCAN, fit_scan_slots
    from sgtd_tpu_torch.ops import expand, probe, verify

    cfg = SGTDConfig()
    maps, queries, _ = make_map_and_queries(
        cfg, seed=SEED, num_map_frames=NUM_MAP, num_queries=NUM_QUERIES,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    map_batch = stack_graphs(maps, dev)
    chunks = [stack_graphs(queries[i : i + CHUNK], dev) for i in range(0, NUM_QUERIES, CHUNK)]

    for mod in (probe, expand, verify):
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    map_descs = build_descriptors(map_batch, cfg.desc, cfg.caps)
    sample = build_descriptors(stack_graphs(queries[:N_SAMPLE], dev), cfg.desc, cfg.caps)
    db, report, totals = build_database_calibrated(map_descs, map_batch.pose, sample, cfg.desc)
    cfg = fit_scan_slots(int(totals.max()), tuned_config(cfg, report))
    torch.cuda.synchronize()
    db_s = time.perf_counter() - t0
    results = [localize(db, q, cfg) for q in chunks]
    torch.cuda.synchronize()
    launches = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in (probe, expand, verify)}
    log(f"main-path kernel launches: {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was never launched: {launches}")

    found = torch.cat([r.found for r in results]).cpu().numpy()
    poses = torch.cat([r.poses[:, 0] for r in results]).cpu().numpy()
    truncated = torch.cat([r.truncated for r in results]).cpu().numpy()
    n_trunc = int(((truncated & TRUNC_SCAN) != 0).sum())
    sr = success_rate([g.pose for g in queries], poses, found, cfg)
    log(
        f"bench world: rows={report.num_rows} scan_slots={cfg.caps.max_scan_slots} "
        f"(max sampled total {int(totals.max())}) bucket_cap={cfg.caps.bucket_cap} "
        f"SR={sr:.4f} TRUNC_SCAN={n_trunc} db_build_s={db_s:.4f} [{card}]"
    )
    if n_trunc:
        fail(f"{n_trunc} queries overflowed the calibrated scan cap")
    if sr < SR_GATE:
        fail(f"success rate {sr:.4f} below {SR_GATE}")
    c = min(cfg.search.candidate_num, db.num_frames)
    for name, shape in (("frames", (c,)), ("scores", (c,)), ("poses", (c, 4, 4))):
        v = torch.cat([getattr(r, name) for r in results])
        if tuple(v.shape) != (NUM_QUERIES,) + shape or not bool(torch.isfinite(v.float()).all()):
            fail(f"{name}: shape {tuple(v.shape)} or non-finite values")

    # The same chunk through the plain versions on the card.
    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(probe, "frame_votes", probe.frame_votes_plain))
        stack.enter_context(mock.patch.object(expand, "expand_jobs", expand.expand_jobs_plain))
        stack.enter_context(mock.patch.object(verify, "hypothesis_votes", verify.hypothesis_votes_plain))
        plain = localize(db, chunks[0], cfg)
    for name in ("frames", "votes", "found", "best_frame"):
        if not torch.equal(getattr(plain, name), getattr(results[0], name)):
            fail(f"plain-version rerun differs in {name}")
    log("plain-version rerun of chunk 0: frames, votes, found, best_frame equal")

    times = []
    for _ in range(REPS):
        times.append(sum(timed_ms(lambda q=q: localize(db, q, cfg)) for q in chunks) / 1e3)
    scans_s = [NUM_QUERIES / s for s in times]
    log(f"steady state: scans/s per rep {scans_s} (median {statistics.median(scans_s):.2f}, "
        f"chunk {CHUNK}, synchronized per chunk) [{card}]")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a card")
    from sgtd_tpu_torch.ops import _build
    from sgtd_tpu_torch.utils import disable_tf32

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    disable_tf32()

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    log("ptxas: " + " | ".join(
        ln.strip() for ln in path.with_suffix(".log").read_text().splitlines() if "Used" in ln
    ))

    records = check_kernels(dev, card)
    launches = main_path(dev, card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"sgtd_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[mod.__name__.rsplit(".", 1)[1]],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, src, replaces, mod, err, ms, plain_ms in records
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
