"""Drive the PyTorch port's localization paths on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

0. Device: requires a CUDA card, prints its name and power limit, turns
   TF32 off.
1. Build: compiles the hand-written kernels (``sgtd_tpu_torch/csrc``) with
   nvcc, one process per source, and prints the seconds taken.
2. Kernels against their plain PyTorch versions at the bench shapes, on
   inputs seeded from NumPy: B1 and B2 must be equal, B3 equal except on
   pairs whose float64 d^2 lies within 1e-3 of thr^2; B4 and B5 equal
   except on rows whose kernel and plain picks lie within 1 ulp of each
   other (at most 0.1% of rows). B1-B3: median times of kernel and plain
   version over 20 synchronized runs each; B4-B5: CUDA-event times.
3. The descriptor-only path on the bench world (seed 2026, 200 map
   keyframes, 64 queries): descriptors, on-device DB build and scan-slot
   calibration, then ``localize`` of all queries in chunks of 16. Gates:
   zero TRUNC_SCAN, success rate >= 0.95, B1-B3 launched. One chunk
   re-runs with the plain versions and must give the same candidates and
   votes. Prints DB build seconds and steady-state scans/s.
4. The refined main path (``bench.py``'s): keyframe clouds of 4,096
   points and their covariances (B5) on the card, query sources
   voxel-downsampled to at most 1,024 points, then ``localize_refined``
   with the GICP rerank of the top 4 candidates, chunks of 16. Gates:
   zero TRUNC_SCAN, success rate >= 0.95 on the refined poses, finite
   poses, every kernel launched. One chunk re-runs with B4/B5 patched to
   their plain versions and must give the same pick, refined and found,
   with poses within 5e-3 m and 1e-3 rad. Prints the refined share, the
   pose RMSE, the stage split of one chunk, map-covariance seconds and
   steady-state scans/s.

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
T_START = time.perf_counter()
CLOUD_PTS, SRC_PTS, RERANK_K = 4096, 1024, 4  # bench.py:170-195
POS_TOL_M, ROT_TOL_RAD = 5e-3, 1e-3
# (module, counter) of every kernel, in B1-B5 order.
COUNTERS = (
    ("probe", "LAUNCHES"), ("expand", "LAUNCHES"), ("verify", "LAUNCHES"),
    ("nn", "NN1_LAUNCHES"), ("nn", "KNN_LAUNCHES"),
)


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


def event_ms(fn, launches: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``launches``
    back-to-back calls, per call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def _modules():
    from sgtd_tpu_torch.ops import expand, nn, probe, verify

    return {"probe": probe, "expand": expand, "verify": verify, "nn": nn}


def reset_counts() -> None:
    mods = _modules()
    for mod, attr in COUNTERS:
        setattr(mods[mod], attr, 0)


def read_counts() -> list:
    mods = _modules()
    return [getattr(mods[mod], attr) for mod, attr in COUNTERS]


def ulp_close(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a and b (float32) at most one ulp apart."""
    inf = torch.full_like(a, float("inf"))
    return (b >= torch.nextafter(a, -inf)) & (b <= torch.nextafter(a, inf))


def check_nn_rows(name: str, q, r, got_idx, want_idx):
    """Rows where the kernel's and the plain version's picks differ are
    accepted only where, for every slot, the two picks' float32 distances
    (the plain expression) lie within one ulp: a float64-emulated FMA can
    round a halfway case differently from a true FMA. Fails above 0.1% of
    rows. Returns (differing rows, max |d(kernel pick) - d(plain pick)|)."""
    from sgtd_tpu_torch.ops import nn
    from sgtd_tpu_torch.utils import batch_take

    if got_idx.dim() == q.dim() - 1:
        got_idx, want_idx = got_idx[..., None], want_idx[..., None]
    rows = (got_idx != want_idx).any(-1)
    n_rows = int(rows.sum())
    if n_rows == 0:
        return 0, 0.0
    if n_rows > 1e-3 * rows.numel():
        fail(f"{name} differs from its plain version on {n_rows} of {rows.numel()} rows")
    qs, gi, wi = q[rows], got_idx[rows], want_idx[rows]
    prob = rows.nonzero()[:, 0]
    pick = lambda i: batch_take(r[prob], i)  # (n, k, 3)
    d_got = nn.sq_dists_plain(qs[:, None], pick(gi))[:, 0]
    d_want = nn.sq_dists_plain(qs[:, None], pick(wi))[:, 0]
    err = (d_got - d_want).abs().max().item()
    if not bool(ulp_close(d_got, d_want).all()):
        fail(f"{name} differs from its plain version on {n_rows} of {rows.numel()} rows "
             f"(max |d| gap {err}) beyond the 1-ulp tie rule")
    return n_rows, err


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
    records.append(("frame_votes", "probe.cu", "sgtd_tpu/ops/pallas_probe.py:67", err, ms, plain_ms))

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
    records.append(("expand_jobs", "expand.cu", "sgtd_tpu/ops/pallas_expand.py:73", err, ms, plain_ms))

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
    records.append(("hypothesis_votes", "verify.cu", "sgtd_tpu/ops/pallas_verify.py:83", err, ms, plain_ms))

    # B4 nn1: 16 queries x 4 candidates, 1,024 source x 4,096 target points
    # (the rerank's correspondences), a fifth of each displaced to 1e6 as
    # masked points are, and planted exact duplicates (distance ties).
    from sgtd_tpu_torch.ops import nn

    p, n_src, n_tgt = CHUNK * RERANK_K, SRC_PTS, CLOUD_PTS
    src = rng.uniform(-50, 50, (p, n_src, 3)).astype(np.float32)
    tgt = rng.uniform(-50, 50, (p, n_tgt, 3)).astype(np.float32)
    tgt[:, 2048:2560] = tgt[:, :512]
    src[:, :256] = tgt[:, 100:356] + rng.normal(0, 0.01, (p, 256, 3)).astype(np.float32)
    src[rng.uniform(size=(p, n_src)) < 0.2] = 1e6
    tgt[rng.uniform(size=(p, n_tgt)) < 0.2] = 1e6
    src, tgt = torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)
    got_i, got_d = nn.nn1(src, tgt)
    want_i, want_d = nn.nn1_plain(src, tgt)
    n_rows, err = check_nn_rows("B4 nn1", src, tgt, got_i, want_i)
    same = got_i == want_i
    if not bool((got_d[same] == want_d[same]).all()):
        fail("B4 nn1: equal picks with unequal distances")
    err = max(err, (got_d - want_d).abs().max().item())
    ms = event_ms(lambda: nn.nn1(src, tgt), 50)
    plain_ms = event_ms(lambda: nn.nn1_plain(src, tgt), 1, 3)
    log(f"B4 nn1 ({p}, {n_src}) x ({p}, {n_tgt}): {n_rows} rows differ (1-ulp rule), "
        f"max |err| {err}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events) [{card}]")
    records.append(("nn1", "nn.cu", "sgtd_tpu/ops/pallas_nn.py:81", err, ms, plain_ms))

    # B5 knn, k 20, self: the map covariances (200 keyframes x 4,096) and
    # the query covariances of one chunk (16 x 1,024), with masked points.
    errs, times = [], []
    for shape in ((NUM_MAP, CLOUD_PTS), (CHUNK, SRC_PTS)):
        pts = rng.uniform(-50, 50, shape + (3,)).astype(np.float32)
        pts[:, 1000:1010] = pts[:, :10]
        pts[rng.uniform(size=shape) < 0.2] = 1e6
        pts = torch.from_numpy(pts).to(dev)
        k = 20
        got = nn.knn(pts, pts, k)
        want = nn.knn_plain(pts, pts, k)
        n_rows, err = check_nn_rows(f"B5 knn {shape}", pts, pts, got, want)
        ms = event_ms(lambda: nn.knn(pts, pts, k), 3 if shape[0] == NUM_MAP else 50)
        plain_ms = event_ms(lambda: nn.knn_plain(pts, pts, k), 1, 3)
        log(f"B5 knn {shape} self, k {k}: {n_rows} rows differ (1-ulp rule), max |err| {err}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events) [{card}]")
        errs.append(err)
        times.append((ms, plain_ms))
    # The record carries the per-chunk shape (16 x 1,024); the map build's
    # is logged above.
    records.append(("knn", "nn.cu", "sgtd_tpu/ops/pallas_nn.py:133", max(errs), *times[1]))
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
    maps, queries, world = make_map_and_queries(
        cfg, seed=SEED, num_map_frames=NUM_MAP, num_queries=NUM_QUERIES,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    map_batch = stack_graphs(maps, dev)
    chunks = [stack_graphs(queries[i : i + CHUNK], dev) for i in range(0, NUM_QUERIES, CHUNK)]

    reset_counts()
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
    launches = read_counts()[:3]
    log(f"descriptor-only path kernel launches (B1-B3): {launches}")
    if min(launches) <= 0:
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
    return cfg, db, world, queries, chunks


def refined_stages(db, graphs, q_clouds, q_masks, map_clouds, map_masks, map_covs, cfg):
    """``localize_refined`` on one chunk, stage by stage through the port's
    public functions, synchronized after each: (RefinedResult, pick, ms per
    stage)."""
    from sgtd_tpu_torch.desc.triangles import build_descriptors
    from sgtd_tpu_torch.geom import se3
    from sgtd_tpu_torch.match.pipeline import RefinedResult, rank_candidates, rerank_pick
    from sgtd_tpu_torch.match.search import candidate_search
    from sgtd_tpu_torch.match.verify import verify_candidates
    from sgtd_tpu_torch.refine.gicp import gicp_align, point_covariances

    ms = {}
    torch.cuda.synchronize()
    t = [time.perf_counter()]

    def tick(name):
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ms[name] = (t[-1] - t[-2]) * 1e3

    query = build_descriptors(graphs, cfg.desc, cfg.caps)
    tick("descriptors")
    cand = candidate_search(db, query, cfg.desc, cfg.search, cfg.caps)
    tick("search")
    res = rank_candidates(db, query, cand, verify_candidates(db, query, cand, cfg.search), cfg)
    tick("verify")
    src_cov = point_covariances(q_clouds, q_masks, cfg.gicp)
    tick("query_covariances")
    # gicp_rerank's body with the source covariances timed apart.
    frames_k = res.frames[:, :RERANK_K].long()
    inits = se3.rt_to_mat(res.rot[:, :RERANK_K], res.trans[:, :RERANK_K])
    per_k = lambda x: x[:, None].expand((x.shape[0], RERANK_K) + x.shape[1:])
    out = gicp_align(per_k(q_clouds), per_k(q_masks), map_clouds[frames_k], map_masks[frames_k],
                     inits, cfg.gicp, src_cov=per_k(src_cov), tgt_cov=map_covs[frames_k])
    tick("lm_loop")
    pick, use, refined = rerank_pick(
        out.fitness_gated, out.inlier_frac, db.frame_poses[frames_k] @ out.transform,
        res.poses[:, :RERANK_K], res.found, cfg.gicp,
    )
    rows = torch.arange(pick.shape[0], device=pick.device)
    result = RefinedResult(
        pose=torch.where(use[:, None, None], refined[rows, pick], res.poses[:, 0]),
        refined=use, fitness=out.fitness[rows, pick], result=res,
    )
    tick("pick")
    return result, pick, ms


def pose_gap(a: torch.Tensor, b: torch.Tensor):
    """Largest translation (m) and rotation (rad, from the skew part) gap."""
    a, b = a.double(), b.double()
    dt = (a[:, :3, 3] - b[:, :3, 3]).norm(dim=-1).max().item()
    rel = a[:, :3, :3].transpose(-1, -2) @ b[:, :3, :3]
    skew = rel - rel.transpose(-1, -2)
    s = torch.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], -1).norm(dim=-1) / 2
    return dt, torch.arcsin(s.clamp(0, 1)).max().item()


def refined_path(dev, card: str, cfg, db, world, queries, chunks):
    """Phase 4: the refined main path (bench.py:153-213) on the same DB."""
    from sgtd_tpu_torch.data.synthetic import render_planar_cloud
    from sgtd_tpu_torch.eval.metrics import rpe, success_rate
    from sgtd_tpu_torch.interop import map_clouds_to_device
    from sgtd_tpu_torch.match.pipeline import localize_refined
    from sgtd_tpu_torch.match.search import TRUNC_SCAN
    from sgtd_tpu_torch.ops import nn
    from sgtd_tpu_torch.ops.voxel import load_query_cloud
    from sgtd_tpu_torch.refine.gicp import point_covariances

    t0 = time.perf_counter()
    rng = np.random.default_rng(77)
    mc, mm = zip(*(render_planar_cloud(world, p, rng, max_points=CLOUD_PTS) for p in world.map_poses))
    qc, qm = [], []
    for p in world.query_poses:
        c, m = render_planar_cloud(world, p, rng, max_points=CLOUD_PTS)
        a, b = load_query_cloud(c[m], cfg.gicp.leaf_size, SRC_PTS)
        qc.append(a)
        qm.append(b)
    map_clouds, map_masks, _ = map_clouds_to_device(mc, mm, None, dev, f_pad=db.frame_poses.shape[0])
    q_clouds = torch.from_numpy(np.stack(qc)).to(dev)
    q_masks = torch.from_numpy(np.stack(qm)).to(dev)
    log(f"clouds: {len(mc)} keyframes x {CLOUD_PTS} points, {NUM_QUERIES} sources of "
        f"{int(q_masks.sum(1).float().mean())} points on average (leaf {cfg.gicp.leaf_size}) "
        f"rendered in {time.perf_counter() - t0:.2f} s (host)")

    sl = [slice(i, i + CHUNK) for i in range(0, NUM_QUERIES, CHUNK)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    map_covs = point_covariances(map_clouds, map_masks, cfg.gicp)
    torch.cuda.synchronize()
    cov_s = time.perf_counter() - t0
    results = [
        localize_refined(db, q, q_clouds[s], q_masks[s], map_clouds, map_masks, map_covs,
                         cfg, rerank_k=RERANK_K)
        for q, s in zip(chunks, sl)
    ]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"refined path kernel launches (B1-B5): {launches}")
    if min(launches) <= 0:
        fail(f"a kernel of the refined path was never launched: {launches}")

    pose = torch.cat([r.pose for r in results])
    refined = torch.cat([r.refined for r in results])
    found = torch.cat([r.result.found for r in results])
    truncated = torch.cat([r.result.truncated for r in results]).cpu().numpy()
    if tuple(pose.shape) != (NUM_QUERIES, 4, 4) or not bool(torch.isfinite(pose).all()):
        fail(f"refined poses: shape {tuple(pose.shape)} or non-finite values")
    n_trunc = int(((truncated & TRUNC_SCAN) != 0).sum())
    gts = [g.pose for g in queries]
    host_pose, host_found = pose.cpu().numpy(), found.cpu().numpy()
    sr = success_rate(gts, host_pose, host_found, cfg)
    errs = np.array([rpe(np.asarray(g), e) for g, e in zip(gts, host_pose)])
    rmse_t, rmse_r = np.sqrt((errs ** 2).mean(0))
    desc = torch.cat([r.result.poses[:, 0] for r in results]).cpu().numpy()
    sr_desc = success_rate(gts, desc, host_found, cfg)
    derrs = np.array([rpe(np.asarray(g), e) for g, e in zip(gts, desc)])
    log(f"refined bench world: SR={sr:.4f} (descriptor poses {sr_desc:.4f}) TRUNC_SCAN={n_trunc} "
        f"refined share={float(refined.float().mean()):.4f} pose RMSE {rmse_t:.4f} m / {rmse_r:.4f} deg "
        f"(descriptor poses {np.sqrt((derrs[:, 0] ** 2).mean()):.4f} m / "
        f"{np.sqrt((derrs[:, 1] ** 2).mean()):.4f} deg) map covariances {cov_s:.4f} s [{card}]")
    if n_trunc:
        fail(f"{n_trunc} queries overflowed the calibrated scan cap")
    if sr < SR_GATE:
        fail(f"refined success rate {sr:.4f} below {SR_GATE}")

    # Chunk 0 stage by stage; the same chunk with B4/B5 as plain versions.
    args = (db, chunks[0], q_clouds[sl[0]], q_masks[sl[0]], map_clouds, map_masks, map_covs, cfg)
    staged, pick, _ = refined_stages(*args)
    dt, dr = pose_gap(staged.pose, results[0].pose)
    if dt > POS_TOL_M or dr > ROT_TOL_RAD or not torch.equal(staged.refined, results[0].refined):
        fail(f"stage-by-stage chunk 0 differs from localize_refined ({dt} m, {dr} rad)")
    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(nn, "nn1", nn.nn1_plain))
        stack.enter_context(mock.patch.object(nn, "knn", nn.knn_plain))
        plain, plain_pick, _ = refined_stages(*args)
    dt, dr = pose_gap(plain.pose, staged.pose)
    for name, a, b in (("pick", plain_pick, pick), ("refined", plain.refined, staged.refined),
                       ("found", plain.result.found, staged.result.found)):
        if not torch.equal(a, b):
            fail(f"plain-version rerun differs in {name}")
    if dt > POS_TOL_M or dr > ROT_TOL_RAD:
        fail(f"plain-version rerun poses differ by {dt} m / {dr} rad")
    log(f"plain-version (B4, B5) rerun of chunk 0: pick, refined, found equal; poses within "
        f"{dt:.3e} m / {dr:.3e} rad")

    splits = [refined_stages(*args)[2] for _ in range(5)]
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    log("refined chunk stage split, ms (median of 5, synchronized per stage): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"; total {sum(split.values()):.2f} [{card}]")

    times = []
    for _ in range(REPS):
        times.append(sum(
            timed_ms(lambda q=q, s=s: localize_refined(
                db, q, q_clouds[s], q_masks[s], map_clouds, map_masks, map_covs, cfg,
                rerank_k=RERANK_K))
            for q, s in zip(chunks, sl)) / 1e3)
    scans_s = [NUM_QUERIES / s for s in times]
    log(f"refined steady state: scans/s per rep {scans_s} (median {statistics.median(scans_s):.2f}, "
        f"chunk {CHUNK}, rerank_k {RERANK_K}, synchronized per chunk) [{card}]")
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
    ctx = main_path(dev, card)
    launches = refined_path(dev, card, *ctx)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"sgtd_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for (name, src, replaces, err, ms, plain_ms), n in zip(records, launches)
    ]}), flush=True)
    log(f"total: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
