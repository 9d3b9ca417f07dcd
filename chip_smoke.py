"""Drive the PyTorch port's localization paths on one CUDA card, end to end.

    python3 chip_smoke.py [--scale-frames N] [--baseline TREE]... [--kernels-only] [--sass FILE]

Phases (any failure ends the run with a non-zero exit):

0. Device: requires a CUDA card, prints its name and power limit, turns
   TF32 off.
1. Build: compiles the hand-written kernels (``sgtd_tpu_torch/csrc``) with
   nvcc, one process per source, and prints the seconds taken.
2. Kernels against their plain PyTorch versions at the bench shapes, on
   inputs seeded from NumPy: B1 and B2 must be equal (B2 on the slots
   below each query's total), B3 equal except on pairs whose float64 d^2
   lies within 1e-3 of thr^2, each launched twice for the same bits. B1
   also at one query's row and where a cluster kernel with coalesced
   4-slot pieces can go wrong (``check_frame_votes_edges``: B 1, 3, 16 x L
   1, 15, 16, 17, 4,099, 98,304 x f_pad 1, 7, 200, 2,048, ids -1, f_pad,
   f_pad + 1 and int32 min and max, all hits, no hits, one frame, rows
   off their 16-byte boundaries), with what its inputs ask
   (``frame_votes_work``: hits, hit-free groups and pieces, the largest
   bin's share); B1's bound counts the frame bytes of the 4-slot pieces
   that hold a hit only, since the kernel skips the others
   (``frame_votes_nbytes``). B2
   also at the 5,000-keyframe chunk's shape (8 x 55,296 jobs -> 1,802,240
   slots), at one query's, and where a tile-wise expansion can go wrong
   (``check_expand_edges``: an ``l_max`` that is no multiple of 4 or of a
   tile, a run of more empty jobs than a tile has slots, a job over many
   tiles, heads on tile boundaries, all jobs empty, a total above
   ``l_max``, 1, 3 and 8 channels), and with the offsets handed in. B3 also
   at 400 and 50 candidates and where a count of several pairs a thread
   can go wrong (``check_votes_edges``: a mask with holes, P 700, 513,
   130, 3, 2, 1, H 1 and ``MAX_H``, every pair valid, none), with what
   the inputs ask of its tile skip and its pairs-a-lane choice
   (``votes_work``) and the pace of its loop. B4 and B5 equal
   except on rows whose kernel and plain picks lie within 1 ulp of each
   other (at most 0.1% of rows); B4 at 64, 160 and 4 problems of 1,024 x
   4,096 points (a chunk, the hard world's chunk, one query) and at
   70,000 problems of 8 x 16, each launched twice for the same bits, with
   the SM clock under its load and what its deferred argmin meets on
   these clouds (``rescan_share``); B6 equal at the 5,000-keyframe scan
   (8 x 1,802,240 slots) for f_pad 5,000 and 20,000, and at f_pad 65,544
   (its global-memory branch). B7 at the rerank's shapes (64 problems,
   1,024 source x 4,096 target points, a tenth of each side masked) and at
   160 problems, with no gate and with a 1.0 m gate, at 4 problems and at
   70,000 problems of 2 x 16 points in one launch: the per-point b and
   w equal (the same 1-ulp rule), M within 1e-5 of its point's largest
   entry, H and g within rtol 2e-4 + atol 2e-2, y0 and the sum of squared
   distances within rtol 1e-4 (nvcc contracts the algebra into FMAs, the
   plain version does not), and two launches on the same inputs give the
   same bits. B5 also at the shapes a warp-level selection can get wrong
   (``check_knn_edges``: k 1, 20, 32; T = k; T 33, 1,000, 1,025; N 1 and
   100; one repeated point; 30% of a cloud masked; self queries; 70,000
   problems), each launched twice for the same bits. B8 equal at
   (399,104, 2) x 106,496 rows and at (9,775,363, 2) x 14,417,920, and on
   each table at L 1, 3 and 4,099, with an index vector off its 8-byte
   boundary, and at W 3. Every kernel's ``ms`` is a CUDA-event time of
   launches queued behind a device spin, so that it is the device's time
   and not the host's launch rate (``event_ms``): for B1-B3 and B6 of the
   kernel's body (the C entry point on inputs made beforehand,
   ``body_ms``), beside the host-clocked median of 20 synchronized calls
   of the wrapper (``wrapper_ms``) and of the plain version; for B4, B5,
   B7, B8 of the wrapper (B8 and ``index_select`` in turns). Each kernel's time stands
   beside its bound on the card (bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, whichever is larger) and, where one
   PyTorch call computes the same function, that call's time; B5's record
   carries the map build's shape under ``map``, B8's the 14.4M-row scan
   under ``scan``, B2's, B3's, B4's and B7's other shapes under ``shapes``.
   B3's bound is printed beside the floor of sums that may not contract
   into FMAs. Then the host cost of a call of each wrapper
   (``host_us``: the host clock over 200 back-to-back calls on tiny
   inputs, one synchronize at the end, least of 7 rounds), beside
   ``index_select``'s and the two parts of B8's (output allocation,
   launch). With ``--baseline TREE`` (another tree of the port, e.g. the
   parent commit unpacked by ``git archive`` under ``build/``; the flag
   may be repeated) the host costs of the first such tree and this one
   are taken in turns, a process a reading; B1's, B2's, B3's and B6's
   wrappers of that tree and of this one are read in turns in this one
   process (``wrapper_turns``: host cost, and B1's and B6's synchronized
   calls at their bench shapes); and the B1, B6, B2, B3, B4, B7, B5 and
   B8 kernel bodies of every built library are timed in turns on the same
   inputs (B1 at the bench shape, one query's and, in phase 4, every
   chunk's real inputs: ``votes_turns``; B6 at f_pad 5,000 and
   20,000; B2 at the bench shape, the
   5,000-keyframe chunk's and one query's, also followed by one pass that
   reads its output; B3 at 800, 400 and 50 candidates; B4 and B7 at 64,
   160 and 4 problems; B8 on random rows and on runs of consecutive
   rows), equal outputs required (B2: on valid slots). ``--sass FILE``
   writes the built library's SASS there (``cuobjdump -sass``);
   ``--kernels-only`` stops here.
3. The descriptor-only path on the bench world (seed 2026, 200 map
   keyframes, 64 queries): descriptors, on-device DB build and scan-slot
   calibration, then ``localize`` of all queries in chunks of 16. Gates:
   zero TRUNC_SCAN, success rate >= 0.95, B1-B3 launched. One chunk
   re-runs with the plain versions and must give the same candidates and
   votes. B8, which no module calls, gathers the packed2 words of that
   chunk's kept hits; their frames must equal the probe stage's. Prints
   DB build seconds and steady-state scans/s.
4. The refined main path (``bench.py``'s): keyframe clouds of 4,096
   points and their covariances (B5) on the card, query sources
   voxel-downsampled to at most 1,024 points, then ``localize_refined``
   with the GICP rerank of the top 4 candidates, chunks of 16. Gates:
   zero TRUNC_SCAN, success rate >= 0.95 on the refined poses, finite
   poses, every kernel launched. Prints what B1 meets on every chunk's
   real inputs and its body on them. One chunk re-runs with B4/B5 patched to
   their plain versions and must give the same pick, refined and found,
   with poses within 5e-3 m and 1e-3 rad. Prints what B4's deferred argmin
   meets on that chunk's real clouds (``rescan_share``), what B3's tile
   skip and pairs-a-lane choice meet on every chunk's real candidates
   (``warp_skip_share``, ``votes_work``), the refined share, the
   pose RMSE, the stage split of one chunk, map-covariance seconds and
   steady-state scans/s.
5. The large map: the world of ``tools/scale_bench.py`` (seed 2027,
   ``--scale-frames`` keyframes, default 5,000, extent max(400, 32 sqrt(N))
   m, 32 queries with centre noise 0.05 m and dropout 0.1), descriptors in
   chunks, DB build and scan calibration under a 2^23-slot ceiling, then
   ``localize`` in chunks of 8. Gates, each on the same DB and queries:
   (1) the default config: zero TRUNC_SCAN, SR >= 0.95, B6 launched and
   B1 not; (2) candidate-major pair lists (sel_max_scan_slots 0): the
   same candidates and votes, SR >= 0.95; (3) one chunk without the
   bucket table (bisection): frames and votes equal to (1)'s; (4) one
   chunk under a cap far below its scan (TRUNC_SCAN set), then
   ``localize_exact``: frames and votes equal to (2)'s; (5) one chunk on
   the DB padded to 65,544 frames (frame-id gathers, argsort pair
   grouping, B6's global branch): the live candidates' frames, votes and
   scores equal to (1)'s; (6) one chunk with B6 patched to its plain
   version: frames, votes, found and best_frame equal. Prints rows,
   f_pad, scan slots, bucket cap, DB build seconds, SR, a stage split,
   steady-state scans/s and the SHA-256 of (1)'s candidate frames (int32)
   and votes (float32) in (votes desc, frame asc) order; at 5,000
   keyframes the rows and the digest must equal the JAX reference's.

6. The fused refined path: phase 4's inputs through ``localize_refined``
   with ``refine.gicp._USE_FUSED_LINEARIZE`` patched on, so every LM trip
   is one launch of B7. Gates: zero TRUNC_SCAN, refined success rate >=
   0.95, pick, found and refined equal to the unfused path's on all 64
   queries, poses within 2e-2 m (FUSED_POS_TOL_M) and 1e-3 rad of it, B7 launched at least
   once and at most ``max_iterations`` times a chunk and B4 exactly once
   a chunk; one chunk re-runs with B7 patched to its plain version and
   must give the same pick and poses within the same tolerance. Prints
   the chunk's stage split and steady-state scans/s, fused and unfused
   measured in turns.
7. ``evaluate`` on the hard world (``tools/hard_eval.py``'s: rng 411, 200
   map keyframes, 64 queries, 2 motifs, 2 unique instances per block,
   query centre noise 0.45 m, dropout 0.35, label corruption 0.15; planar
   clouds of 4,096 points, leaf 0.5 m, a 1.0 m correspondence gate,
   sources of at most 1,024 points, rerank of the top 10, batches of 16)
   through ``build_map_index`` and ``evaluate``: descriptor-only, refined
   unfused and refined fused. Gates: DB rows, descriptor-only success
   rate and the SHA-256 of (found, best frame) equal to the JAX
   reference's on the CPU; descriptor-only success rate in [0.80, 1.0);
   both refined runs at least 0.02 above it; fused and unfused pick the
   same frame on every query; one query under a scan cap far below its
   scan goes through ``localize_exact`` and ``_rerank_single`` and must
   land within the success gate. Prints the three summary tables. The
   oracle gate of tests/test_hard_workload.py:87-109: on the first 8
   queries (HARD_EVAL_r05.json's ``oracle_subsample``) the descriptor-only
   success rate is at least that of the port's reference oracle
   (``eval.oracle``, plain Python on the host, run in a worker process
   beside phases 5-8 and read after phase 8).
8. The CLI on files: phase 3's bench world written to a temporary
   directory as graph JSONs and .bin scans of the valid points of phase
   4's 4,096-point renders (``write_cli_world``), then ``python -m
   sgtd_tpu_torch.cli localize`` in subprocesses with ``CLI_FLAGS`` and
   ``--map-artifacts``, ``--engine gicp`` and ``--engine vgicp`` side by
   side, twice each (the first run builds and saves the artifacts, the
   second loads them). Gates: exit 0, total 64, zero TRUNC_SCAN under the
   CLI's config, GICP success rate >= 0.95, VGICP success rate at least
   the JAX reference CLI's on the same files (``REFERENCE_CLI_VGICP_SR``)
   less 1/64, each load run's summary equal to its build run's on every
   key that holds no time, the native loader built. In process, with the
   CLI's readers and cloud loaders: the map artifacts with voxel maps
   built (seconds), saved and loaded (seconds, equal fields); ``evaluate``
   with GICP equal to the CLI's summary, every kernel of its path
   launched; ``evaluate`` with VGICP (B1-B3 and B5 launched, B4 and B7
   not; steady-state scans/s); chunk 0's VGICP rerank stage by stage
   (covariances, voxel-map gather, LM loop) equal to ``localize_refined``
   and, with B5 patched to its plain version, the same pick, refined and
   found with poses within 5e-3 m and 1e-3 rad; the DB through
   ``save_database`` and ``load_database`` with equal fields.
9. The front end on the card: a ``make_world`` world (seed 2026, 1,920
   instances) rendered as 64 map and 16 query labeled scans of about
   120,000 points (``render_labeled_scan``: every visible instance a blob
   of at least 400 points, class ``min(label, 11) + 7``, instance id 0 as
   a semantic-only network gives, and a class-10 sidewalk sheet), written
   as .bin/.label files with KITTI-layout poses; ``python -m
   sgtd_tpu_torch.cli build-map --dataset raw`` on both directories in
   processes of their own, side by side (DCVC at ``DcvcConfig()`` widths,
   ``max_nodes`` 128). Gates: the graphs of map keyframes 0, 21, 42 and
   63 against the JAX reference's (``tests/data/frontend_reference.json``:
   labels and masks equal, centres within 1e-4 m, densities within a
   relative 1e-4); at least 95% of the rendered instances that the routing
   clusters (at least ``min_seg`` points, inside the range gates) have a
   node of their label within 0.1 m; the port's ``evaluate`` on the built
   graphs at SR >= 0.95 with zero TRUNC_SCAN and B1-B3 launched; a
   ``--local-map-radius 15`` map of the first 16 keyframes (in process)
   with no fewer nodes than the single scans. Then FEC on B5: one
   class-filtered cloud of map scan 0, padded to 32,768 points, through
   ``fec_cluster`` (max_n 16) with B5 and with B5's plain version: equal
   labels and counts, B5 launched (``fec_launches`` in B5's record), B5's
   kernel and plain times at this shape beside its bound (B5's record,
   under ``fec``). Prints build-map scans/s in process (median of 3 passes
   over the 64 map scans) and DCVC sweeps a scan.
10. The back end and multi-session SLAM, at the reference tests' own
   sizes: PGO-CG on tests/test_pgo.py's 4,096-node graph (a 300 m circle,
   odometry drifting by PGO_DRIFT a step, 31 loops to node 0; 6 GN steps
   of 300 CG iterations), twice; BA-CG on tests/test_ba.py's problem at
   5,000 keyframes, 20,000 landmarks and 4 observations each (4 GN steps
   of 150), twice; dense PGO on the same construction at 1,024 nodes, the
   largest the session sends to the dense solver, beside the same
   function on float64 tensors and PCG; dense BA on a 6-keyframe problem
   beside BA-CG. Gates: each CG run's second bits equal to its first; the
   PGO end errors below 0.2 of the drift's; BA's cost below 1e-2 of its
   first and median translation error below 0.05 m; dense PGO within
   ``DENSE_F64_TOL`` of float64; dense BA within 2e-3 of BA-CG. Then
   ``localize_and_optimize_session`` on a drifting session
   (``session_inputs``) of 32 scans of phase 3's bench world (dense,
   B1-B3 launched, loops equal to the JAX reference's,
   ``REFERENCE_SESSION``) and of 16 scans of phase 5's map (5,016 nodes:
   PCG; B6 launched and B1 not), each with tests/test_multisession.py's
   gates: at least half the scans loop, every corrected pose within 1.0
   m. Prints each one's seconds.

11. The multi-device paths (``sgtd_tpu_torch.parallel``), each rank a
   process of ``python -m sgtd_tpu_torch.parallel.multihost_check`` started
   by ``run_world`` on this card, on phase 3's DB and queries, phase 5's
   DB and queries and phase 10's BA problem, written under build/phase11.
   World A, NCCL, one rank: the sharded localizer at mesh (1, 1) and the
   ring at 1 block on the 64 bench queries (frames, votes, found and best
   frame equal to phase 3's, accepted candidates' poses within
   ``POS_TOL_M``; B1-B3 launched), sharded BA at phase 10's 5,000 x
   20,000 x 4 (phase 10's BA gates). Then a 2-rank NCCL world on the one
   card, which NCCL refuses (printed, not gated). World B, gloo, 8 ranks
   on the card: (a) the sharded localizer at mesh (2, 4) and (b) the ring
   of 8 blocks on the first ``SHARDED_QUERIES`` bench queries (TRUNC_SCAN
   0, sorted votes bit-identical and found equal to phase 3's, every top
   pose within the success gates; (a)'s SHA-256 of found and best_frame
   equal to the JAX reference's, ``REFERENCE_SHARDED``); (c) the sharded
   localizer at mesh (1, 8) on phase 5's 32 queries (sorted votes
   bit-identical to phase 5's, TRUNC_SCAN 0, SR >= 0.95; queries whose
   found differs from phase 5's printed: the per-shard pair quota is the
   reference's design); (d) sharded BA on 8 ranks (phase 10's BA gates,
   the gap to phase 10's BA-CG printed). Every rank of (a) and (b) must
   launch B1-B3, of (c) B6, B2 and B3; every rank checks that it loaded
   no ``jax`` or ``sgtd_tpu`` module. Prints each world's start-up
   seconds and each leg's seconds, load seconds, collective calls and
   seconds (synchronized) and launches.

After the last phase one ``torch.profiler`` session counts the device
activities of one call of B1's wrapper at the bench shape (and of the
first baseline's): this tree's must be one (with ``--kernels-only``, at
the end of phase 2); in the same session, those of one GN step of PGO-CG
and BA-CG with one and with two CG iterations (their difference: a CG
iteration's). No ``jax`` or ``sgtd_tpu`` module may be loaded, with
the CLI, ``io``, ``native``, ``refine.vgicp``, ``eval.oracle``, the front
end's, the back end's and the multi-device modules imported. The
line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import hashlib
import importlib
import importlib.util
import inspect
import json
import multiprocessing
import os
import re
import shutil
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
# Fused against unfused LM on the card: every float of a trip differs by
# ulps (FMA contraction in B7, another order of sums), and one flipped LM
# decision (rho >= 0, convergence) moves an end pose by a few step
# lengths in the bench world's shallow GICP basins (its refined poses sit
# 0.8 m from the truth): 7.8e-3 m was measured, against an SR gate of 5 m.
FUSED_POS_TOL_M = 2e-2
# The large map (tools/scale_bench.py:40-112).
SCALE_SEED, SCALE_QUERIES, SCALE_CHUNK, SCALE_SAMPLE = 2027, 32, 8, 16
SCALE_SLOT_CEILING, SCALE_BUILD_CHUNK, WIDE_F_PAD = 1 << 23, 256, 65544
# The JAX reference on the 5,000-keyframe world (sgtd_tpu on the CPU, the
# pipeline of tools/scale_bench.py): DB rows and the SHA-256 of gate (1)'s
# candidates (candidates_sha256). tests/test_torch_scale.py's slow
# test_reference_5k_digest computes both again from sgtd_tpu.
REFERENCE_5K = {
    "rows": 9775363,
    "sha256": "d590f066fbcb4955314fb095f2f448774c92906c17e31ca3663d8ef174fe61a9",
}
# The hard world (tools/hard_eval.py with the settings of its recorded
# run) and the JAX reference's descriptor-only leg on it (sgtd_tpu on the
# CPU): DB rows, success rate, and the SHA-256 of the queries' found
# (uint8) and best_frame (int32). tests/test_torch_eval.py's slow
# test_reference_hard_world computes all three again from sgtd_tpu.
HARD_SEED, HARD_MOTIFS, HARD_UNIQUE = 411, 2, 2
HARD_OBS = dict(center_noise_m=0.45, dropout=0.35, label_corrupt_rate=0.15)
HARD_LEAF, HARD_GATE_M, HARD_RERANK_K = 0.5, 1.0, 10
# The oracle gate's subsample: the first 8 queries, as HARD_EVAL_r05.json's
# oracle_subsample.
ORACLE_QUERIES = 8
REFERENCE_HARD = {
    "rows": 310944,
    "success_rate": 0.890625,
    "sha256": "fe3e0e71b649986ed91678972fdf5abf5dae47c8943f4be2221feb7dd163e5b8",
}
# Phase 10 (the back end). The problems of tests/test_pgo.py and
# tests/test_ba.py at their own sizes, and a drifting session of the bench
# world (and of the 5,000-keyframe map) corrected against its map: scans
# at map keyframes 0..n-1, observed from SESSION_SEED with SESSION_OBS,
# odometry drifting by tests/test_multisession.py's step.
PGO_NODES, PGO_DENSE_NODES, PGO_GN, PGO_CG = 4096, 1024, 6, 300
PGO_DRIFT = (2e-4, 1e-4, 0.0, 0.0, 0.0, 5e-5)
BA_LARGE, BA_GN, BA_CG = (5000, 20000, 4), 4, 150
SESSION_SEED, SESSION_SCANS, SESSION_SCANS_5K = 2028, 32, 16
SESSION_DRIFT = (0.25, 0.1, 0.0, 0.0, 0.0, 0.01)
SESSION_OBS = dict(center_noise_m=0.05, dropout=0.1)
# Dense PGO at 1,024 nodes against the same function in float64 (m,
# rotation entry): the float32 solve's own error there, a 6,144-wide LU
# with a 1e8 anchor weight, is 1.5e-2 m for the JAX reference and 2.15e-2 m
# for the port on the CPU (1.2e-4 and 1.4e-4 in the rotation entries;
# tests/test_torch_pgo.py's slow test_dense_float32_error_at_1024_nodes).
DENSE_F64_TOL = (5e-2, 1e-3)
# The JAX reference's correction of the bench-world session (sgtd_tpu on
# the CPU, phase 3's DB and config): tests/test_torch_multisession.py's
# slow test_reference_session computes it again from sgtd_tpu.
REFERENCE_SESSION = {
    "num_loops": 29,
    "loop_frames": (-1, -1, -1, 2, 12, 6, 6, 4, 8, 4, 11, 10, 17, 10, 13, 15, 15, 22, 18, 18, 20, 21, 18, 22, 23,
                    20, 22, 27, 27, 27, 32, 31),
}
# Phase 11: the bench world's first SHARDED_QUERIES queries through the
# JAX reference's sharded localizer at mesh (2, 4) (sgtd_tpu on the CPU's 8
# virtual devices): DB rows and the SHA-256 of found and best_frame
# (found_frames_sha256). tests/test_torch_sharded_match.py's slow
# test_reference_sharded computes both again from sgtd_tpu.
SHARDED_QUERIES = 16
REFERENCE_SHARDED = {
    "rows": 399070,
    "sha256": "0ab90ff394ff6a6db6971c89229f3026db8ab4b7e546d628fb36efe23c6340b1",
}
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bytes/s and float32 FLOP/s outside the tensor cores.
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def synced_s(fn):
    """(fn(), seconds), synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_ms(fn) -> float:
    return synced_s(fn)[1] * 1e3


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


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` a device millisecond,
    measured once by CUDA events around a spin of 2e7 cycles."""
    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    return 2e7 / a.elapsed_time(b)


def event_ms(fn, launches: int, rounds: int = 5, spin: bool = True) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``launches``
    back-to-back calls, per call, after a warm-up.

    With ``spin`` the calls are queued behind a device spin
    (``torch.cuda._sleep``) sized to twice the host's time to queue them,
    so the device runs them back to back and the reading is the device's
    time, not the host's launch rate. After queuing, the event that ends
    the spin must still be pending (the host's queue ended first); else
    the spin is doubled and the round taken again, and the run fails after
    four tries. ``spin=False`` is for calls that may synchronize inside
    (the plain versions): a spin would then end before the queue did."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        for attempt in range(4):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(int(spin_cycles_per_ms() * (2 * queue_ms + 0.2) * 2 ** attempt))
            a.record()
            for _ in range(launches):
                fn()
            b.record()
            early = spin and a.query()
            torch.cuda.synchronize()
            if not early:
                break
        else:
            fail(f"event_ms: the device reached the calls before the host had queued them, four times "
                 f"({launches} calls, {queue_ms:.3f} ms to queue)")
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def body_ms(entry: str, dev, *args, launches: int = 50) -> float:
    """CUDA-event ms of one launch of the C entry point ``entry`` on inputs
    made beforehand (``event_ms`` of ``launches`` launches queued behind a
    device spin):
    the kernel's body, without its wrapper's checks, allocations and the
    tensor operations around the launch. Back-to-back launches on the same
    buffers find in the L2 cache what fits there, as a caller that has just
    made the inputs does."""
    from sgtd_tpu_torch.ops import _build

    return event_ms(lambda: _build.launch(entry, dev, *args), launches)


def kernel_record(name, source, replaces, err, ms, plain_ms, nbytes, flops, library_ms=None,
                  wrapper_ms=None) -> dict:
    """One entry of the kernels' JSON record. ``ms`` is the kernel's time by
    CUDA events; ``wrapper_ms``, where given, the host-clocked median of a
    synchronized call of the wrapper. The bound is the least time
    the card could take for the call: ``nbytes`` (each input read once,
    each output written once) over the memory rate, or ``flops`` (float32
    operations these inputs need) over the float32 peak, whichever is
    larger. ``launches`` is filled in after the path runs."""
    t_bytes, t_flops = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return {
        "name": name, "route": "cuda", "source": f"sgtd_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_flops), "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": library_ms,
        **({} if wrapper_ms is None else {"wrapper_ms": wrapper_ms}),
    }


def log_bound(rec: dict) -> None:
    lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
    log(f"   {rec['name']}: bound {rec['bound_ms']:.5f} ms by {rec['bound_by']} "
        f"({rec['bound_ms'] / rec['ms']:.3f} of the kernel's {rec['ms']:.4f} ms); one PyTorch call: {lib}")


def reset_counts() -> None:
    from sgtd_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def read_counts() -> list:
    """Every kernel's launches since the last ``reset_counts``, B1-B8."""
    from sgtd_tpu_torch.ops import launch_counts

    return launch_counts()


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


def scatter_add_ms(hit, frame, f_pad: int) -> float:
    """CUDA-event time of the one PyTorch call that computes the vote
    tally, ``scatter_add_`` of prepared float hits at prepared indices."""
    keep = hit & (frame >= 0) & (frame < f_pad)
    idx, val = torch.where(keep, frame, 0).long(), keep.to(torch.float32)
    out = torch.zeros(hit.shape[:-1] + (f_pad,), dtype=torch.float32, device=hit.device)
    return event_ms(lambda: out.scatter_add_(-1, idx, val), 10, 3)


def check_knn_edges(dev, rng) -> float:
    """B5 against its plain version (the 1-ulp rule of check_nn_rows, and
    the same bits from a second launch) where a warp-level selection can go
    wrong: k 1, 20, 32; T = k; T no multiple of the warp or the tile; one
    query and a hundred; a cloud of one repeated point; 30% of a cloud at
    the masked coordinate; self queries (zero and negative distances); more
    problems than a grid's y axis holds. Returns the largest distance gap."""
    from sgtd_tpu_torch.ops import nn

    cloud = lambda *shape: rng.uniform(-50, 50, shape + (3,)).astype(np.float32)
    same = np.broadcast_to(cloud(2, 1), (2, 100, 3)).copy()
    masked = cloud(3, 1025)
    masked[rng.uniform(size=(3, 1025)) < 0.3] = 1e6
    self_q = cloud(3, 1000)
    cases = [(f"k {k}", cloud(3, 100), cloud(3, 1000), k) for k in (1, 20, 32)]
    cases += [(f"T = k = {k}", cloud(3, 100), cloud(3, k), k) for k in (1, 20, 32)]
    cases += [(f"T {t}", cloud(3, 100), cloud(3, t), 20) for t in (33, 1000, 1025)]
    cases += [(f"N {n}", cloud(2, n), cloud(2, 300), 20) for n in (1, 100)]
    cases += [("one repeated point", same, same, 20), ("30% masked, self", masked, masked, 20),
              ("self", self_q, self_q, 20), ("self, k 32", self_q, self_q, 32),
              ("70,000 problems", cloud(70000, 1), cloud(70000, 33), 20)]
    worst = 0.0
    for name, q, r, k in cases:
        q, r = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
        got, want = nn.knn(q, r, k), nn.knn_plain(q, r, k)
        n_rows, err = check_nn_rows(f"B5 knn edge [{name}]", q, r, got, want)
        if not torch.equal(got, nn.knn(q, r, k)):
            fail(f"B5 knn edge [{name}]: two launches on the same input differ in their bits")
        if name == "one repeated point" and not torch.equal(
                got, torch.arange(k, dtype=torch.int32, device=dev).expand_as(got)):
            fail("B5 knn edge [one repeated point]: the answer must be 0..k-1")
        worst = max(worst, err)
        log(f"   B5 knn edge [{name}] {tuple(q.shape)} x {tuple(r.shape)} k {k}: "
            f"{n_rows} rows differ (1-ulp rule), same bits twice")
    return worst


HOST_COST_CALLS, HOST_COST_ROUNDS = 200, 7
CUOBJDUMP_DEFAULT = "/usr/local/cuda/bin/cuobjdump"


def host_us(fn) -> float:
    """Host-clock microseconds a call of ``fn``: HOST_COST_CALLS
    back-to-back calls and one synchronize at the end, the least of
    HOST_COST_ROUNDS such rounds after a warm-up. The host is shared and
    its neighbours only ever add time (single rounds spread by tens of
    percent), so the least round is the call's own cost."""
    for _ in range(20):
        fn()
    rounds = []
    for _ in range(HOST_COST_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_COST_CALLS):
            fn()
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / HOST_COST_CALLS * 1e6)
    return min(rounds)


def host_costs(dev) -> dict:
    """Host-clock microseconds a call (``host_us``) of each wrapper, B1-B8,
    then of ``index_select``, on inputs so small that the device is never
    the limit. It is the whole wrapper's host time: checks, allocations,
    the ctypes call, and for B1, B2 and B6 the tensor operations around the
    launch. The last entries split B8's: the allocation of its output and
    the launch alone (entry lookup, raw stream, ctypes conversion, the
    CUDA runtime's launch), where the tree has the launch helper."""
    from sgtd_tpu_torch.ops import _build, expand, gicp, nn, probe, verify

    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    hit, frame = torch.ones((1, 64), dtype=torch.bool, device=dev), i32(1, 64)
    length, payload = i32(1, 4) + 1, i32(1, 4, 2)
    rot, t_h, verts = torch.eye(3, device=dev).expand(1, 2, 3, 3).contiguous(), f32(1, 2, 3), f32(1, 4, 3, 3)
    ones4 = torch.ones((1, 4), dtype=torch.bool, device=dev)
    pts = torch.arange(24, dtype=torch.float32, device=dev).reshape(1, 8, 3)
    eye4, mask8 = torch.eye(4, device=dev)[None], torch.ones((1, 8), dtype=torch.bool, device=dev)
    gicp_payload = gicp.build_gicp_payload(pts, mask8, torch.eye(3, device=dev).expand(1, 8, 3, 3))
    cov6 = gicp.cov6(torch.eye(3, device=dev).expand(1, 8, 3, 3)).contiguous()
    table, idx = i32(64, 2), i32(16)
    calls = {
        "frame_votes": lambda: probe.frame_votes(hit, frame, 8),
        "expand_jobs": lambda: expand.expand_jobs(length, payload, 16),
        "hypothesis_votes": lambda: verify.hypothesis_votes(rot, t_h, verts, verts, ones4, 3.0),
        "nn1": lambda: nn.nn1(pts, pts),
        "knn": lambda: nn.knn(pts, pts, 2),
        "frame_votes_wide": lambda: probe.frame_votes_wide(hit, frame, 8),
        "linearize_gicp": lambda: gicp.linearize_sums(eye4, pts, cov6, mask8, pts, gicp_payload),
        "gather_rows": lambda: probe.gather_rows(table, idx),
        "index_select": lambda: torch.index_select(table, 0, idx),
    }
    calls["job_offsets"] = lambda: expand.job_offsets(length)
    if "offsets" in inspect.signature(expand.expand_jobs).parameters:
        offsets = expand.job_offsets(length)
        calls["expand_jobs: offsets passed"] = lambda: expand.expand_jobs(length, payload, 16, offsets=offsets)
    if hasattr(_build, "launch"):
        out_rows = table.new_empty((16, 2))
        calls["gather_rows: new_empty"] = lambda: table.new_empty((16, 2))
        calls["gather_rows: launch"] = lambda: _build.launch(
            "sgtd_gather_rows", table.device, table.data_ptr(), idx.data_ptr(), out_rows.data_ptr(), 16, 2)
    return {name: host_us(fn) for name, fn in calls.items()}


def clocks_under_load(fn) -> str:
    """nvidia-smi's reading of the SM clock, its maximum and the power draw,
    taken while calls of ``fn`` keep the card busy."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
                           stdout=subprocess.PIPE, text=True)
    while smi.poll() is None:
        for _ in range(100):
            fn()
    torch.cuda.synchronize()
    return smi.communicate()[0].strip()


def nn1_clouds(rng, p: int, n_src: int, n_tgt: int, dev):
    """``p`` pairs of random clouds for B4: a fifth of each side at the
    masked coordinate, an eighth of the targets exact duplicates of
    earlier ones, a quarter of the sources within 0.01 of a target."""
    src = rng.uniform(-50, 50, (p, n_src, 3)).astype(np.float32)
    tgt = rng.uniform(-50, 50, (p, n_tgt, 3)).astype(np.float32)
    dup = n_tgt // 8
    tgt[:, n_tgt // 2 : n_tgt // 2 + dup] = tgt[:, :dup]
    near = min(n_src // 4, n_tgt - n_tgt // 40)
    src[:, :near] = tgt[:, n_tgt // 40 : n_tgt // 40 + near] + rng.normal(0, 0.01, (p, near, 3)).astype(np.float32)
    src[rng.uniform(size=(p, n_src)) < 0.2] = 1e6
    tgt[rng.uniform(size=(p, n_tgt)) < 0.2] = 1e6
    return torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)


def rescan_share(q: torch.Tensor, r: torch.Tensor, group: int = 16):
    """What a deferred argmin over groups of ``group`` consecutive
    references meets on these clouds (P, N, 3) x (P, T, 3): the share of
    (query, group) pairs whose group minimum lies below the query's
    running minimum of the groups before (the scan of csrc/nn_common.cuh
    records the group there, without a branch), and the share of (warp of
    32 consecutive queries, group) pairs in which that holds on some lane
    (what a design that rescans the group inside the loop would pay)."""
    from sgtd_tpu_torch.ops import nn

    lane_hits = warp_hits = lane_all = warp_all = 0
    for qp, rp in zip(q, r):
        d = nn.sq_dists_plain(qp, rp)  # (N, T)
        n, t = d.shape
        pad_t, pad_n = -t % group, -n % 32
        d = torch.nn.functional.pad(d, (0, pad_t, 0, pad_n), value=float("inf"))
        gm = d.view(n + pad_n, -1, group).amin(-1)
        before = torch.cummin(gm, dim=1).values.roll(1, dims=1)
        before[:, 0] = float("inf")
        falls = (gm < before)[:n]
        lane_hits += int(falls.sum())
        lane_all += falls.numel()
        by_warp = torch.nn.functional.pad(falls, (0, 0, 0, pad_n)).view(-1, 32, falls.shape[1]).any(1)
        warp_hits += int(by_warp.sum())
        warp_all += by_warp.numel()
    return lane_hits / lane_all, warp_hits / warp_all


def check_expand(name: str, length, payload, l_max: int):
    """B2 against its plain version on one set of inputs: equal on the valid
    slots (those below each query's total, capped at ``l_max``), the same
    bits from a second launch on every slot, and from a call that is handed
    the offsets. Returns (max |err|, valid slots)."""
    from sgtd_tpu_torch.ops import expand

    got = expand.expand_jobs(length, payload, l_max)
    want = expand.expand_jobs_plain(length, payload, l_max)
    total = length.sum(-1).clamp(max=l_max)
    valid = torch.arange(l_max, device=length.device) < total[:, None]  # (B, L)
    err = ((got - want).abs() * valid[:, None]).max().item()
    if err != 0:
        fail(f"{name} differs from its plain version on valid slots (max |err| {err})")
    del want, valid
    if not torch.equal(got, expand.expand_jobs(length, payload, l_max)):
        fail(f"{name}: two launches on the same input differ in their bits")
    if not torch.equal(got, expand.expand_jobs(length, payload, l_max, offsets=expand.job_offsets(length))):
        fail(f"{name}: the call that is handed its offsets differs")
    return err, int(total.sum())


def expand_body_ms(dev, length, payload, l_max: int, launches: int = 50) -> float:
    """B2's kernel body by CUDA events, the offsets made beforehand."""
    from sgtd_tpu_torch.ops import expand

    b, nj, c = payload.shape
    offsets, payload = expand.job_offsets(length).contiguous(), payload.contiguous()
    out = payload.new_empty((b, c, l_max))
    return body_ms("sgtd_expand_jobs", dev, offsets.data_ptr(), payload.data_ptr(), out.data_ptr(),
                   b, nj, c, l_max, launches=launches)


INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def votes_inputs(rng, b: int, l: int, f_pad: int, kind: str, dev, offsets=(0, 0)):
    """(hit, frame) of B1's shape (b, l): ``mixed`` draws 30% hits and ids
    in [0, f_pad), a fifth of them replaced by ids that count nothing (-1,
    f_pad, f_pad + 1, int32 min and max); ``all hits``, ``no hits`` and
    ``one frame`` (every slot a hit on frame f_pad // 2) keep the mixed
    ids where they do not set them. ``offsets`` (hit bytes, frame ids) put
    the rows that far past the start of an aligned buffer."""
    hit = rng.uniform(size=(b, l)) < 0.3
    frame = rng.integers(0, f_pad, (b, l), dtype=np.int64)
    bad = rng.uniform(size=(b, l)) < 0.2
    frame[bad] = rng.choice([-1, f_pad, f_pad + 1, INT32_MIN, INT32_MAX], int(bad.sum()))
    if kind == "all hits":
        hit[:] = True
    elif kind == "no hits":
        hit[:] = False
    elif kind == "one frame":
        hit[:], frame[:] = True, f_pad // 2
    oh, of = offsets
    hit_buf = torch.zeros(b * l + oh, dtype=torch.bool, device=dev)
    frame_buf = torch.zeros(b * l + of, dtype=torch.int32, device=dev)
    hit_buf[oh:] = torch.from_numpy(hit.reshape(-1)).to(dev)
    frame_buf[of:] = torch.from_numpy(frame.reshape(-1).astype(np.int32)).to(dev)
    return hit_buf[oh:].view(b, l), frame_buf[of:].view(b, l)


def check_frame_votes(name: str, hit, frame, f_pad: int) -> float:
    """B1 against its plain version: float32 and equal on every bin, and a
    second launch gives the same bits. Returns max |err| (0)."""
    from sgtd_tpu_torch.ops import probe

    got = probe.frame_votes(hit, frame, f_pad)
    want = probe.frame_votes_plain(hit, frame, f_pad)
    if got.dtype != torch.float32 or got.shape != want.shape or not torch.equal(got, want):
        err = (got.float() - want).abs().max().item() if got.shape == want.shape else float("nan")
        fail(f"{name} differs from its plain version (max |err| {err})")
    if not torch.equal(got.view(torch.int32), probe.frame_votes(hit, frame, f_pad).view(torch.int32)):
        fail(f"{name}: two launches on the same input differ in their bits")
    return 0.0


def frame_votes_body_ms(hit, frame, f_pad: int, launches: int = 50) -> float:
    """B1's kernel body by CUDA events behind a device spin: one launch
    that writes the float32 counts whole."""
    b, l = hit.shape
    counts = hit.new_empty((b, f_pad), dtype=torch.float32)
    return body_ms("sgtd_frame_votes", hit.device, hit.data_ptr(), frame.data_ptr(), counts.data_ptr(), b, l, f_pad,
                   launches=launches)


def hit_free_share(hit, group: int) -> float:
    """Share of the ``group``-slot groups (from each row's start; a row's
    last group may be shorter) that hold no hit."""
    b, l = hit.shape
    return 1.0 - float(torch.nn.functional.pad(hit, (0, -l % group)).view(b, -1, group).any(-1).float().mean())


def frame_votes_nbytes(hit, f_pad: int, piece: int = 4) -> int:
    """Bytes B1 must move on these inputs: every hit byte read, the frame
    ids of every ``piece``-slot piece (from each row's start) that holds a
    hit read, the float32 counts written. The kernel skips the frame loads
    of hit-free pieces, so its bound counts only the frame bytes these
    inputs need."""
    b, l = hit.shape
    has = torch.nn.functional.pad(hit, (0, -l % piece)).view(b, -1, piece).any(-1).sum(0)
    slots = torch.full_like(has, piece)
    slots[-1:] = l - piece * (has.numel() - 1)  # the row's last piece may be shorter
    return b * l + 4 * int((has * slots).sum()) + 4 * b * f_pad


def frame_votes_work(hit, frame, f_pad: int) -> str:
    """What these inputs ask of B1: the share of slots that are hits, the
    shares of 16-slot groups and of 4-slot pieces (from each row's start)
    without a hit (the kernel skips the frame loads of such pieces), and
    the share of a query's counted hits that its largest bin takes (median
    and largest over the queries): the contention of its shared atomics."""
    b, l = hit.shape
    counted = hit & (frame >= 0) & (frame < f_pad)
    idx = torch.where(counted, frame, 0).long()
    bins = torch.zeros((b, f_pad), device=hit.device).scatter_add_(-1, idx, counted.float())
    top = (bins.amax(-1) / bins.sum(-1).clamp(min=1)).float()
    return (f"{float(hit.float().mean()):.4f} of the slots hit, {hit_free_share(hit, 16):.4f} of the 16-slot groups "
            f"and {hit_free_share(hit, 4):.4f} of the 4-slot pieces hold no hit, the largest bin takes "
            f"{float(top.median()):.4f} (median) and {float(top.max()):.4f} (most) of a query's counted hits")


def device_activities(calls: dict):
    """Device activities (kernels, memsets, copies) that ``torch.profiler``
    records over one call of each of ``calls`` (name -> function), all in
    one profiling session: on the card's machine a second session in a
    process recorded no device activity. The calls run 20 ms apart and
    their activities are told apart by those gaps. Fails where the session
    records no device activity at all: a check that counts them must not
    pass on a session that saw nothing."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        fail("device_activities: the torch.profiler session recorded no device activity (a process's later "
             "sessions record none on the card's machine: take this one first)")
    runs = [[spans[0]]]
    for span in spans[1:]:
        if span[0] - max(end for _, end in runs[-1]) > 10_000:  # us
            runs.append([])
        runs[-1].append(span)
    if len(runs) != len(calls):
        fail(f"device_activities: {len(runs)} runs of device activity for {len(calls)} calls")
    return {name: len(run) for name, run in zip(calls, runs)}


def log_frame_votes_activities(dev, card: str, old_probe=None, cg_calls=None) -> None:
    """The device activities of one call of B1's wrapper at the bench shape
    (``device_activities``), and of ``old_probe``'s where a baseline tree
    gave one; fails where this tree's call runs more than its one kernel.
    In the same session, those of phase 10's ``cg_calls`` (one GN step with
    one and with two CG iterations), whose difference is a CG iteration's."""
    from sgtd_tpu_torch.ops import probe

    hit, frame = votes_inputs(np.random.default_rng(SEED + 8), CHUNK, 98304, 200, "mixed", dev)
    calls = {"this tree": lambda: probe.frame_votes(hit, frame, 200)}
    if old_probe is not None:
        calls["baseline"] = lambda: old_probe.frame_votes(hit, frame, 200)
    calls.update(cg_calls or {})
    seen = device_activities(calls)
    b1 = {k: v for k, v in seen.items() if k in ("this tree", "baseline")}
    log(f"   device activities of one frame_votes call at ({CHUNK}, 98304) f_pad 200 (torch.profiler): {b1} [{card}]")
    if seen["this tree"] != 1:
        fail(f"B1 frame_votes: one call ran {seen['this tree']} device activities, not 1")
    for solver in ("PGO-CG", "BA-CG"):
        if f"{solver}, 1 iteration" in seen:
            one, two = seen[f"{solver}, 1 iteration"], seen[f"{solver}, 2 iterations"]
            log(f"   device activities of {solver}, one GN step: {one} with 1 CG iteration, {two} with 2: "
                f"{two - one} a CG iteration (torch.profiler) [{card}]")


def check_frame_votes_edges(dev, card: str) -> dict:
    """B1 against its plain version (``check_frame_votes``) at B 1, 3, 16 x L
    1, 15, 16, 17, 4,099, 98,304 x f_pad 1, 7, 200, 2,048 (rows off the
    16-byte boundary where L % 16 != 0; f_pad below the cluster's blocks),
    with ids -1, f_pad, f_pad + 1 and int32 min and max; all hits, no hits
    and every hit on one frame; rows whose hit and frame start off their
    boundaries (with the vector path still open, and closed). One query's
    row (1, 98,304) f_pad 200 timed. Returns {shape: ms, bound_ms, bound_by}."""
    rng = np.random.default_rng(SEED + 5)
    n = 0
    for b in (1, 3, 16):
        for l in (1, 15, 16, 17, 4099, 98304):
            for f_pad in (1, 7, 200, 2048):
                check_frame_votes(f"B1 frame_votes edge ({b}, {l}) f_pad {f_pad}",
                                  *votes_inputs(rng, b, l, f_pad, "mixed", dev), f_pad)
                n += 1
    cases = [(kind, shape) for kind in ("all hits", "no hits", "one frame")
             for shape in ((1, 17, 7), (3, 4099, 200), (16, 98304, 2048))]
    cases += [(f"hit +{oh} B, frame +{of} ids", (3, 4099, 200), (oh, of)) for oh, of in ((1, 1), (1, 0), (6, 2), (15, 3))]
    for case in cases:
        kind, (b, l, f_pad), offsets = case if len(case) == 3 else (*case, (0, 0))
        check_frame_votes(f"B1 frame_votes edge [{kind}] ({b}, {l}) f_pad {f_pad}",
                          *votes_inputs(rng, b, l, f_pad, "mixed" if "+" in kind else kind, dev, offsets), f_pad)
    log(f"   B1 frame_votes edges: {n} shapes (B 1, 3, 16 x L 1, 15, 16, 17, 4,099, 98,304 x f_pad 1, 7, 200, 2,048; "
        f"ids -1, f_pad, f_pad + 1, int32 min, max), all hits, no hits, one frame, rows off their 16-byte "
        f"boundaries ({len(cases)} more): equal to the plain version, same bits twice")
    hit, frame = votes_inputs(rng, 1, 98304, 200, "mixed", dev)
    ms = frame_votes_body_ms(hit, frame, 200)
    bound = frame_votes_nbytes(hit, 200) / HBM_BYTES_S * 1e3
    log(f"B1 frame_votes (1, 98304) f_pad 200 (one query): kernel body {ms:.4f} ms (CUDA events behind a device "
        f"spin), bound {bound:.5f} ms by bytes ({bound / ms:.3f} of the body) [{card}]")
    return {"B 1 L 98304": {"ms": ms, "bound_ms": bound, "bound_by": "bytes"}}


EXPAND_JOBS, EXPAND_CHANNELS = 2048 * 27, 5  # 2,048 descriptors x 27 probes; row base, three sides, descriptor


def expand_inputs(rng, b: int, l_max: int, dev):
    """(length, payload) of ``b`` queries for B2 at the paths' job count and
    channels. At the bench scan (98,304 slots) 0.7 of the jobs are empty
    and the others geometric with mean 1 / 0.3; at a larger ``l_max`` (the
    large map's deep buckets) half are empty and the mean fills ``l_max``,
    so that some queries overflow it. Payload of 20 bits, channel 0 of
    either sign."""
    nj, c = EXPAND_JOBS, EXPAND_CHANNELS
    empty, mean_len = (0.7, 1.0) if l_max <= 98304 else (0.5, l_max / nj)
    length = np.where(rng.uniform(size=(b, nj)) < empty, 0, rng.geometric((1 - empty) / mean_len, (b, nj)))
    payload = rng.integers(0, 1 << 20, (b, nj, c), dtype=np.int32)
    payload[..., 0] -= 1 << 19
    return torch.from_numpy(length.astype(np.int32)).to(dev), torch.from_numpy(payload).to(dev)


def check_expand_edges(dev, card: str) -> dict:
    """B2 against its plain version (``check_expand``) at the other shapes
    the paths give it and where a tile-wise expansion can go wrong: the
    5,000-keyframe chunk (8 x 55,296 jobs -> 1,802,240 slots) and one query
    (1 -> 98,304), both timed; an ``l_max`` that is no multiple of 4 or of
    a tile; a run of more empty jobs than a tile has slots; a job that
    spans many tiles; heads on tile boundaries; all jobs empty; a total
    far above ``l_max``; 1, 3 and 8 channels. Returns the timed shapes'
    {ms, bound_ms, bound_by}."""
    rng = np.random.default_rng(SEED + 2)
    nj, c = EXPAND_JOBS, EXPAND_CHANNELS
    shapes = {}
    for b, l_max in ((SCALE_CHUNK, 1802240), (1, 98304)):
        length, payload = expand_inputs(rng, b, l_max, dev)
        name = f"({b}, {nj} jobs, {c} ch) -> {l_max} slots"
        _, n_valid = check_expand(f"B2 expand_jobs {name}", length, payload, l_max)
        ms = expand_body_ms(dev, length, payload, l_max, 20)
        t_bytes = 4 * (b * nj * (1 + c) + n_valid * c) / HBM_BYTES_S * 1e3
        log(f"B2 expand_jobs {name}: equal on valid slots ({n_valid} of {b * l_max}; totals "
            f"{int(length.sum(-1).min())}-{int(length.sum(-1).max())}), same bits twice; kernel body {ms:.4f} ms "
            f"(CUDA events), bound {t_bytes:.5f} ms by bytes [{card}]")
        shapes[f"B {b} L {l_max}"] = {"ms": ms, "bound_ms": t_bytes, "bound_by": "bytes"}
        del length, payload

    def lengths(*runs):
        """One query's lengths from (count, length) runs."""
        return np.concatenate([np.full(n, v, np.int64) for n, v in runs])

    mixed = rng.choice([0, 0, 512, 1024, 2048], 64)
    cases = [
        ("l_max 10,007", np.where(rng.uniform(size=(3, 5000)) < 0.6, 0, rng.geometric(0.2, (3, 5000))), 10007, 5),
        ("l_max 3", np.full((2, 9), 1), 3, 5),
        ("5,000 empty jobs in a row", np.stack([lengths((50, 3), (5000, 0), (300, 7), (3000, 0), (50, 40)),
                                                lengths((5000, 0), (350, 9), (3000, 0), (50, 1))]), 8192, 5),
        ("a job of 10,000 slots", np.stack([lengths((10, 5), (1, 10000), (20, 0), (100, 6)),
                                            lengths((1, 10000), (130, 4))]), 12288, 5),
        ("heads on tile boundaries", np.stack([mixed, np.roll(mixed, 7), np.full(64, 512)]), 32768, 5),
        ("all jobs empty", np.zeros((2, 700)), 4096, 5),
        ("a total far above l_max", np.full((2, 3000), 50), 4096, 5),
        ("1 channel", rng.geometric(0.3, (2, 3000)), 8192, 1),
        ("3 channels", rng.geometric(0.3, (2, 3000)), 8190, 3),
        ("8 channels", rng.geometric(0.3, (2, 3000)), 8192, 8),
    ]
    for name, length, l_max, ch in cases:
        length = torch.from_numpy(np.asarray(length).astype(np.int32)).to(dev)
        payload = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, length.shape + (ch,), dtype=np.int32)).to(dev)
        _, n_valid = check_expand(f"B2 expand_jobs edge [{name}]", length, payload, l_max)
        log(f"   B2 expand_jobs edge [{name}] {tuple(length.shape)} jobs, {ch} ch -> {l_max} slots: equal on its "
            f"{n_valid} valid slots, same bits twice")
    return shapes


def votes_problem(rng, n: int, h: int, p: int, mask: str, dev):
    """The arguments of ``hypothesis_votes`` for ``n`` candidates: random
    rotations and translations, a quarter of each candidate's pairs planted
    near hypothesis 0, and the valid pairs a ``prefix`` of a length drawn
    uniformly in 0-p, a random half (``holes``), ``all`` or ``none``."""
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
    if mask == "prefix":
        pair_valid = np.arange(p)[None] < rng.integers(0, p + 1, (n, 1))
    elif mask == "holes":
        pair_valid = rng.uniform(size=(n, p)) < 0.5
    else:
        pair_valid = np.full((n, p), mask == "all")
    return [torch.from_numpy(a).to(dev) for a in (rot, t, vq, vdb, pair_valid)]


def votes_d2(args) -> torch.Tensor:
    """(N, H, P, 3) float64 squared distances of every hypothesis' moved
    query vertices to the DB vertices."""
    r64, t64, q64, d64 = (a.double() for a in args[:4])
    return ((torch.einsum("nhij,npaj->nhpai", r64, q64) + t64[:, :, None, None] - d64[:, None]) ** 2).sum(-1)


def votes_bytes(args) -> int:
    """Bytes B3 must move for these inputs: the rotations, translations and
    the mask read once, the 72 bytes of vertices of every valid pair, and
    the votes written once."""
    rot, t, _, _, valid = args
    return rot.numel() * 4 + t.numel() * 4 + valid.numel() + 72 * int(valid.sum()) + rot.shape[0] * rot.shape[1] * 4


def votes_work(args, thr: float, d2=None) -> dict:
    """What these inputs ask of B3. The kernel walks a candidate's pairs
    by warp tiles (``32 * verify.PAIRS_PER_THREAD`` consecutive pairs),
    skips a tile without a valid pair, and in a tile gives a lane as many
    pairs as cover it up to its last valid one: ``fill`` is the share of
    the lane slots so taken that hold a valid pair (``fill_whole_tiles``
    what it would be with whole tiles). ``tile_trips`` are the (candidate,
    tile, hypothesis) trips over tiles with a valid pair, ``second`` and
    ``third`` the share of them in which, by the float64 distances, some
    pair still lies within ``thr`` after one and two vertices: what a
    kernel that ended a hypothesis vertex by vertex could leave out."""
    from sgtd_tpu_torch.ops import verify

    valid = args[4]
    n, p = valid.shape
    tile = 32 * verify.PAIRS_PER_THREAD
    padded = torch.nn.functional.pad(valid, (0, -p % tile)).view(n, -1, tile)
    extent = (padded * torch.arange(1, tile + 1, device=valid.device)).amax(-1)  # (N, tiles)
    slots = int((32 * ((extent + 31) // 32)).sum())
    busy = int((extent > 0).sum())
    ok = ((votes_d2(args) if d2 is None else d2) < thr * thr) & valid[:, None, :, None]  # (N, H, P, 3)
    in1 = ok[..., 0]
    in2 = in1 & ok[..., 1]
    h = ok.shape[1]
    tiles = lambda x: torch.nn.functional.pad(x, (0, -p % tile)).unflatten(-1, (-1, tile)).any(-1)
    trips = busy * h
    return {
        "fill": int(valid.sum()) / max(slots, 1),
        "fill_whole_tiles": int(valid.sum()) / max(busy * tile, 1),
        "tile_trips": trips,
        "second": int(tiles(in1).sum()) / max(trips, 1),
        "third": int(tiles(in2).sum()) / max(trips, 1),
    }


def check_votes(name: str, args, thr: float):
    """B3 against its plain version on one set of inputs: votes may differ
    only by pairs whose float64 d^2 lies within 1e-3 of thr^2 (they may
    round either way), and a second launch gives the same bits. Returns
    (max |err|, borderline pairs, ``votes_work`` of the inputs)."""
    from sgtd_tpu_torch.ops import verify

    got = verify.hypothesis_votes(*args, thr)
    want = verify.hypothesis_votes_plain(*args, thr)
    d2 = votes_d2(args)
    near = ((d2 - thr * thr).abs() < 1e-3).any(-1) & args[4][:, None]
    work = votes_work(args, thr, d2)
    del d2
    n_near = int(near.sum())
    diff = (got - want).abs()
    err = diff.max().item() if diff.numel() else 0
    if got.shape != want.shape or got.dtype != torch.int32 or bool((diff > near.sum(-1)).any()):
        fail(f"{name} differs beyond its {n_near} borderline pairs (max |err| {err})")
    if not torch.equal(got, verify.hypothesis_votes(*args, thr)):
        fail(f"{name}: two launches on the same input differ in their bits")
    return err, n_near, work


def votes_body_ms(dev, args, thr: float, launches: int = 50) -> float:
    """B3's kernel body by CUDA events."""
    from sgtd_tpu_torch.ops import verify

    args = [a.contiguous() for a in args]
    n, h = args[0].shape[:2]
    out = torch.empty((n, h), dtype=torch.int32, device=dev)
    return body_ms("sgtd_hypothesis_votes", dev, *(a.data_ptr() for a in args), out.data_ptr(),
                   n, h, args[2].shape[1], verify._thr2(thr), launches=launches)


def warp_skip_share(pair_valid: torch.Tensor):
    """What B3's warp skip meets on a (N, P) mask: the share of (candidate,
    warp tile) pairs in which no pair is valid, a warp tile being the
    ``32 * verify.PAIRS_PER_THREAD`` consecutive pairs a warp takes at a
    time; then the median and the largest count of valid pairs a
    candidate."""
    from sgtd_tpu_torch.ops import verify

    tile = 32 * verify.PAIRS_PER_THREAD
    n, p = pair_valid.shape
    padded = torch.nn.functional.pad(pair_valid, (0, -p % tile))
    busy = padded.view(n, -1, tile).any(-1)
    per_cand = pair_valid.sum(-1)
    return 1.0 - float(busy.float().mean()), float(per_cand.float().median()), int(per_cand.max())


def log_votes_call(name: str, call, dev, card: str) -> None:
    """What one recorded call of ``hypothesis_votes`` on a path's real
    candidates asks of B3 (``warp_skip_share``, ``votes_work``), and the
    kernel body's time on those inputs."""
    from sgtd_tpu_torch.ops import verify

    args, thr = call.args[:5], call.args[5]
    pair_valid = args[4]
    skip, med, most = warp_skip_share(pair_valid)
    work = votes_work(args, thr)
    log(f"B3 on {name}'s candidates {tuple(pair_valid.shape)}, {args[0].shape[1]} hypotheses: {skip:.4f} of the "
        f"warps' tiles of {32 * verify.PAIRS_PER_THREAD} pairs hold no valid pair; valid pairs a candidate: median "
        f"{med:.0f}, most {most}, {int((pair_valid.sum(-1) == 0).sum())} candidates with none; {work['fill']:.4f} of "
        f"the lane slots taken hold a valid pair ({work['fill_whole_tiles']:.4f} with whole tiles); of the "
        f"{work['tile_trips']} (tile, hypothesis) trips {work['second']:.4f} have a pair within thr after the first "
        f"vertex and {work['third']:.4f} after the second; kernel body on these inputs "
        f"{votes_body_ms(dev, args, thr):.4f} ms (CUDA events) [{card}]")


def check_votes_edges(dev, card: str) -> dict:
    """B3 against its plain version (``check_votes``) at the other shapes
    the paths give it and where a count of several pairs a thread can go
    wrong: 400 candidates (a 5,000-keyframe chunk) and 50 (one query), both
    timed; a mask with holes; P no multiple of the pairs a block takes at a
    time, of the pairs a thread holds, and below them; one hypothesis and
    ``MAX_H``; every pair valid and every pair invalid. Returns the timed
    shapes' {ms, bound_ms, bound_by}."""
    from sgtd_tpu_torch.ops import verify

    rng = np.random.default_rng(SEED + 3)
    thr, shapes = 3.0, {}
    cases = [(f"{n} candidates", n, 50, 512, "prefix") for n in (400, 50)]
    cases += [("a mask with holes", 50, 50, 512, "holes"), ("P 700", 20, 50, 700, "prefix"),
              ("P 700 with holes", 20, 50, 700, "holes"), ("P 513", 21, 50, 513, "holes"),
              ("P 130", 21, 50, 130, "prefix"), ("P 3", 7, 50, 3, "all"), ("P 2", 7, 50, 2, "holes"),
              ("P 1", 7, 50, 1, "all"), ("H 1", 33, 1, 512, "prefix"),
              (f"H {verify.MAX_H}", 20, verify.MAX_H, 256, "holes"), ("every pair valid", 30, 50, 512, "all"),
              ("every pair invalid", 30, 50, 512, "none")]
    for name, n, h, p, mask in cases:
        args = votes_problem(rng, n, h, p, mask, dev)
        err, n_near, work = check_votes(f"B3 hypothesis_votes edge [{name}]", args, thr)
        if mask == "none" and bool(verify.hypothesis_votes(*args, thr).any()):
            fail("B3 hypothesis_votes edge [every pair invalid]: votes must be zero")
        line = (f"   B3 hypothesis_votes edge [{name}] ({n} cand, {h} hyp, {p} pairs, mask {mask}): max |err| {err} "
                f"({n_near} borderline pairs), same bits twice")
        if name.endswith("candidates"):
            ms = votes_body_ms(dev, args, thr)
            t_flops = int(args[4].sum()) * h * 3 * 27 / F32_FLOP_S * 1e3
            t_bytes = votes_bytes(args) / HBM_BYTES_S * 1e3
            by = "bytes" if t_bytes >= t_flops else "operations"
            shapes[f"N {n}"] = {"ms": ms, "bound_ms": max(t_bytes, t_flops), "bound_by": by}
            line += f"; kernel body {ms:.4f} ms (CUDA events), bound {max(t_bytes, t_flops):.5f} ms by {by} [{card}]"
        log(line)
        del args

    # The loop's pace: every pair valid, a threshold that every pair meets
    # under every hypothesis (the work does not depend on it; the votes are
    # then known), and as many candidates as give each SM the same number
    # of blocks, so that no SM waits for another. A candidate's warps split
    # its hypotheses over the SM's four schedulers: each makes (P / tile) x
    # ceil(H / 4) trips of the (tile, hypothesis) loop a candidate.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, h, p, wide_thr = 6 * sms, 50, 512, 1e4
    args = votes_problem(rng, n, h, p, "all", dev)
    if not bool((verify.hypothesis_votes(*args, wide_thr) == p).all()):
        fail("B3 hypothesis_votes [every pair an inlier]: every vote must be P")
    ms = votes_body_ms(dev, args, wide_thr, 20)
    clock = clocks_under_load(lambda: verify.hypothesis_votes(*args, wide_thr))
    trips = n // sms * (p // (32 * verify.PAIRS_PER_THREAD)) * -(-h // 4)
    cycles = ms * 1e-3 * float(clock.split()[0]) * 1e6 / trips
    log(f"   B3 hypothesis_votes [every pair an inlier of every hypothesis] ({n} cand, {h} hyp, {p} pairs, thr "
        f"{wide_thr:g}): kernel body {ms:.4f} ms; a scheduler makes {trips} trips of the (tile, hypothesis) loop, "
        f"{cycles:.0f} cycles a trip at the SM clock under the load ({clock}) [{card}]")
    shapes["every pair an inlier"] = {"ms": ms, "cycles_a_trip": cycles}
    return shapes


def check_kernels(dev, card: str):
    """Phase 2: each kernel against its plain version at the bench shapes."""
    from sgtd_tpu_torch.ops import expand, probe, verify

    rng = np.random.default_rng(SEED)
    records = []

    # B1 frame_votes: (16, 98,304) slots, 200 frames, sentinel ids included;
    # then one query's row, and the shapes where a cluster kernel with
    # 16-byte loads can go wrong.
    b, l, f_pad = CHUNK, 98304, 200
    hit = torch.from_numpy(rng.uniform(size=(b, l)) < 0.3).to(dev)
    frame = torch.from_numpy(rng.integers(-1, f_pad + 2, (b, l), dtype=np.int32)).to(dev)
    err = check_frame_votes(f"B1 frame_votes ({b}, {l}) f_pad {f_pad}", hit, frame, f_pad)
    wrapper_ms, plain_ms = median_times(
        lambda: probe.frame_votes(hit, frame, f_pad),
        lambda: probe.frame_votes_plain(hit, frame, f_pad),
    )
    ms = frame_votes_body_ms(hit, frame, f_pad)
    log(f"B1 frame_votes ({b}, {l}) f_pad {f_pad}: equal, same bits twice; kernel body {ms:.4f} ms (CUDA events "
        f"behind a device spin), wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms (medians of synchronized "
        f"calls) [{card}]")
    log(f"   what these inputs ask: {frame_votes_work(hit, frame, f_pad)}")
    records.append(kernel_record(
        "frame_votes", "probe.cu", "sgtd_tpu/ops/pallas_probe.py:67", err, ms, plain_ms,
        nbytes=frame_votes_nbytes(hit, f_pad), flops=b * l, library_ms=scatter_add_ms(hit, frame, f_pad),
        wrapper_ms=wrapper_ms))
    log_bound(records[-1])
    records[-1]["shapes"] = check_frame_votes_edges(dev, card)
    del hit, frame

    # B2 expand_jobs: 16 x 55,296 jobs (2048 descriptors x 27 probes), 5
    # channels (one of any sign), 98,304 slots; skewed lengths, many empty.
    nj, c, l_max = 2048 * 27, 5, 98304
    length = np.where(rng.uniform(size=(b, nj)) < 0.7, 0, rng.geometric(0.3, (b, nj)))
    length[0, 100] = l_max  # one query overflows the cap
    length = torch.from_numpy(length.astype(np.int32)).to(dev)
    payload = rng.integers(0, 1 << 20, (b, nj, c), dtype=np.int32)
    payload[..., 0] -= 1 << 19
    payload = torch.from_numpy(payload).to(dev)
    shape = f"({b}, {nj} jobs, {c} ch) -> {l_max} slots"
    err, n_valid = check_expand(f"B2 expand_jobs {shape}", length, payload, l_max)
    wrapper_ms, plain_ms = median_times(
        lambda: expand.expand_jobs(length, payload, l_max),
        lambda: expand.expand_jobs_plain(length, payload, l_max),
    )
    ms = expand_body_ms(dev, length, payload, l_max)
    log(f"B2 expand_jobs {shape}: equal on valid slots, same bits twice; kernel body {ms:.4f} ms (CUDA events, "
        f"offsets made beforehand), wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms (medians of synchronized "
        f"calls) [{card}]")
    # Bytes: lengths and payload read once, the valid slots written once.
    records.append(kernel_record(
        "expand_jobs", "expand.cu", "sgtd_tpu/ops/pallas_expand.py:73", err, ms, plain_ms,
        nbytes=4 * (b * nj * (1 + c) + n_valid * c), flops=n_valid * c, wrapper_ms=wrapper_ms))
    log_bound(records[-1])
    del length, payload
    records[-1]["shapes"] = check_expand_edges(dev, card)

    # B3 hypothesis_votes: 16 x 50 candidates, 50 hypotheses, 512 pairs;
    # a quarter of each candidate's pairs planted near hypothesis 0; the
    # valid pairs a prefix of a length drawn uniformly in 0-512.
    n, h, p, thr = CHUNK * 50, 50, 512, 3.0
    args = votes_problem(rng, n, h, p, "prefix", dev)
    shape = f"({n} cand, {h} hyp, {p} pairs)"
    err, n_near, work = check_votes(f"B3 hypothesis_votes {shape}", args, thr)
    wrapper_ms, plain_ms = median_times(
        lambda: verify.hypothesis_votes(*args, thr),
        lambda: verify.hypothesis_votes_plain(*args, thr),
    )
    ms = votes_body_ms(dev, args, thr)
    skip, _, _ = warp_skip_share(args[4])
    log(f"B3 hypothesis_votes {shape}: max |err| {err} ({n_near} borderline pairs), same bits twice; kernel body "
        f"{ms:.4f} ms (CUDA events), wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms (medians of synchronized "
        f"calls) [{card}]")
    log(f"   what these inputs ask: {skip:.4f} of the warps' tiles hold no valid pair; {work['fill']:.4f} of the lane "
        f"slots taken in the others hold a valid pair ({work['fill_whole_tiles']:.4f} with whole tiles); of the "
        f"{work['tile_trips']} (tile, hypothesis) trips {work['second']:.4f} have a pair within thr after the first "
        f"vertex and {work['third']:.4f} after the second")
    # Operations: per (hypothesis, valid pair) three vertices, each a
    # rotation (15), a translation (3), a difference (3), d^2 (5), a test.
    # The table's float32 peak counts an FMA as two operations, and these
    # sums may not contract into FMAs (they must round as the plain version
    # does): the kernel's own floor, an instruction an operation, is twice
    # the bound.
    flops = int(args[4].sum()) * h * 3 * 27
    records.append(kernel_record(
        "hypothesis_votes", "verify.cu", "sgtd_tpu/ops/pallas_verify.py:83", err, ms, plain_ms,
        nbytes=votes_bytes(args), flops=flops, wrapper_ms=wrapper_ms))
    log_bound(records[-1])
    log(f"   hypothesis_votes: {2 * flops / F32_FLOP_S * 1e3:.5f} ms is the floor of sums that may not contract "
        f"into FMAs (half the table's rate)")
    del args
    records[-1]["shapes"] = check_votes_edges(dev, card)

    # B4 nn1 at the rerank's shapes, 1,024 source x 4,096 target points: 64
    # problems (a chunk of 16 queries x 4 candidates: the record's shape),
    # 160 (the hard world's 10 candidates) and 4 (one query); then 70,000
    # problems of 8 x 16 points in one launch. A fifth of each side is
    # displaced to 1e6 as masked points are, with planted exact duplicates
    # (distance ties). Each shape twice for the same bits.
    from sgtd_tpu_torch.ops import nn

    n_src, n_tgt = SRC_PTS, CLOUD_PTS
    shapes = {}
    for p, n, t in ((CHUNK * RERANK_K, n_src, n_tgt), (CHUNK * HARD_RERANK_K, n_src, n_tgt),
                    (RERANK_K, n_src, n_tgt), (70000, 8, 16)):
        src, tgt = nn1_clouds(rng, p, n, t, dev)
        got_i, got_d = nn.nn1(src, tgt)
        want_i, want_d = nn.nn1_plain(src, tgt)
        n_rows, err = check_nn_rows(f"B4 nn1 P {p}", src, tgt, got_i, want_i)
        same = got_i == want_i
        if not bool((got_d[same] == want_d[same]).all()):
            fail(f"B4 nn1 P {p}: equal picks with unequal distances")
        again_i, again_d = nn.nn1(src, tgt)
        if not (torch.equal(got_i, again_i) and torch.equal(got_d.view(torch.int32), again_d.view(torch.int32))):
            fail(f"B4 nn1 P {p}: two launches on the same input differ in their bits")
        err = max(err, (got_d - want_d).abs().max().item())
        ms = event_ms(lambda: nn.nn1(src, tgt), 50 if p < 1000 else 10)
        plain_ms = event_ms(lambda: nn.nn1_plain(src, tgt), 1, 3, spin=False)
        plan = nn.scan_plan(p, n)
        log(f"B4 nn1 ({p}, {n}) x ({p}, {t}): {n_rows} rows differ (1-ulp rule), max |err| {err}, same bits "
            f"twice; kernel {ms:.4f} ms ({plan[0]} queries a thread, {plan[2]} blocks of {plan[1]} warps), "
            f"plain {plain_ms:.4f} ms (CUDA events) [{card}]")
        # Operations: 8 per distance (3 FMAs and the combine) and a compare.
        shapes[p] = kernel_record(
            "nn1", "nn.cu", "sgtd_tpu/ops/pallas_nn.py:81", err, ms, plain_ms,
            nbytes=4 * (3 * p * (n + t) + 2 * p * n), flops=8 * p * n * t)
        log_bound(shapes[p])
        if p == CHUNK * RERANK_K:
            log(f"   SM clock, its maximum and the power draw under back-to-back B4 launches: "
                f"{clocks_under_load(lambda: nn.nn1(src, tgt))}")
            lane, warp = rescan_share(src, tgt)
            log(f"   deferred argmin on these random clouds: a query's running minimum falls in {lane:.4f} of "
                f"its groups of 16 references; some lane of a warp's 32 queries sees it in {warp:.4f} of them")
    # The record carries the chunk's shape; the others ride under "shapes".
    rec = shapes.pop(CHUNK * RERANK_K)
    rec["max_abs_err"] = max([rec["max_abs_err"]] + [r["max_abs_err"] for r in shapes.values()])
    rec["shapes"] = {f"P {p}": {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
                     for p, r in shapes.items()}
    records.append(rec)
    del src, tgt

    # B5 knn, k 20, self: the map covariances (200 keyframes x 4,096) and
    # the query covariances of one chunk (16 x 1,024), with masked points.
    k, recs = 20, []
    for shape in ((CHUNK, SRC_PTS), (NUM_MAP, CLOUD_PTS)):
        pts = rng.uniform(-50, 50, shape + (3,)).astype(np.float32)
        pts[:, 1000:1010] = pts[:, :10]
        pts[rng.uniform(size=shape) < 0.2] = 1e6
        pts = torch.from_numpy(pts).to(dev)
        got = nn.knn(pts, pts, k)
        want = nn.knn_plain(pts, pts, k)
        n_rows, err = check_nn_rows(f"B5 knn {shape}", pts, pts, got, want)
        if not torch.equal(got, nn.knn(pts, pts, k)):
            fail(f"B5 knn {shape}: two launches on the same input differ in their bits")
        ms = event_ms(lambda: nn.knn(pts, pts, k), 10 if shape[0] == NUM_MAP else 50)
        plain_ms = event_ms(lambda: nn.knn_plain(pts, pts, k), 1, 3, spin=False)
        log(f"B5 knn {shape} self, k {k}: {n_rows} rows differ (1-ulp rule), max |err| {err}, same bits "
            f"twice; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events) [{card}]")
        # Operations: 8 per distance, as B4; the selection is not counted.
        p, n = shape
        recs.append(kernel_record(
            "knn", "nn.cu", "sgtd_tpu/ops/pallas_nn.py:133", err, ms, plain_ms,
            nbytes=4 * p * n * (3 + 3 + k), flops=8 * p * n * n))
        log_bound(recs[-1])
    edge_err = check_knn_edges(dev, rng)
    # The record carries the per-chunk shape (16 x 1,024) and, under "map",
    # the map build's (200 x 4,096) with its own bound.
    recs[0]["max_abs_err"] = max(recs[0]["max_abs_err"], recs[1]["max_abs_err"], edge_err)
    recs[0]["map"] = {key: recs[1][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
    records.append(recs[0])

    # B6 frame_votes_wide: the 5,000-keyframe scan (8 x 1,802,240 slots)
    # at f_pad 5,000 and 20,000, and the global-memory branch at 65,544.
    # Half the slots vote for 50 frames (real scans pile up on a few);
    # ids -1, f_pad (the sentinel) and f_pad + 1 count nothing.
    errs, times = [], []
    for f_pad, l in ((5000, 1802240), (20000, 1802240), (WIDE_F_PAD, 262144)):
        b = SCALE_CHUNK
        hit = torch.from_numpy(rng.uniform(size=(b, l)) < 0.3).to(dev)
        frame = rng.integers(-1, f_pad + 2, (b, l), dtype=np.int32)
        hot = rng.uniform(size=(b, l)) < 0.5
        frame[hot] = rng.integers(0, 50, int(hot.sum()), dtype=np.int32)
        frame = torch.from_numpy(frame).to(dev)
        got = probe.frame_votes_wide(hit, frame, f_pad)
        want = probe.frame_votes_wide_plain(hit, frame, f_pad)
        err = (got - want).abs().max().item()
        if err != 0:
            fail(f"B6 frame_votes_wide ({b}, {l}) f_pad {f_pad} differs from its plain version "
                 f"(max |err| {err})")
        wrapper_ms, plain_ms = median_times(
            lambda: probe.frame_votes_wide(hit, frame, f_pad),
            lambda: probe.frame_votes_wide_plain(hit, frame, f_pad),
        )
        counts = frame.new_zeros((b, f_pad))
        ms = body_ms("sgtd_frame_votes_wide", dev, hit.data_ptr(), frame.data_ptr(), counts.data_ptr(), b, l, f_pad)
        log(f"B6 frame_votes_wide ({b}, {l}) f_pad {f_pad}: equal; kernel body {ms:.4f} ms (CUDA events), wrapper "
            f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms (medians of synchronized calls) [{card}]")
        errs.append(err)
        times.append((ms, plain_ms, scatter_add_ms(hit, frame, f_pad), wrapper_ms))
    # The record carries the 5,000-keyframe shape, the one phase 5 runs.
    b, l, f_pad = SCALE_CHUNK, 1802240, 5000
    records.append(kernel_record(
        "frame_votes_wide", "probe.cu", "sgtd_tpu/ops/pallas_probe.py:145", max(errs), *times[0][:2],
        nbytes=b * l * 5 + b * f_pad * 4, flops=b * l, library_ms=times[0][2], wrapper_ms=times[0][3]))
    log_bound(records[-1])
    del hit, frame, counts
    records.extend(check_fused_kernels(dev, card, rng))
    return records


def gicp_problems(rng, p: int, n_src: int, n_tgt: int, dev):
    """``p`` registration problems shaped like the rerank's: a mostly
    planar target cloud with vertical structure, the source a noisy
    subsample of it under a small offset, random SPD covariances, a tenth
    of each side masked, and small random initial transforms. Returns the
    arguments of ``ops.gicp.linearize_gicp`` without the gate."""
    from sgtd_tpu_torch.geom import se3
    from sgtd_tpu_torch.ops import gicp

    tgt = np.stack([rng.uniform(-50, 50, (p, n_tgt)), rng.uniform(-50, 50, (p, n_tgt)),
                    rng.normal(0, 0.05, (p, n_tgt))], axis=-1).astype(np.float32)
    k = n_tgt // 4
    tgt[:, :k, 2] = rng.uniform(0, 5, (p, k))
    tgt[:, :k, 0] = np.round(tgt[:, :k, 0] / 5) * 5 + rng.normal(0, 0.03, (p, k))
    pick = np.stack([rng.permutation(n_tgt)[:n_src] for _ in range(p)])
    src = np.take_along_axis(tgt, pick[..., None], 1) + rng.normal(0, 0.05, (p, n_src, 3))
    src = (src - rng.normal(0, 0.3, (p, 1, 3))).astype(np.float32)

    def spd(n):
        a = rng.normal(0, 1, (p, n, 3, 3)).astype(np.float32)
        return a @ a.transpose(0, 1, 3, 2) + 0.1 * np.eye(3, dtype=np.float32)

    to = lambda a: torch.from_numpy(a).to(dev)
    src_mask, tgt_mask = to(rng.uniform(size=(p, n_src)) > 0.1), to(rng.uniform(size=(p, n_tgt)) > 0.1)
    src, tgt, src_cov, tgt_cov = to(src), to(tgt), to(spd(n_src)), to(spd(n_tgt))
    xi = to(np.concatenate([rng.normal(0, 0.2, (p, 3)), rng.normal(0, 0.02, (p, 3))], 1).astype(np.float32))
    tgt_eff = torch.where(tgt_mask[..., None], tgt, torch.full_like(tgt, 1e6))
    return (se3.se3_exp(xi), src, gicp.cov6(src_cov), src_mask, tgt_eff,
            gicp.build_gicp_payload(tgt, tgt_mask, tgt_cov))


def check_linearize(name: str, args, gate: float):
    """B7 against its plain version on one set of inputs; returns the
    largest absolute error over the sums and the per-point M."""
    from sgtd_tpu_torch.ops import gicp, nn

    sums, aux = gicp.linearize_sums(*args, gate)
    again = gicp.linearize_sums(*args, gate)
    torch.cuda.synchronize()
    if not (torch.equal(sums, again[0]) and torch.equal(aux, again[1])):
        fail(f"{name}: two launches on the same inputs differ in their bits")
    want_sums, want_aux = gicp.linearize_sums_plain(*args, gate)
    if not bool(torch.isfinite(sums).all() and torch.isfinite(aux).all()):
        fail(f"{name}: non-finite output")
    # b and w equal, except on rows where the two picks' distances lie
    # within one ulp (the rule of B4).
    rows = (aux[..., :3] != want_aux[..., :3]).any(-1) | (aux[..., 12] != want_aux[..., 12])
    n_rows = int(rows.sum())
    if n_rows > 1e-3 * rows.numel():
        fail(f"{name}: b or w differ from the plain version on {n_rows} of {rows.numel()} points")
    if n_rows:
        moved = gicp._moved_fma(args[0], args[1])[rows][:, None]
        d_got = nn.sq_dists_plain(moved, aux[rows][:, None, :3])
        d_want = nn.sq_dists_plain(moved, want_aux[rows][:, None, :3])
        if not bool(ulp_close(d_got, d_want).all()):
            fail(f"{name}: {n_rows} points differ from the plain version beyond the 1-ulp tie rule")
    same = ~rows
    m_got, m_want = aux[..., 3:12][same], want_aux[..., 3:12][same]
    m_err = ((m_got - m_want).abs().amax(-1) / m_want.abs().amax(-1)).max().item()
    if m_err > 1e-5:
        fail(f"{name}: M differs from the plain version by {m_err} of its largest entry")
    clean = ~rows.any(-1)  # problems whose correspondences all agree
    got, want = sums[clean].double(), want_sums[clean].double()
    close = lambda a, b, rtol, atol: bool(((a - b).abs() <= atol + rtol * b.abs()).all())
    if not close(got[:, :42], want[:, :42], 2e-4, 2e-2):
        fail(f"{name}: H or g differ from the plain version (max |err| "
             f"{(got[:, :42] - want[:, :42]).abs().max().item()})")
    y0, nv, sq = 42, gicp.N_VALID, gicp.SUM_SQD
    if not close(got[:, y0], want[:, y0], 1e-4, 0) or not close(got[:, sq], want[:, sq], 1e-4, 0):
        fail(f"{name}: y0 or the sum of squared distances differ from the plain version")
    if not torch.equal(got[:, nv], want[:, nv]) or bool((got[:, sq + 1:] != 0).any()):
        fail(f"{name}: n_valid differs from the plain version")
    if not torch.equal(sums[:, :36].view(-1, 6, 6), sums[:, :36].view(-1, 6, 6).transpose(1, 2)):
        fail(f"{name}: H is not symmetric")
    err = max((got - want).abs().max().item(), (m_got - m_want).abs().max().item())
    log(f"{name}: b and w equal ({n_rows} points under the 1-ulp rule), M within {m_err:.2e} of its "
        f"largest entry, H/g/y0/sum sqd within tolerance (max |err| {err:.3e}, "
        f"{int(want[:, nv].sum())} valid points), same bits twice")
    return err


def check_fused_kernels(dev, card: str, rng):
    """Phase 2, continued: B7 and B8 against their plain versions."""
    from sgtd_tpu_torch.ops import gicp, nn, probe

    records = []
    p, n_src, n_tgt = CHUNK * RERANK_K, SRC_PTS, CLOUD_PTS
    args = gicp_problems(rng, p, n_src, n_tgt, dev)
    shape = f"({p}, {n_src}) x ({p}, {n_tgt})"
    err = max(check_linearize(f"B7 linearize_gicp {shape} no gate", args, float("inf")),
              check_linearize(f"B7 linearize_gicp {shape} gate {HARD_GATE_M} m", args, HARD_GATE_M))
    moved = gicp._moved_fma(args[0], args[1])
    ms = event_ms(lambda: gicp.linearize_sums(*args, float("inf")), 50)
    nn1_ms = event_ms(lambda: nn.nn1(moved, args[4]), 50)
    plain_ms = event_ms(lambda: gicp.linearize_sums_plain(*args, float("inf")), 1, 3, spin=False)
    log(f"B7 linearize_gicp {shape}: kernel {ms:.4f} ms, B4 nn1 on the same points {nn1_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (CUDA events) [{card}]")
    # Operations: 8 per distance plus about 300 per source point; bytes:
    # every input once, the sums and aux once.
    nbytes = sum(a.numel() * a.element_size() for a in args) + 4 * p * (gicp.ROW + n_src * gicp.AUX)
    records.append(kernel_record(
        "linearize_gicp", "gicp.cu", "sgtd_tpu/ops/pallas_gicp.py:231", err, ms, plain_ms,
        nbytes=nbytes, flops=p * n_src * (8 * n_tgt + 300)))
    log_bound(records[-1])
    del args, moved
    # The hard world's rerank of 10 candidates: 160 problems a chunk; one
    # query's 4; and 70,000 problems of 2 x 16 points in one launch.
    for p, n, t in ((CHUNK * HARD_RERANK_K, n_src, n_tgt), (RERANK_K, n_src, n_tgt), (70000, 2, 16)):
        args = gicp_problems(rng, p, n, t, dev)
        shape = f"({p}, {n}) x ({p}, {t})"
        err = max(err, check_linearize(f"B7 linearize_gicp {shape} gate {HARD_GATE_M} m", args, HARD_GATE_M))
        if p == CHUNK * HARD_RERANK_K:
            err = max(err, check_linearize(f"B7 linearize_gicp {shape} no gate", args, float("inf")))
        moved = gicp._moved_fma(args[0], args[1])
        reps = 20 if p < 1000 else 5
        ms = event_ms(lambda: gicp.linearize_sums(*args, HARD_GATE_M), reps)
        nn1_ms = event_ms(lambda: nn.nn1(moved, args[4]), reps)
        log(f"B7 linearize_gicp at {p} problems: kernel {ms:.4f} ms, B4 nn1 on the same points {nn1_ms:.4f} ms "
            f"(CUDA events) [{card}]")
        records[-1].setdefault("shapes", {})[f"P {p}"] = {"ms": ms, "nn1_ms": nn1_ms}
        del args, moved
    records[-1]["max_abs_err"] = err

    # B8 gather_rows: the bench DB's packed2 (399,104 rows of 2 words) at
    # one chunk's selected rows, and the 5,000-keyframe DB's at its scan;
    # kernel and index_select timed in turns.
    rec = None
    for m, l in ((399104, 106496), (9775363, SCALE_CHUNK * 1802240)):
        table = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (m, 2), dtype=np.int64).astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, m, l, dtype=np.int32)).to(dev)
        if int(idx.min()) < 0 or int(idx.max()) >= m:
            fail("B8 gather_rows: test indices out of range")
        got, want = probe.gather_rows(table, idx), probe.gather_rows_plain(table, idx)
        if not torch.equal(got, want):
            fail(f"B8 gather_rows ({m}, 2) x {l} differs from its plain version")
        del got, want
        reps = 50 if l < (1 << 20) else 10
        ms, lib_ms = turns_ms(lambda: probe.gather_rows(table, idx),
                              lambda: torch.index_select(table, 0, idx), reps)
        plain_ms = event_ms(lambda: probe.gather_rows_plain(table, idx), reps, spin=False)
        log(f"B8 gather_rows ({m}, 2) x {l}: equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"index_select {lib_ms:.4f} ms (CUDA events, kernel and index_select in turns) [{card}]")
        # Bytes: the indices and the rows they name read once, the rows written once.
        this = kernel_record("gather_rows", "probe.cu", "sgtd_tpu/ops/pallas_probe.py:178", 0.0, ms,
                             plain_ms, nbytes=l * (4 + 8 + 8), flops=0, library_ms=lib_ms)
        log_bound(this)
        if rec is None:
            rec = this  # the record carries the bench shape
        else:
            rec["scan"] = {key: this[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        # The ragged tail of the rows-a-thread design, an index vector off
        # a 16-byte boundary, and a table of another width.
        for name, t, i in (("L 1", table, idx[:1]), ("L 3", table, idx[:3]), ("L 4,099", table, idx[:4099]),
                           ("unaligned idx", table, idx[1:4100]),
                           ("W 3", torch.cat([table[:1000], table[:1000, :1]], 1), idx[:4099] % 1000)):
            if not torch.equal(probe.gather_rows(t, i), probe.gather_rows_plain(t, i)):
                fail(f"B8 gather_rows edge [{name}] on the ({m}, 2) table differs from its plain version")
        del table, idx
    log("   B8 gather_rows edges (L 1, 3 and 4,099, idx off a 16-byte boundary, W 3): equal on both tables")
    records.append(rec)
    return records


def turns_ms(fn_a, fn_b, launches: int):
    """CUDA-event ms a call of each, taken in turns (b, a, a, b): the median
    of each one's two ``event_ms`` readings of three rounds."""
    t_b, t_a = turns_ms_of([fn_b, fn_a], launches)
    return t_a, t_b


def turns_ms_of(fns, launches: int) -> list:
    """CUDA-event ms a call of each of ``fns``, taken in turns: through the
    list and back again (a, b, c, c, b, a), an ``event_ms`` reading of three
    rounds each time; the median of each one's two readings."""
    acc = [[] for _ in fns]
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        acc[i].append(event_ms(fns[i], launches, 3))
    return [statistics.median(t) for t in acc]


def votes_turns(libs: list, what: str, hit, frame, f_pad: int, card: str) -> None:
    """B1's kernel bodies of every library of ``libs`` ((name, ctypes
    library) each), in turns on these inputs. Every library's counts must
    equal the plain version's."""
    from sgtd_tpu_torch.ops import probe

    b, l = hit.shape
    want = probe.frame_votes_plain(hit, frame, f_pad)
    stream = torch.cuda.current_stream(hit.device).cuda_stream
    bodies = []
    for name, lib in libs:
        out = torch.empty((b, f_pad), dtype=torch.float32, device=hit.device)
        body = lambda lib=lib, out=out: lib.sgtd_frame_votes(hit.data_ptr(), frame.data_ptr(), out.data_ptr(), b, l,
                                                             f_pad, stream)
        body()
        if not torch.equal(out, want):
            fail(f"baseline compare: B1 frame_votes {what}: {name} differs from the plain version")
        bodies.append(body)
    names = [n for n, _ in libs]
    fmt = lambda ms: ", ".join(f"{n} {t:.4f} ms" for n, t in zip(names, ms))
    log(f"   B1 frame_votes {what}, kernel bodies in turns, equal counts: {fmt(turns_ms_of(bodies, 50))} "
        f"(CUDA events) [{card}]")


def baseline_run(tree: str) -> dict:
    """``host_costs`` of the port's tree unpacked at ``tree`` (this one's
    when it is the script's own directory), measured in a process of its
    own: {"host_us": ..., "lib": path of that tree's built library}."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--host-cost-of", tree],
                         capture_output=True, text=True)
    if out.returncode != 0:
        fail(f"host costs of {tree}: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def library_of(tree: str) -> str:
    """The path of the kernel library of the port's tree at ``tree``, built
    there by its own ``ops/_build.py`` in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from sgtd_tpu_torch.ops import _build; print(_build.build())")
    out = subprocess.run([sys.executable, "-c", code, os.path.abspath(tree)], capture_output=True, text=True)
    if out.returncode != 0:
        fail(f"build of {tree}: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return out.stdout.strip().splitlines()[-1]


def wrapper_turns(dev, card: str, tree: str):
    """Host cost of B1's, B2's, B3's and B6's wrappers, ``tree``'s and this
    tree's, read in this one process in turns (old, new, new, old; the
    least of each one's two ``host_us`` readings); then B1's and B6's
    wrappers at the bench shapes as host-clocked medians of synchronized
    calls, in turns. ``tree``'s ``ops`` modules are loaded under other
    module names and launch through ``tree``'s own ``ops/_build.py`` and
    library; its ``ops/probe.py`` is returned."""
    from sgtd_tpu_torch.ops import expand, probe, verify

    def load(name):
        path = os.path.join(tree, "sgtd_tpu_torch", "ops", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"_baseline_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    old_build = load("_build")
    old_expand, old_verify, old_probe = load("expand"), load("verify"), load("probe")
    for mod in (old_expand, old_verify, old_probe):
        mod._build = old_build
    length = torch.ones((1, 4), dtype=torch.int32, device=dev)
    payload = torch.zeros((1, 4, 2), dtype=torch.int32, device=dev)
    offsets = expand.job_offsets(length)
    rot = torch.eye(3, device=dev).expand(1, 2, 3, 3).contiguous()
    t_h, verts = torch.zeros((1, 2, 3), device=dev), torch.zeros((1, 4, 3, 3), device=dev)
    ones4 = torch.ones((1, 4), dtype=torch.bool, device=dev)
    hit, frame = torch.ones((1, 64), dtype=torch.bool, device=dev), torch.zeros((1, 64), dtype=torch.int32, device=dev)
    calls = {
        f"frame_votes, {tree}": lambda: old_probe.frame_votes(hit, frame, 8),
        "frame_votes, this tree": lambda: probe.frame_votes(hit, frame, 8),
        f"frame_votes_wide, {tree}": lambda: old_probe.frame_votes_wide(hit, frame, 8),
        "frame_votes_wide, this tree": lambda: probe.frame_votes_wide(hit, frame, 8),
        f"expand_jobs, {tree}": lambda: old_expand.expand_jobs(length, payload, 16),
        "expand_jobs, this tree": lambda: expand.expand_jobs(length, payload, 16),
        "expand_jobs, this tree, offsets passed": lambda: expand.expand_jobs(length, payload, 16, offsets=offsets),
        "job_offsets": lambda: expand.job_offsets(length),
        f"hypothesis_votes, {tree}": lambda: old_verify.hypothesis_votes(rot, t_h, verts, verts, ones4, 3.0),
        "hypothesis_votes, this tree": lambda: verify.hypothesis_votes(rot, t_h, verts, verts, ones4, 3.0),
    }
    names = list(calls)
    readings = {name: [] for name in names}
    for name in names + names[::-1]:
        readings[name].append(host_us(calls[name]))
    log("   host cost in one process, in turns, us a call (least of each one's two readings): "
        + ", ".join(f"{name} {min(r):.2f} {[round(x, 2) for x in r]}" for name, r in readings.items())
        + f" [{card}]")

    rng = np.random.default_rng(SEED + 7)
    shapes = [("frame_votes", CHUNK, 98304, 200), ("frame_votes_wide", SCALE_CHUNK, 1802240, 5000),
              ("frame_votes_wide", SCALE_CHUNK, 1802240, 20000)]
    for fn_name, b, l, f_pad in shapes:
        hit, frame = votes_inputs(rng, b, l, f_pad, "mixed", dev)
        old_fn, new_fn = getattr(old_probe, fn_name), getattr(probe, fn_name)
        if not torch.equal(old_fn(hit, frame, f_pad), new_fn(hit, frame, f_pad)):
            fail(f"wrapper turns: {fn_name} ({b}, {l}) f_pad {f_pad}: {tree} and this tree differ")
        t_new, t_old = median_times(lambda: new_fn(hit, frame, f_pad), lambda: old_fn(hit, frame, f_pad))
        log(f"   {fn_name} ({b}, {l}) f_pad {f_pad}, wrapper in turns (median of synchronized calls): {tree} "
            f"{t_old:.4f} ms, this tree {t_new:.4f} ms [{card}]")
    return old_probe


def compare_baselines(dev, card: str, trees: list, with_host_costs: bool):
    """With ``--baseline TREE`` (another tree of the port, e.g. the parent
    commit unpacked by ``git archive`` under ``build/``; the flag may be
    given several times): the wrappers' host costs of the first such tree
    and of this one, each in its own process, in turns (baseline, this,
    this, baseline), and in this process (``wrapper_turns``); then the
    kernel bodies of B1, B6, B2, B3, B4, B7, B5 and B8 of every built
    library, called straight through ctypes on the same inputs, in turns
    through the trees and back, with equal outputs required (B2: on valid
    slots; B7: the per-point b and w and n_valid equal, the largest gap of
    the other outputs printed). Returns the first tree's ``ops/probe.py``
    and every library's (name, ctypes library), this tree's last, through
    which phase 4 times B1 on its real inputs in turns."""
    import ctypes

    from sgtd_tpu_torch.ops import _build, expand, gicp, verify

    here = str(_build.CSRC.parents[1])
    paths = [library_of(t) for t in trees]
    for tree, path in zip(trees, paths):
        usage = [u.split("_cu_", 1)[-1] for u in ptxas_usage(open(os.path.splitext(path)[0] + ".log").read())
                 if any(k in u for k in ("nn1", "linearize", "expand", "hypothesis"))]
        log(f"   ptxas, {tree}: " + " | ".join(usage))
    if with_host_costs:
        runs = [baseline_run(t) for t in (trees[0], here, here, trees[0])]
        for name in runs[0]["host_us"]:
            old, new = (min(runs[i]["host_us"][name], runs[j]["host_us"][name]) for i, j in ((0, 3), (1, 2)))
            log(f"   host cost in turns, {name}: {trees[0]} {old:.2f} us, this tree {new:.2f} us a call "
                f"(readings {[round(r['host_us'][name], 2) for r in runs]})")

    def bind(path):
        lib = ctypes.CDLL(path)
        for name in ("sgtd_nn1", "sgtd_linearize_gicp", "sgtd_knn", "sgtd_gather_rows", "sgtd_expand_jobs",
                     "sgtd_hypothesis_votes", "sgtd_frame_votes", "sgtd_frame_votes_wide"):
            getattr(lib, name).argtypes = _build.SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        return lib

    # Every baseline, then this tree last.
    names = list(trees) + ["this tree"]
    libs = [bind(path) for path in paths] + [bind(str(_build.build()))]
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(SEED + 1)
    fmt = lambda ms: ", ".join(f"{name} {t:.4f} ms" for name, t in zip(names, ms))

    old_probe = wrapper_turns(dev, card, trees[0])
    rng_b23 = np.random.default_rng(SEED + 4)  # B2's and B3's own, so that the others' inputs stay what they were

    # B1 at the bench shape and one query's (phase 4 adds its real
    # inputs); B6 at the 5,000-keyframe
    # chunk's shape for f_pad 5,000 and 20,000, equal counts required.
    votes_libs = list(zip(names, libs))
    rng_b16 = np.random.default_rng(SEED + 6)
    for b in (CHUNK, 1):
        votes_turns(votes_libs, f"({b}, 98304) f_pad 200, phase 2's draw",
                    *votes_inputs(rng_b16, b, 98304, 200, "mixed", dev), 200, card)
    for f_pad in (5000, 20000):
        b, l = SCALE_CHUNK, 1802240
        hit, frame = votes_inputs(rng_b16, b, l, f_pad, "mixed", dev)
        want = torch.zeros((b, f_pad), dtype=torch.int32, device=dev)
        want.scatter_add_(-1, torch.where(hit & (frame >= 0) & (frame < f_pad), frame, 0).long(),
                          (hit & (frame >= 0) & (frame < f_pad)).int())
        outs = [torch.zeros((b, f_pad), dtype=torch.int32, device=dev) for _ in libs]
        run = lambda lib, o: lib.sgtd_frame_votes_wide(hit.data_ptr(), frame.data_ptr(), o.data_ptr(), b, l, f_pad,
                                                       stream())
        if any(run(lib, o) for lib, o in zip(libs, outs)) or not all(torch.equal(o, want) for o in outs):
            fail(f"baseline compare: B6 frame_votes_wide f_pad {f_pad} differs between the libraries")
        ms = turns_ms_of([lambda lib=lib, o=o: run(lib, o) for lib, o in zip(libs, outs)], 20)
        log(f"   B6 frame_votes_wide ({b}, {l}) f_pad {f_pad}, kernel bodies in turns (counts piling up), equal "
            f"counts: {fmt(ms)} (CUDA events) [{card}]")
        del hit, frame, want, outs

    # B2 at the bench shape, the 5,000-keyframe chunk's and one query's:
    # equal on the valid slots.
    nj, c = EXPAND_JOBS, EXPAND_CHANNELS
    for b, l_max in ((CHUNK, 98304), (SCALE_CHUNK, 1802240), (1, 98304)):
        length, payload = expand_inputs(rng_b23, b, l_max, dev)
        offsets = expand.job_offsets(length).contiguous()
        valid = torch.arange(l_max, device=dev) < offsets[:, -1:]  # (B, L)
        outs = [torch.empty((b, c, l_max), dtype=torch.int32, device=dev) for _ in libs]
        run = lambda lib, o: lib.sgtd_expand_jobs(offsets.data_ptr(), payload.data_ptr(), o.data_ptr(),
                                                  b, nj, c, l_max, stream())
        if any(run(lib, o) for lib, o in zip(libs, outs)):
            fail(f"baseline compare: B2 expand_jobs ({b}, {l_max}) failed to launch")
        for name, o in zip(names, outs):
            if bool(((o != outs[-1]) & valid[:, None]).any()):
                fail(f"baseline compare: B2 expand_jobs ({b}, {l_max}): {name} differs from this tree on valid slots")
        ms = turns_ms_of([lambda lib=lib, o=o: run(lib, o) for lib, o in zip(libs, outs)], 20)
        log(f"   B2 expand_jobs ({b}, {nj} jobs, {c} ch) -> {l_max} slots ({int(valid.sum())} valid), kernel bodies "
            f"in turns, equal on valid slots: {fmt(ms)} (CUDA events) [{card}]")
        # The caller reads the output at once: the body and then one pass
        # that reads all of it, so that a store which leaves less of the
        # output in the L2 cache shows what it costs the reader.
        scratch = torch.empty_like(outs[0])
        ms = turns_ms_of([lambda lib=lib, o=o: (run(lib, o), torch.add(o, 1, out=scratch))
                          for lib, o in zip(libs, outs)], 20)
        log(f"      each followed by one elementwise pass over its output (torch.add): {fmt(ms)}")
        del length, payload, offsets, valid, outs, scratch

    # B3 at a chunk's 800 candidates, a 5,000-keyframe chunk's 400 and one
    # query's 50: equal bits. The chunk also under a threshold that every
    # pair meets (1e4 m), where no hypothesis ends before its third vertex.
    for n, thr in ((CHUNK * 50, 3.0), (CHUNK * 50, 1e4), (SCALE_CHUNK * 50, 3.0), (50, 3.0)):
        h, p = 50, 512
        args = [a.contiguous() for a in votes_problem(rng_b23, n, h, p, "prefix", dev)]
        outs = [torch.empty((n, h), dtype=torch.int32, device=dev) for _ in libs]
        run = lambda lib, o: lib.sgtd_hypothesis_votes(*(a.data_ptr() for a in args), o.data_ptr(), n, h, p,
                                                       verify._thr2(thr), stream())
        if any(run(lib, o) for lib, o in zip(libs, outs)) or not all(torch.equal(o, outs[-1]) for o in outs):
            fail(f"baseline compare: B3 hypothesis_votes at {n} candidates differs between the libraries")
        ms = turns_ms_of([lambda lib=lib, o=o: run(lib, o) for lib, o in zip(libs, outs)], 50)
        log(f"   B3 hypothesis_votes ({n} cand, {h} hyp, {p} pairs, thr {thr:g}), kernel bodies in turns, equal "
            f"bits: {fmt(ms)} (CUDA events) [{card}]")
        del args, outs

    # B4 and B7 at a chunk's 64 problems, the hard world's 160 and one query's 4.
    for p in (CHUNK * RERANK_K, CHUNK * HARD_RERANK_K, RERANK_K):
        n, t = SRC_PTS, CLOUD_PTS
        src, tgt = nn1_clouds(rng, p, n, t, dev)
        outs = [(torch.empty((p, n), dtype=torch.int32, device=dev), torch.empty((p, n), device=dev)) for _ in libs]
        run = lambda lib, o: lib.sgtd_nn1(src.data_ptr(), tgt.data_ptr(), o[0].data_ptr(), o[1].data_ptr(),
                                          p, n, t, stream())
        if any(run(lib, o) for lib, o in zip(libs, outs)):
            fail(f"baseline compare: B4 nn1 at {p} problems failed to launch")
        bits = lambda o: (o[0], o[1].view(torch.int32))
        for name, o in zip(names, outs):
            if not all(torch.equal(a, b) for a, b in zip(bits(o), bits(outs[-1]))):
                fail(f"baseline compare: B4 nn1 at {p} problems: {name} differs from this tree in its bits")
        ms = turns_ms_of([lambda lib=lib, o=o: run(lib, o) for lib, o in zip(libs, outs)], 50)
        log(f"   B4 nn1 ({p}, {n}) x ({p}, {t}), kernel bodies in turns, equal bits: {fmt(ms)} (CUDA events) [{card}]")

        gate = float("inf") if p == CHUNK * RERANK_K else HARD_GATE_M
        args = [a.contiguous() for a in gicp_problems(rng, p, n, t, dev)]
        outs = [(torch.empty((p, -(-n // 32), gicp.PARTIAL), device=dev), torch.empty((p, gicp.ROW), device=dev),
                 torch.empty((p, n, gicp.AUX), device=dev)) for _ in libs]
        run = lambda lib, o: lib.sgtd_linearize_gicp(*(a.data_ptr() for a in args), *(x.data_ptr() for x in o),
                                                     p, n, t, gicp._gate2(gate), stream())
        if any(run(lib, o) for lib, o in zip(libs, outs)):
            fail(f"baseline compare: B7 linearize_gicp at {p} problems failed to launch")
        gaps = []
        for name, (_, sums, aux) in zip(names, outs):
            want_sums, want_aux = outs[-1][1:]
            if not (torch.equal(aux[..., :3], want_aux[..., :3]) and torch.equal(aux[..., 12], want_aux[..., 12])
                    and torch.equal(sums[:, gicp.N_VALID], want_sums[:, gicp.N_VALID])):
                fail(f"baseline compare: B7 linearize_gicp at {p} problems: {name} differs from this tree in "
                     "b, w or n_valid")
            gaps.append(max((sums - want_sums).abs().max().item(), (aux - want_aux).abs().max().item()))
        ms = turns_ms_of([lambda lib=lib, o=o: run(lib, o) for lib, o in zip(libs, outs)], 50)
        log(f"   B7 linearize_gicp ({p}, {n}) x ({p}, {t}) gate {gate}, kernel bodies in turns, b, w and n_valid "
            f"equal, largest gap to this tree's other outputs {gaps[:-1]}: {fmt(ms)} (CUDA events) [{card}]")
        del src, tgt, args, outs

    k = 20
    for p, n in ((CHUNK, SRC_PTS), (NUM_MAP, CLOUD_PTS)):
        pts = rng.uniform(-50, 50, (p, n, 3)).astype(np.float32)
        pts[rng.uniform(size=(p, n)) < 0.2] = 1e6
        pts = torch.from_numpy(pts).to(dev)
        outs = [torch.empty((p, n, k), dtype=torch.int32, device=dev) for _ in libs]
        run = lambda lib, o: lib.sgtd_knn(pts.data_ptr(), pts.data_ptr(), o.data_ptr(), p, n, n, k, stream())
        if any(run(lib, o) for lib, o in zip(libs, outs)) or not all(torch.equal(o, outs[-1]) for o in outs):
            fail(f"baseline compare: B5 knn ({p}, {n}) differs between the libraries")
        ms = turns_ms_of([lambda lib=lib, o=o: run(lib, o) for lib, o in zip(libs, outs)], 5 if p == NUM_MAP else 50)
        log(f"   B5 knn ({p}, {n}) self, k {k}, kernel bodies in turns, equal outputs: {fmt(ms)} "
            f"(CUDA events) [{card}]")
    for m, l in ((399104, 106496), (9775363, SCALE_CHUNK * 1802240)):
        table = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (m, 2), dtype=np.int64).astype(np.int32)).to(dev)
        random = torch.from_numpy(rng.integers(0, m, l, dtype=np.int32)).to(dev)
        # Runs of 8 to 64 consecutive rows from random starts, as the probe
        # stage reads a bucket at a time.
        n_runs = l // 8 + 1
        starts = torch.from_numpy(rng.integers(0, m - 64, n_runs)).to(dev)
        lens = torch.from_numpy(rng.integers(8, 65, n_runs)).to(dev)
        first = torch.cumsum(lens, 0) - lens
        run_of = torch.repeat_interleave(torch.arange(n_runs, device=dev), lens)[:l]
        in_runs = (starts[run_of] + torch.arange(l, device=dev) - first[run_of]).to(torch.int32)
        outs = [torch.empty((l, 2), dtype=torch.int32, device=dev) for _ in libs]
        for pattern, idx in (("random rows", random), ("runs of 8-64 rows", in_runs)):
            run = lambda lib, o: lib.sgtd_gather_rows(table.data_ptr(), idx.data_ptr(), o.data_ptr(), l, 2, stream())
            if any(run(lib, o) for lib, o in zip(libs, outs)) or not all(torch.equal(o, outs[-1]) for o in outs):
                fail(f"baseline compare: B8 gather_rows x {l} differs between the libraries")
            ms = turns_ms_of([lambda lib=lib, o=o: run(lib, o) for lib, o in zip(libs, outs)], 20)
            lib_ms = event_ms(lambda: torch.index_select(table, 0, idx), 20, 3)
            log(f"   B8 gather_rows ({m}, 2) x {l}, {pattern}, kernel bodies in turns, equal outputs: {fmt(ms)}; "
                f"index_select {lib_ms:.4f} ms (CUDA events) [{card}]")
    return old_probe, votes_libs


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

    # B8 is called by no module (nor is its TPU counterpart): drive it here
    # on what the probe stage gathers, the packed2 words of chunk 0's kept
    # hits, and decode their frames.
    from sgtd_tpu_torch.match.search import probe_and_hits

    ph = probe_and_hits(db, build_descriptors(chunks[0], cfg.desc, cfg.caps), cfg.desc, cfg.search, cfg.caps)
    live = ph.sel_frame < db.num_frames
    rows = ph.sel_row[live]
    words = probe.gather_rows(db.packed2, rows)
    frames = (words[:, 1] >> 16) & 0xFFFF
    if not (torch.equal(frames, ph.sel_frame[live]) and torch.equal(frames, db.frame_ids[rows.long()])):
        fail("B8 gather_rows: the kept hits' packed2 words decode to other frames than the probe stage's")
    b8_launches = read_counts()[7]
    if b8_launches <= 0:
        fail("B8 gather_rows was not launched")
    log(f"B8 gather_rows on chunk 0's {rows.numel()} kept hits: frames equal to the probe stage's "
        f"and to frame_ids ({b8_launches} launch)")

    times = []
    for _ in range(REPS):
        times.append(sum(timed_ms(lambda q=q: localize(db, q, cfg)) for q in chunks) / 1e3)
    scans_s = [NUM_QUERIES / s for s in times]
    log(f"steady state: scans/s per rep {scans_s} (median {statistics.median(scans_s):.2f}, "
        f"chunk {CHUNK}, synchronized per chunk) [{card}]")
    return b8_launches, (cfg, db, world, queries, chunks), results


def refined_stages(db, graphs, q_clouds, q_masks, map_clouds, map_masks, map_covs, cfg, rerank_k: int):
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
    frames_k = res.frames[:, :rerank_k].long()
    inits = se3.rt_to_mat(res.rot[:, :rerank_k], res.trans[:, :rerank_k])
    per_k = lambda x: x[:, None].expand((x.shape[0], rerank_k) + x.shape[1:])
    out = gicp_align(per_k(q_clouds), per_k(q_masks), map_clouds[frames_k], map_masks[frames_k],
                     inits, cfg.gicp, src_cov=per_k(src_cov), tgt_cov=map_covs[frames_k])
    tick("lm_loop")
    pick, use, refined = rerank_pick(
        out.fitness_gated, out.inlier_frac, db.frame_poses[frames_k] @ out.transform,
        res.poses[:, :rerank_k], res.found, cfg.gicp,
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


def refined_path(dev, card: str, cfg, db, world, queries, chunks, votes_libs=()):
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
    map_knn_launches = read_counts()[4]
    results = [
        localize_refined(db, q, q_clouds[s], q_masks[s], map_clouds, map_masks, map_covs,
                         cfg, rerank_k=RERANK_K)
        for q, s in zip(chunks, sl)
    ]
    torch.cuda.synchronize()
    launches = read_counts()[:5]
    log(f"refined path kernel launches (B1-B5): {launches} (B5: {map_knn_launches} for the map "
        f"covariances, {launches[4] - map_knn_launches} for the chunks' query covariances)")
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
    args = (db, chunks[0], q_clouds[sl[0]], q_masks[sl[0]], map_clouds, map_masks, map_covs, cfg, RERANK_K)
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

    # What B4's deferred argmin meets on this chunk's real clouds.
    with mock.patch.object(nn, "nn1", wraps=nn.nn1) as seen:
        refined_stages(*args)
    for name, call in (("first LM trip", seen.call_args_list[0]), ("final fitness pass", seen.call_args_list[-1])):
        lane, warp = rescan_share(*call.args)
        log(f"deferred argmin on chunk 0's clouds, {name} ({tuple(call.args[0].shape)} x "
            f"{tuple(call.args[1].shape)}): a query's running minimum falls in {lane:.4f} of its groups of 16 "
            f"references; some lane of a warp's 32 queries sees it in {warp:.4f} of them")
    del seen

    # What B3's warp skip meets on every chunk's real candidates.
    from sgtd_tpu_torch.ops import verify as verify_ops

    from sgtd_tpu_torch.ops import probe as probe_ops

    with mock.patch.object(verify_ops, "hypothesis_votes", wraps=verify_ops.hypothesis_votes) as seen, \
            mock.patch.object(probe_ops, "frame_votes", wraps=probe_ops.frame_votes) as seen_b1:
        for q, s in zip(chunks, sl):
            refined_stages(db, q, q_clouds[s], q_masks[s], map_clouds, map_masks, map_covs, cfg, RERANK_K)
    for i, call in enumerate(seen.call_args_list):
        log_votes_call(f"chunk {i}", call, dev, card)
    for i, call in enumerate(seen_b1.call_args_list):
        hit, frame, f_pad = call.args
        ms, bound = frame_votes_body_ms(hit, frame, f_pad), frame_votes_nbytes(hit, f_pad) / HBM_BYTES_S * 1e3
        log(f"B1 on chunk {i}'s real inputs {tuple(hit.shape)} f_pad {f_pad}: {frame_votes_work(hit, frame, f_pad)}; "
            f"kernel body {ms:.4f} ms (CUDA events behind a device spin), bound {bound:.5f} ms by bytes "
            f"({bound / ms:.3f} of the body) [{card}]")
        if votes_libs:
            votes_turns(votes_libs, f"on chunk {i}'s real inputs", hit, frame, f_pad, card)
    del seen, seen_b1

    splits = [refined_stages(*args)[2] for _ in range(3)]
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    log("refined chunk stage split, ms (median of 3, synchronized per stage): "
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
    inputs = (db, chunks, sl, q_clouds, q_masks, map_clouds, map_masks, map_covs, cfg)
    return launches, map_knn_launches, inputs, results, gts, split, statistics.median(scans_s)


def fused_path(dev, card: str, inputs, unfused, gts, unfused_split, unfused_scans_s) -> int:
    """Phase 6: phase 4's inputs with every LM trip as one launch of B7.
    Returns B7's launches on the path."""
    from sgtd_tpu_torch.eval.metrics import success_rate
    from sgtd_tpu_torch.match.pipeline import localize_refined
    from sgtd_tpu_torch.match.search import TRUNC_SCAN
    from sgtd_tpu_torch.ops import gicp as gicp_ops
    from sgtd_tpu_torch.refine import gicp

    db, chunks, sl, q_clouds, q_masks, map_clouds, map_masks, map_covs, cfg = inputs
    run = lambda q, s: localize_refined(
        db, q, q_clouds[s], q_masks[s], map_clouds, map_masks, map_covs, cfg, rerank_k=RERANK_K)
    stage_args = lambda i: (db, chunks[i], q_clouds[sl[i]], q_masks[sl[i]], map_clouds, map_masks, map_covs,
                            cfg, RERANK_K)
    unfused_picks = [refined_stages(*stage_args(i))[1] for i in range(len(chunks))]

    with mock.patch.object(gicp, "_USE_FUSED_LINEARIZE", True):
        reset_counts()
        torch.cuda.synchronize()
        results = [run(q, s) for q, s in zip(chunks, sl)]
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"fused refined path kernel launches (B1-B8): {counts}")
        n_chunks, trips = len(chunks), cfg.gicp.max_iterations
        if min(counts[:3]) <= 0 or counts[4] <= 0:
            fail(f"a kernel of the fused refined path was never launched: {counts}")
        if counts[3] != n_chunks or not n_chunks <= counts[6] <= trips * n_chunks:
            fail(f"fused path: B4 must launch once a chunk ({n_chunks}) and B7 between 1 and "
                 f"{trips} times a chunk: {counts}")
        log(f"fused path: B7 launched {counts[6]} times ({trips} LM trips x {n_chunks} chunks = "
            f"{trips * n_chunks}), B4 {counts[3]} (the final fitness pass of each chunk)")

        pose = torch.cat([r.pose for r in results])
        found = torch.cat([r.result.found for r in results])
        truncated = torch.cat([r.result.truncated for r in results]).cpu().numpy()
        if tuple(pose.shape) != (NUM_QUERIES, 4, 4) or not bool(torch.isfinite(pose).all()):
            fail(f"fused refined poses: shape {tuple(pose.shape)} or non-finite values")
        n_trunc = int(((truncated & TRUNC_SCAN) != 0).sum())
        sr = success_rate(gts, pose.cpu().numpy(), found.cpu().numpy(), cfg)
        log(f"fused refined bench world: SR={sr:.4f} TRUNC_SCAN={n_trunc} [{card}]")
        if n_trunc or sr < SR_GATE:
            fail(f"fused path: {n_trunc} truncated scans, success rate {sr:.4f}")
        for name, a, b in (("found", found, torch.cat([r.result.found for r in unfused])),
                           ("refined", torch.cat([r.refined for r in results]),
                            torch.cat([r.refined for r in unfused]))):
            if not torch.equal(a, b):
                fail(f"fused path: {name} differs from the unfused path's")
        unfused_pose = torch.cat([r.pose for r in unfused])
        dt, dr = pose_gap(pose, unfused_pose)
        gaps = (pose[:, :3, 3] - unfused_pose[:, :3, 3]).double().norm(dim=-1)
        log(f"fused against unfused pose gaps: median {gaps.median().item():.3e} m, "
            f"{int((gaps > 1e-3).sum())} of {NUM_QUERIES} above 1e-3 m, max {dt:.3e} m / {dr:.3e} rad")
        if dt > FUSED_POS_TOL_M or dr > ROT_TOL_RAD:
            fail(f"fused path: poses differ from the unfused path's by {dt} m / {dr} rad")
        staged = [refined_stages(*stage_args(i)) for i in range(n_chunks)]
        if not torch.equal(torch.cat([s[1] for s in staged]), torch.cat(unfused_picks)):
            fail("fused path: the rerank's picks differ from the unfused path's")
        log(f"fused against unfused, all {NUM_QUERIES} queries: pick, found, refined equal; poses within "
            f"{dt:.3e} m / {dr:.3e} rad")

        # Chunk 0 with B7 as its plain version.
        with mock.patch.object(gicp_ops, "linearize_gicp", gicp_ops.linearize_gicp_plain):
            plain, plain_pick, _ = refined_stages(*stage_args(0))
        dt, dr = pose_gap(plain.pose, staged[0][0].pose)
        if not torch.equal(plain_pick, staged[0][1]) or dt > FUSED_POS_TOL_M or dr > ROT_TOL_RAD:
            fail(f"fused path: the plain-version (B7) rerun differs in pick or by {dt} m / {dr} rad")
        log(f"plain-version (B7) rerun of chunk 0: pick equal; poses within {dt:.3e} m / {dr:.3e} rad")

    # Unfused and fused in turns (u, f, f, u) on the same card and host:
    # the stage split of chunk 0 and the steady state over all chunks.
    splits, times = {False: [], True: []}, {False: [], True: []}
    for _ in range(REPS):
        for fused in (False, True, True, False):
            with mock.patch.object(gicp, "_USE_FUSED_LINEARIZE", fused):
                splits[fused].append(refined_stages(*stage_args(0))[2])
                times[fused].append(sum(timed_ms(lambda q=q, s=s: run(q, s)) for q, s in zip(chunks, sl)) / 1e3)
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items()) + f"; total {sum(d.values()):.2f}"
    median_split = lambda ss: {k: statistics.median(s[k] for s in ss) for k in ss[0]}
    log(f"refined chunk stage split in turns, ms (median of {2 * REPS}): fused {fmt(median_split(splits[True]))} "
        f"[{card}]")
    log(f"   unfused, same chunk: {fmt(median_split(splits[False]))}")
    log(f"   unfused in phase 4: {fmt(unfused_split)}")
    scans = {f: [NUM_QUERIES / s for s in times[f]] for f in times}
    log(f"refined steady state in turns: fused scans/s {scans[True]} (median "
        f"{statistics.median(scans[True]):.2f}); unfused {scans[False]} (median "
        f"{statistics.median(scans[False]):.2f}; {unfused_scans_s:.2f} in phase 4); chunk {CHUNK}, "
        f"rerank_k {RERANK_K}, synchronized per chunk [{card}]")
    return counts[6]


def scale_world(num_map: int):
    """The large-map world of tools/scale_bench.py:40-59 (host graphs)."""
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.data.synthetic import make_world, observe

    cfg = SGTDConfig()
    rng = np.random.default_rng(SCALE_SEED)
    extent = max(400.0, 8.0 * np.sqrt(num_map) * 4.0)
    world = make_world(rng, extent_m=extent, num_map_frames=num_map, num_queries=SCALE_QUERIES)
    maps = [observe(world, p, cfg, rng) for p in world.map_poses]
    queries = [observe(world, p, cfg, rng, center_noise_m=0.05, dropout=0.1) for p in world.query_poses]
    return cfg, extent, maps, queries, world


def host_candidates(results):
    """(Q, C) candidate frames and votes of chunked results, on the host."""
    return tuple(torch.cat([getattr(r, n) for r in results]).cpu().numpy() for n in ("frames", "votes"))


def canonical_candidates(frames, votes):
    """(Q, C) candidate frames and votes in (votes desc, frame asc) order,
    the candidate search's own order whatever the verification scores:
    int32 and float32 NumPy arrays."""
    frames, votes = np.asarray(frames, np.int32), np.asarray(votes, np.float32)
    order = np.stack([np.lexsort((f, -v)) for f, v in zip(frames, votes)])
    return np.take_along_axis(frames, order, 1), np.take_along_axis(votes, order, 1)


def candidates_sha256(frames, votes) -> str:
    """SHA-256 of the canonical int32 frames and float32 votes."""
    f, v = canonical_candidates(frames, votes)
    return hashlib.sha256(f.tobytes() + v.tobytes()).hexdigest()


def scale_stages(db, graphs, cfg):
    """``localize`` on one chunk stage by stage, synchronized after each:
    ms per stage (probe is the first part of search, timed apart)."""
    from sgtd_tpu_torch.desc.triangles import build_descriptors
    from sgtd_tpu_torch.match.pipeline import rank_candidates
    from sgtd_tpu_torch.match.search import candidate_search, probe_and_hits
    from sgtd_tpu_torch.match.verify import verify_candidates

    use_sel = cfg.caps.max_scan_slots <= cfg.caps.sel_max_scan_slots
    ms = {}
    query = build_descriptors(graphs, cfg.desc, cfg.caps)
    ms["descriptors"] = timed_ms(lambda: build_descriptors(graphs, cfg.desc, cfg.caps))
    ms["probe"] = timed_ms(lambda: probe_and_hits(db, query, cfg.desc, cfg.search, cfg.caps, with_sel=use_sel))
    out = {}
    ms["search"] = timed_ms(lambda: out.setdefault("c", candidate_search(db, query, cfg.desc, cfg.search, cfg.caps)))
    ms["verify"] = timed_ms(lambda: rank_candidates(
        db, query, out["c"], verify_candidates(db, query, out["c"], cfg.search), cfg))
    return ms


def large_map(dev, card: str, num_map: int):
    """Phase 5: the large map through the port's public entry points.
    Returns B6's launches in gate (1)'s run, and the tuned config, DB and
    world for phase 10."""
    from sgtd_tpu_torch.db.database import tuned_config
    from sgtd_tpu_torch.db.device_build import build_database_calibrated
    from sgtd_tpu_torch.desc.triangles import build_descriptors
    from sgtd_tpu_torch.eval.metrics import success_rate
    from sgtd_tpu_torch.eval.runner import build_descriptors_chunked
    from sgtd_tpu_torch.graph.types import SemanticGraph, stack_graphs
    from sgtd_tpu_torch.interop import pad_frames
    from sgtd_tpu_torch.match.pipeline import localize, localize_exact
    from sgtd_tpu_torch.match.search import TRUNC_SCAN, fit_scan_slots
    from sgtd_tpu_torch.ops import probe

    t0 = time.perf_counter()
    cfg, extent, maps, queries, world = scale_world(num_map)
    log(f"large map: {num_map} keyframes, extent {extent:.0f} m, {SCALE_QUERIES} queries; "
        f"world and graphs {time.perf_counter() - t0:.2f} s (host)")
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, max_scan_slots=SCALE_SLOT_CEILING))
    map_batch = stack_graphs(maps, dev)
    qb = stack_graphs(queries, dev)
    rows_of = lambda s: SemanticGraph(*(x[s] for x in qb))
    chunks = [rows_of(slice(i, i + SCALE_CHUNK)) for i in range(0, SCALE_QUERIES, SCALE_CHUNK)]
    gts = [g.pose for g in queries]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    map_descs = build_descriptors_chunked(map_batch, cfg, chunk=SCALE_BUILD_CHUNK)
    torch.cuda.synchronize()
    desc_s = time.perf_counter() - t0
    sample = build_descriptors(rows_of(slice(0, SCALE_SAMPLE)), cfg.desc, cfg.caps)
    db, report, totals = build_database_calibrated(map_descs, map_batch.pose, sample, cfg.desc)
    cfg = fit_scan_slots(int(totals.max()), tuned_config(cfg, report))
    torch.cuda.synchronize()
    db_s = time.perf_counter() - t0
    del map_descs
    use_sel = cfg.caps.max_scan_slots <= cfg.caps.sel_max_scan_slots
    log(f"large map DB: rows={report.num_rows} cells={report.num_cells} "
        f"max_bucket={report.max_bucket} max_cell_bucket={report.max_cell_bucket} "
        f"f_pad={db.num_frames} direct_table={db.has_direct_table} "
        f"scan_slots={cfg.caps.max_scan_slots} (max sampled total {int(totals.max())}) "
        f"bucket_cap={cfg.caps.bucket_cap} pair lists={'sel' if use_sel else 'candidate-major'}; "
        f"descriptors {desc_s:.4f} s, db_build_s={db_s:.4f} (descriptors included) [{card}]")

    def outcome(results, name):
        found = torch.cat([r.found for r in results]).cpu().numpy()
        poses = torch.cat([r.poses[:, 0] for r in results]).cpu().numpy()
        trunc = torch.cat([r.truncated for r in results]).cpu().numpy()
        n_trunc = int(((trunc & TRUNC_SCAN) != 0).sum())
        sr = success_rate(gts, poses, found, cfg)
        if n_trunc:
            fail(f"large map {name}: {n_trunc} queries overflowed the calibrated scan cap")
        if sr < SR_GATE:
            fail(f"large map {name}: success rate {sr:.4f} below {SR_GATE}")
        return sr

    def same(a, b, fields, what):
        for f in fields:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                fail(f"large map {what}: {f} differs")

    # (1) The default config.
    reset_counts()
    torch.cuda.synchronize()
    res1 = [localize(db, q, cfg) for q in chunks]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"large map (1) kernel launches (B1-B6): {counts}")
    if counts[0] != 0 or counts[5] <= 0 or min(counts[1:3]) <= 0:
        fail(f"large map (1): B2, B3 and B6 must launch and B1 must not: {counts}")
    sr1 = outcome(res1, "(1)")
    cand_f, cand_v = canonical_candidates(*host_candidates(res1))
    digest = candidates_sha256(cand_f, cand_v)
    log(f"large map (1): SR={sr1:.4f} TRUNC_SCAN=0; candidates sha256 {digest}")
    if num_map == 5000 and (report.num_rows, digest) != tuple(REFERENCE_5K.values()):
        fail(f"large map: rows {report.num_rows} / sha256 {digest} differ from the JAX "
             f"reference's {REFERENCE_5K}")

    # What B3's tile skip and pairs-a-lane choice meet on this map.
    from sgtd_tpu_torch.ops import verify as verify_ops

    with mock.patch.object(verify_ops, "hypothesis_votes", wraps=verify_ops.hypothesis_votes) as seen:
        localize(db, chunks[0], cfg)
    log_votes_call("the large map's chunk 0", seen.call_args_list[0], dev, card)
    del seen

    # (2) Candidate-major pair lists: the same candidates and votes.
    cm = cfg.replace(caps=dataclasses.replace(cfg.caps, sel_max_scan_slots=0))
    res2 = [localize(db, q, cm) for q in chunks]
    sr2 = outcome(res2, "(2)")
    for got, want in zip(canonical_candidates(*host_candidates(res2)), (cand_f, cand_v)):
        if not np.array_equal(got, want):
            fail("large map (2): candidate-major run's candidates or votes differ from (1)'s")
    log(f"large map (2) candidate-major: candidates and votes equal to (1)'s; SR={sr2:.4f}")

    # (3) Bisection: the same DB without its bucket table.
    no_table = db._replace(bucket_table=db.bucket_table[:0], cell_remap=db.cell_remap[:0],
                           code_remap=db.code_remap[:0])
    same(localize(no_table, chunks[0], cfg), res1[0], ("frames", "votes"), "(3) bisection")
    log("large map (3) bisection, chunk 0: frames and votes equal to (1)'s")

    # (4) A cap far below the scan, then localize_exact.
    capped = cfg.replace(caps=dataclasses.replace(cfg.caps, max_scan_slots=8192))
    trunc = localize(db, chunks[1], capped).truncated
    if not bool(((trunc & TRUNC_SCAN) != 0).all()):
        fail(f"large map (4): the 8,192-slot cap left TRUNC_SCAN unset: {trunc.tolist()}")
    exact = localize_exact(db, chunks[1], capped)
    same(exact, res2[1], ("frames", "votes"), "(4) localize_exact")
    if bool(exact.truncated.any()):
        fail("large map (4): localize_exact flagged truncation")
    log("large map (4) localize_exact, chunk 1 under an 8,192-slot cap: frames and votes "
        "equal to the uncapped run")

    # (5) The frame axis padded past 65,536: live candidates equal.
    reset_counts()
    wide = localize(pad_frames(db, WIDE_F_PAD), chunks[2], cfg)
    if read_counts()[5] <= 0:
        fail("large map (5): B6 was not launched")
    ref = res1[2]
    live = ref.votes >= cfg.search.min_votes
    if not torch.equal(live, wide.votes >= cfg.search.min_votes):
        fail("large map (5): live candidates differ")
    for f in ("frames", "votes", "scores"):
        if not torch.equal(getattr(wide, f)[live], getattr(ref, f)[live]):
            fail(f"large map (5): live candidates' {f} differ")
    log(f"large map (5) f_pad {WIDE_F_PAD}, chunk 2: live candidates' frames, votes and scores "
        "equal to (1)'s")

    # (6) B6 as its plain version.
    with mock.patch.object(probe, "frame_votes_wide", probe.frame_votes_wide_plain):
        plain = localize(db, chunks[3], cfg)
    same(plain, res1[3], ("frames", "votes", "found", "best_frame"), "(6) plain B6")
    log("large map (6) plain-version B6, chunk 3: frames, votes, found, best_frame equal")

    splits = [scale_stages(db, chunks[0], cfg) for _ in range(3)]
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    log("large map chunk stage split, ms (median of 3, synchronized per stage): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f" [{card}]")
    times = []
    for _ in range(REPS):
        times.append(sum(timed_ms(lambda q=q: localize(db, q, cfg)) for q in chunks) / 1e3)
    scans_s = [SCALE_QUERIES / s for s in times]
    log(f"large map steady state: scans/s per rep {scans_s} (median {statistics.median(scans_s):.2f}, "
        f"chunk {SCALE_CHUNK}, synchronized per chunk; {num_map} keyframes, {report.num_rows} rows, "
        f"{cfg.caps.max_scan_slots} slots) [{card}]")
    log(f"large map peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts[5], (cfg, db, world), {"graphs": qb, "results": res1, "gts": gts}


def hard_world_inputs():
    """The hard world of tools/hard_eval.py:50-127 on the host: (cfg, map
    graphs, query graphs, query_cloud_fn, map_cloud_fn, GICP config)."""
    from sgtd_tpu_torch.config import GicpConfig, SGTDConfig
    from sgtd_tpu_torch.data.synthetic import make_hard_world, observe, render_planar_cloud
    from sgtd_tpu_torch.ops.voxel import load_query_cloud

    rng = np.random.default_rng(HARD_SEED)
    cfg = SGTDConfig()
    world = make_hard_world(rng, num_map_frames=NUM_MAP, num_queries=NUM_QUERIES,
                            n_motifs=HARD_MOTIFS, unique_per_block=HARD_UNIQUE)
    maps = [observe(world, p, cfg, rng, center_noise_m=0.05) for p in world.map_poses]
    queries = [observe(world, p, cfg, rng, **HARD_OBS) for p in world.query_poses]
    gicp = GicpConfig(enable=True, engine="gicp", max_points=SRC_PTS, leaf_size=HARD_LEAF,
                      max_corr_dist_m=HARD_GATE_M)

    def q_fn(i):
        pts, m = render_planar_cloud(world, world.query_poses[i], np.random.default_rng(7000 + i),
                                     max_points=CLOUD_PTS)
        return load_query_cloud(pts[m], HARD_LEAF, SRC_PTS)

    def m_fn(fid):
        return render_planar_cloud(world, world.map_poses[fid], np.random.default_rng(8000 + fid),
                                   max_points=CLOUD_PTS)

    return cfg, maps, queries, q_fn, m_fn, gicp


# Phase 8: the CLI on files of the bench world. The JAX reference's CLI
# (sgtd_tpu.cli localize with CLI_FLAGS and --engine vgicp, on the CPU) on
# the files of write_cli_world gives this success rate;
# tests/test_torch_cli.py's slow test_reference_cli_vgicp computes it again
# from sgtd_tpu.
CLI_FLAGS = ("--enable-gicp", "--batch-size", str(CHUNK), "--rerank-k", str(RERANK_K), "--leaf-size", "3.0",
             "--gicp-max-points", str(CLOUD_PTS))
REFERENCE_CLI_VGICP_SR = 1.0
# The summary keys that do not hold a time.
ACCURACY_KEYS = ("total", "success_rate", "rmse_trans_m", "rmse_rot_deg", "mean_trans_m", "mean_rot_deg",
                 "recall_at_1", "recall_at_5", "recall_at_10", "db_rows")


def write_cli_world(root: str) -> dict:
    """The bench world of phase 3 (seed 2026, 200 keyframes, 64 queries,
    centre noise 0.05 m, dropout 0.1, label corruption 0.05) as the files a
    user hands the CLI, under ``root``: graph JSONs (``io.graph_json``) and
    .bin scans (``io.readers.write_bin``) of the valid points of phase 4's
    4,096-point planar renders (rng 77: the keyframes, then the queries).
    Returns the four directories by CLI flag name."""
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.data.synthetic import make_map_and_queries, render_planar_cloud
    from sgtd_tpu_torch.io.graph_json import write_graph_json
    from sgtd_tpu_torch.io.readers import write_bin

    maps, queries, world = make_map_and_queries(
        SGTDConfig(), seed=SEED, num_map_frames=NUM_MAP, num_queries=NUM_QUERIES,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    rng = np.random.default_rng(77)
    dirs = {}
    for side, graphs, poses in (("map", maps, world.map_poses), ("query", queries, world.query_poses)):
        dirs[f"{side}_graphs"], dirs[f"{side}_scans"] = (os.path.join(root, f"{side}_{k}") for k in ("graphs", "scans"))
        os.makedirs(dirs[f"{side}_graphs"])
        os.makedirs(dirs[f"{side}_scans"])
        for i, (g, p) in enumerate(zip(graphs, poses)):
            write_graph_json(os.path.join(dirs[f"{side}_graphs"], f"{i:06d}.json"), g)
            cloud, mask = render_planar_cloud(world, p, rng, max_points=CLOUD_PTS)
            write_bin(os.path.join(dirs[f"{side}_scans"], f"{i:06d}.bin"), cloud[mask])
    return dirs


def cli_args(dirs: dict, engine: str, artifacts: str) -> list:
    """``localize``'s arguments on ``write_cli_world``'s files."""
    return ["localize", "--map-graphs", dirs["map_graphs"], "--query-graphs", dirs["query_graphs"],
            "--map-scans", dirs["map_scans"], "--query-scans", dirs["query_scans"], *CLI_FLAGS,
            "--engine", engine, "--map-artifacts", artifacts]


def vgicp_stages(db, graphs, q_clouds, q_masks, vmaps, cfg, rerank_k: int):
    """``localize_refined`` with the VGICP engine on prebuilt voxel maps, one
    chunk, stage by stage through the port's public functions, synchronized
    after each: (RefinedResult, pick, ms per stage)."""
    from sgtd_tpu_torch.desc.triangles import build_descriptors
    from sgtd_tpu_torch.geom import se3
    from sgtd_tpu_torch.match.pipeline import RefinedResult, rank_candidates, rerank_pick
    from sgtd_tpu_torch.match.search import candidate_search
    from sgtd_tpu_torch.match.verify import verify_candidates
    from sgtd_tpu_torch.refine.gicp import point_covariances
    from sgtd_tpu_torch.refine.vgicp import GaussianVoxelMap, vgicp_align

    ms = {}
    torch.cuda.synchronize()
    t = [time.perf_counter()]

    def tick(name):
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ms[name] = (t[-1] - t[-2]) * 1e3

    query = build_descriptors(graphs, cfg.desc, cfg.caps)
    cand = candidate_search(db, query, cfg.desc, cfg.search, cfg.caps)
    res = rank_candidates(db, query, cand, verify_candidates(db, query, cand, cfg.search), cfg)
    tick("descriptors_search_verify")
    src_cov = point_covariances(q_clouds, q_masks, cfg.gicp)
    tick("query_covariances")
    frames_k = res.frames[:, :rerank_k].long()
    vm_k = GaussianVoxelMap(*(x[frames_k] for x in vmaps))
    tick("voxel_map_gather")
    inits = se3.rt_to_mat(res.rot[:, :rerank_k], res.trans[:, :rerank_k])
    per_k = lambda x: x[:, None].expand((x.shape[0], rerank_k) + x.shape[1:])
    out = vgicp_align(per_k(q_clouds), per_k(q_masks), None, None, inits, cfg.gicp, src_cov=per_k(src_cov),
                      voxel_map=vm_k)
    tick("lm_loop")
    pick, use, refined = rerank_pick(
        out.fitness_gated, out.inlier_frac, db.frame_poses[frames_k] @ out.transform,
        res.poses[:, :rerank_k], res.found, cfg.gicp,
    )
    rows = torch.arange(pick.shape[0], device=pick.device)
    result = RefinedResult(
        pose=torch.where(use[:, None, None], refined[rows, pick], res.poses[:, 0]),
        refined=use, fitness=out.fitness[rows, pick], result=res,
    )
    tick("pick")
    return result, pick, ms


def cli_on_files(dev, card: str) -> int:
    """Phase 8: the CLI on files. Returns B5's launches on the VGICP path
    (the in-process ``evaluate`` that mirrors the CLI's VGICP run)."""
    import tempfile

    from sgtd_tpu_torch import native
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.db.artifacts import build_map_artifacts, load_map_artifacts, save_map_artifacts
    from sgtd_tpu_torch.db.database import DescriptorDB, load_database, save_database
    from sgtd_tpu_torch.eval import runner
    from sgtd_tpu_torch.graph.types import stack_graphs
    from sgtd_tpu_torch.io import readers
    from sgtd_tpu_torch.io.graph_json import read_graph_dir
    from sgtd_tpu_torch.match.pipeline import localize, localize_refined
    from sgtd_tpu_torch.match.search import TRUNC_SCAN
    from sgtd_tpu_torch.ops import nn
    from sgtd_tpu_torch.ops.voxel import load_query_cloud
    from sgtd_tpu_torch.refine.vgicp import GaussianVoxelMap, build_voxel_maps

    if not native.native_available():
        fail("the native loader (sgtd_tpu_torch/native/loader.cpp) did not build")
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="sgtd_cli_") as root:
        t0 = time.perf_counter()
        dirs = write_cli_world(root)
        log(f"CLI world: {NUM_MAP} keyframe and {NUM_QUERIES} query graph JSONs and .bin scans written in "
            f"{time.perf_counter() - t0:.2f} s (host)")

        # The CLI in subprocesses, GICP and VGICP side by side: first the
        # runs that build and save their map artifacts, then (beside the
        # untimed checks below) the runs that load them.
        summaries = {}

        def start(run):
            procs = {
                engine: subprocess.Popen(
                    [sys.executable, "-m", "sgtd_tpu_torch.cli",
                     *cli_args(dirs, engine, os.path.join(root, f"artifacts_{engine}.npz"))],
                    cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
                for engine in ("gicp", "vgicp")
            }
            return run, procs, time.perf_counter()

        def finish(started):
            run, procs, t0 = started
            for engine, proc in procs.items():
                out, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    fail(f"CLI localize --engine {engine} ({run} run): exit {proc.returncode}\n{err[-3000:]}")
                summaries[engine, run] = out = json.loads(out)
                log(f"CLI {engine} {run}: " + ", ".join(f"{k} {v}" for k, v in out.items()) + f" [{card}]")
            log(f"CLI localize --engine gicp and --engine vgicp, {run} runs side by side: "
                f"{time.perf_counter() - t0:.2f} s of wall time")

        finish(start("build"))
        sr_g, sr_v = summaries["gicp", "build"]["success_rate"], summaries["vgicp", "build"]["success_rate"]
        for engine in ("gicp", "vgicp"):
            if summaries[engine, "build"]["total"] != NUM_QUERIES:
                fail(f"CLI {engine}: total {summaries[engine, 'build']['total']}, not {NUM_QUERIES}")
        if sr_g < SR_GATE:
            fail(f"CLI gicp: success rate {sr_g} below {SR_GATE}")
        if sr_v < REFERENCE_CLI_VGICP_SR - 1 / NUM_QUERIES:
            fail(f"CLI vgicp: success rate {sr_v} below the JAX reference's {REFERENCE_CLI_VGICP_SR} less 1/{NUM_QUERIES}")

        # In process, with the CLI's readers and cloud loaders.
        base = SGTDConfig()
        gcfg = dataclasses.replace(base.gicp, enable=True, leaf_size=3.0, max_points=CLOUD_PTS)
        maps = read_graph_dir(dirs["map_graphs"], base, dev)
        queries = read_graph_dir(dirs["query_graphs"], base, dev)
        index = runner.build_map_index(maps, base.replace(gicp=gcfg), dev)
        chunks = [stack_graphs(queries[i : i + CHUNK], dev) for i in range(0, NUM_QUERIES, CHUNK)]
        trunc = torch.cat([localize(index.db, q, index.config).truncated for q in chunks])
        n_trunc = int(((trunc & TRUNC_SCAN) != 0).sum())
        if n_trunc:
            fail(f"CLI world: {n_trunc} queries set TRUNC_SCAN under the CLI's config")
        q_bins = readers.list_scans(dirs["query_scans"], ".bin")
        m_bins = readers.list_scans(dirs["map_scans"], ".bin")
        t0 = time.perf_counter()
        with native.PrefetchingLoader(q_bins) as loader:
            q_clouds = [load_query_cloud(loader.get(i)[0], 3.0, CLOUD_PTS) for i in range(len(q_bins))]
        loader_s = time.perf_counter() - t0
        m_fn = lambda fid: load_query_cloud(readers.read_bin(m_bins[fid])[:, :3], 0.0, CLOUD_PTS)

        vcfg = index.config.replace(gicp=dataclasses.replace(gcfg, engine="vgicp"))
        f_pad = index.db.frame_poses.shape[0]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art = build_map_artifacts(m_fn, len(maps), vcfg.gicp, f_pad=f_pad, device=dev)
        torch.cuda.synchronize()
        build_s, build_b5 = time.perf_counter() - t0, read_counts()[4]
        path = os.path.join(root, "artifacts.npz")
        save_map_artifacts(path, art, vcfg.gicp)
        t0 = time.perf_counter()
        loaded = load_map_artifacts(path, expect_frames=f_pad, expect_gicp=vcfg.gicp, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        pairs = [(f, getattr(art, f), getattr(loaded, f)) for f in ("clouds", "masks", "covs")]
        pairs += [(f"vmaps.{f}", getattr(art.vmaps, f), getattr(loaded.vmaps, f)) for f in GaussianVoxelMap._fields]
        for name, a, b in pairs:
            if not torch.equal(a, b):
                fail(f"map artifacts: {name} differs after save and load")
        log(f"map artifacts with voxel maps ({tuple(art.vmaps.keys.shape)} voxels): built in {build_s:.3f} s with "
            f"the host's .bin reads (B5: {build_b5} launches), loaded in {load_s:.3f} s, equal after save and "
            f"load; the query loader (native: {native.native_available()}) read and downsampled "
            f"{len(q_bins)} scans in {loader_s:.3f} s [{card}]")

        # Untimed checks while the load runs go on.
        load_runs = start("load")
        kw = dict(batch_size=CHUNK, query_cloud_fn=lambda i: q_clouds[i], rerank_k=RERANK_K, map_artifacts=art)
        reset_counts()
        out_g = runner.evaluate(index, queries, **kw)
        counts_g = read_counts()
        want = summaries["gicp", "build"]
        if any(out_g[k] != want[k] for k in ACCURACY_KEYS):
            fail(f"in-process evaluate (gicp) {out_g} differs from the CLI's {want}")
        log(f"in-process evaluate, gicp: equal to the CLI's summary on {ACCURACY_KEYS}; launches (B1-B8) {counts_g}")
        if min(counts_g[:5]) <= 0:
            fail(f"in-process evaluate (gicp): a kernel of the path was never launched: {counts_g}")

        # Chunk 0 stage by stage, against localize_refined; then with B5
        # patched to its plain version.
        qc = torch.from_numpy(np.stack([c for c, _ in q_clouds[:CHUNK]])).to(dev)
        qm = torch.from_numpy(np.stack([m for _, m in q_clouds[:CHUNK]])).to(dev)
        args = (index.db, chunks[0], qc, qm, art.vmaps, vcfg, RERANK_K)
        staged, pick, _ = vgicp_stages(*args)
        whole = localize_refined(index.db, chunks[0], qc, qm, art.clouds, art.masks, None, vcfg, RERANK_K,
                                 map_vmaps=art.vmaps)
        dt, dr = pose_gap(staged.pose, whole.pose)
        if dt > POS_TOL_M or dr > ROT_TOL_RAD or not torch.equal(staged.refined, whole.refined):
            fail(f"VGICP chunk 0 stage by stage differs from localize_refined ({dt} m, {dr} rad)")
        with mock.patch.object(nn, "knn", nn.knn_plain):
            plain, plain_pick, _ = vgicp_stages(*args)
        dt, dr = pose_gap(plain.pose, staged.pose)
        for name, a, b in (("pick", plain_pick, pick), ("refined", plain.refined, staged.refined),
                           ("found", plain.result.found, staged.result.found)):
            if not torch.equal(a, b):
                fail(f"VGICP plain-version (B5) rerun differs in {name}")
        if dt > POS_TOL_M or dr > ROT_TOL_RAD:
            fail(f"VGICP plain-version (B5) rerun poses differ by {dt} m / {dr} rad")
        log(f"VGICP plain-version (B5) rerun of chunk 0: pick, refined, found equal; poses within {dt:.3e} m / "
            f"{dr:.3e} rad (gates {POS_TOL_M} m, {ROT_TOL_RAD} rad)")

        # The DB through the port's save_database and load_database.
        path = os.path.join(root, "db.npz")
        save_database(path, index.db)
        back = load_database(path, dev)
        differ = [f for f in DescriptorDB._fields if not torch.equal(getattr(back, f), getattr(index.db, f))]
        if differ:
            fail(f"descriptor DB: {differ} differ after save_database and load_database")
        log(f"descriptor DB ({index.report.num_rows} rows): all {len(DescriptorDB._fields)} fields equal after "
            f"save_database and load_database ({os.path.getsize(path)} bytes)")

        finish(load_runs)
        for engine in ("gicp", "vgicp"):
            build, load = summaries[engine, "build"], summaries[engine, "load"]
            if list(build) != list(load) or any(build[k] != load[k] for k in ACCURACY_KEYS):
                fail(f"CLI {engine}: the load run's summary {load} differs from the build run's {build}")
        log(f"CLI: build and load runs equal on {ACCURACY_KEYS}; SR gicp {sr_g:.4f} (gate {SR_GATE}), vgicp "
            f"{sr_v:.4f} (the JAX reference's {REFERENCE_CLI_VGICP_SR:.4f} less 1/{NUM_QUERIES} is the gate)")

        # Timed, with the card and the host to this process again.
        index_v = dataclasses.replace(index, config=vcfg)
        reset_counts()
        out_v = runner.evaluate(index_v, queries, **kw)
        counts_v = read_counts()
        log(f"in-process evaluate, vgicp: SR {out_v['success_rate']:.4f} (CLI {sr_v:.4f}), "
            f"{1e3 / out_v['mean_time_ms']:.2f} scans/s steady state (chunk {CHUNK}, rerank_k {RERANK_K}, "
            f"synchronized per chunk), launches (B1-B8) {counts_v} [{card}]")
        if min(counts_v[i] for i in (0, 1, 2, 4)) <= 0 or counts_v[3] or counts_v[6]:
            fail(f"in-process evaluate (vgicp): B1-B3 and B5 must launch, B4 and B7 not: {counts_v}")
        if any(out_v[k] != summaries["vgicp", "build"][k] for k in ACCURACY_KEYS):
            log(f"   note: the in-process vgicp summary differs from the CLI's: {out_v}")
        splits = [vgicp_stages(*args)[2] for _ in range(3)]
        split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
        log("VGICP chunk stage split, ms (median of 3, synchronized per stage): "
            + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f"; total {sum(split.values()):.2f} [{card}]")
        # What PERF.md predicts: the LM loop of the same chunk under
        # DIRECT7 and DIRECT27, and the voxel maps alone in either mode.
        for ns in ("direct7", "direct27"):
            c = vcfg.replace(gicp=dataclasses.replace(vcfg.gicp, neighbor_search=ns))
            ms = statistics.median(vgicp_stages(index.db, chunks[0], qc, qm, art.vmaps, c, RERANK_K)[2]["lm_loop"]
                                   for _ in range(3))
            log(f"VGICP chunk LM loop with {ns}: {ms:.2f} ms (median of 3) [{card}]")
        for mode in ("additive", "multiplicative"):
            mcfg = dataclasses.replace(vcfg.gicp, voxel_mode=mode)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(0, f_pad, 64):
                    build_voxel_maps(art.clouds[i : i + 64], art.masks[i : i + 64], art.covs[i : i + 64], mcfg)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            log(f"voxel maps of {f_pad} keyframes alone, {mode}: {statistics.median(times):.4f} s (median of 3; "
                f"batches of 64 keyframes, covariances given) [{card}]")
    return counts_v[4]


def oracle_subsample(n_sub: int) -> list:
    """The port's reference oracle (``eval.oracle``: the reference's
    SearchLoop transliterated in NumPy, float32 with the 1/256 fixed-point
    filter, as tools/hard_eval.py runs it) on the hard world: the DB of
    every keyframe, then each of the first ``n_sub`` queries. Returns each
    query's (best frame, within the success gate). Host only; ``main``
    runs it in a worker process beside phases 5-8."""
    from sgtd_tpu_torch.eval.metrics import rpe
    from sgtd_tpu_torch.eval.oracle import OracleManager

    cfg, maps, queries, *_ = hard_world_inputs()
    mgr = OracleManager(cfg.desc, cfg.search, dtype=np.float32, fixed_point_filter=True)
    for g in maps:
        mgr.add_stds(mgr.build(g.centers[g.mask], g.labels[g.mask]))
    out = []
    for g in queries[:n_sub]:
        best_f, _, (rot, t), _ = mgr.search_loop(mgr.build(g.centers[g.mask], g.labels[g.mask]))
        ok = False
        if best_f >= 0:
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = rot, t
            te, re_ = rpe(np.asarray(g.pose), np.asarray(maps[best_f].pose) @ T)
            ok = bool(te < cfg.success_trans_m and re_ < cfg.success_rot_deg)
        out.append((int(best_f), ok))
    return out


def found_frames_sha256(found, best_frame) -> str:
    """SHA-256 of the queries' found (uint8) and best_frame (int32)."""
    return hashlib.sha256(np.asarray(found, np.uint8).tobytes()
                          + np.asarray(best_frame, np.int32).tobytes()).hexdigest()


def hard_world(dev, card: str) -> list:
    """Phase 7: ``evaluate`` on the hard world, descriptor-only, refined
    unfused and refined fused, and one query through the TRUNC_SCAN
    fallback. Returns, for the first ``ORACLE_QUERIES`` queries, whether
    the descriptor-only pipeline's pose is within the success gate (the
    other side of ``oracle_gate``)."""
    from sgtd_tpu_torch.db.artifacts import build_map_artifacts
    from sgtd_tpu_torch.eval import runner
    from sgtd_tpu_torch.eval.metrics import rpe
    from sgtd_tpu_torch.graph.types import stack_graphs
    from sgtd_tpu_torch.match.pipeline import localize, localize_refined
    from sgtd_tpu_torch.match.search import TRUNC_SCAN
    from sgtd_tpu_torch.refine import gicp

    t0 = time.perf_counter()
    cfg, maps, queries, q_fn, m_fn, gcfg = hard_world_inputs()
    index = runner.build_map_index(maps, cfg, dev)
    log(f"hard world: {NUM_MAP} keyframes, {NUM_QUERIES} queries; rows={index.report.num_rows} "
        f"bucket_cap={index.config.caps.bucket_cap}; graphs and DB {time.perf_counter() - t0:.2f} s "
        f"(DB build {index.build_seconds:.3f} s) [{card}]")

    def table(name, out):
        keys = ("success_rate", "rmse_trans_m", "rmse_rot_deg", "mean_trans_m", "mean_rot_deg",
                "recall_at_1", "recall_at_5", "recall_at_10", "mean_time_ms", "compile_seconds",
                "artifact_build_seconds", "query_cloud_load_seconds")
        log(f"hard world {name}: total {out['total']}, " + ", ".join(f"{k} {out[k]:.4f}" for k in keys)
            + f" [{card}]")

    # Descriptor-only, and the digest of the same calls' found / best_frame.
    out_desc = runner.evaluate(index, queries, batch_size=CHUNK)
    table("descriptor-only", out_desc)
    chunks = [stack_graphs(queries[i : i + CHUNK], dev) for i in range(0, NUM_QUERIES, CHUNK)]
    res = [localize(index.db, q, index.config) for q in chunks]
    found = torch.cat([r.found for r in res]).cpu().numpy()
    best_frame = torch.cat([r.best_frame for r in res]).cpu().numpy()
    trunc = torch.cat([r.truncated for r in res]).cpu().numpy()
    got = {"rows": index.report.num_rows, "success_rate": out_desc["success_rate"],
           "sha256": found_frames_sha256(found, best_frame)}
    log(f"hard world descriptor leg: {got}; TRUNC_SCAN queries {int(((trunc & TRUNC_SCAN) != 0).sum())}")
    if got != REFERENCE_HARD:
        fail(f"hard world: the descriptor leg {got} differs from the JAX reference's {REFERENCE_HARD}")
    within = lambda i: bool(found[i]) and (lambda e: e[0] < cfg.success_trans_m and e[1] < cfg.success_rot_deg)(
        rpe(np.asarray(queries[i].pose), res[i // CHUNK].poses[i % CHUNK, 0].cpu().numpy()))
    pipeline_ok = [within(i) for i in range(ORACLE_QUERIES)]
    sr_desc = out_desc["success_rate"]
    if not 0.80 <= sr_desc < 1.0:
        fail(f"hard world: descriptor-only success rate {sr_desc} outside [0.80, 1.0)")

    # Refined, unfused and fused, on artifacts built once.
    index.config = index.config.replace(gicp=gcfg)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = build_map_artifacts(m_fn, index.db.num_frames, gcfg, f_pad=index.db.frame_poses.shape[0], device=dev)
    torch.cuda.synchronize()
    log(f"hard world map artifacts: {tuple(art.clouds.shape)} clouds, covariances through B5 in "
        f"{read_counts()[4]} launches; {time.perf_counter() - t0:.2f} s with the host renders [{card}]")
    kw = dict(batch_size=CHUNK, query_cloud_fn=q_fn, rerank_k=HARD_RERANK_K, map_artifacts=art)
    clouds = [q_fn(i) for i in range(NUM_QUERIES)]
    q_clouds = torch.from_numpy(np.stack([c for c, _ in clouds])).to(dev)
    q_masks = torch.from_numpy(np.stack([m for _, m in clouds])).to(dev)
    outs, frames = {}, {}
    for name, fused in (("refined unfused", False), ("refined fused", True)):
        with mock.patch.object(gicp, "_USE_FUSED_LINEARIZE", fused):
            reset_counts()
            outs[name] = runner.evaluate(index, queries, **kw)
            counts = read_counts()
            table(name, outs[name])
            log(f"hard world {name} kernel launches (B1-B8): {counts}")
            if (counts[6] > 0) != fused or counts[3] <= 0:
                fail(f"hard world {name}: B7 must launch only when fused, B4 always: {counts}")
            # The frame each query's pose was refined against: the rerank's pick.
            picks = []
            for i, q in enumerate(chunks):
                s = slice(i * CHUNK, (i + 1) * CHUNK)
                out, pick, _ = refined_stages(index.db, q, q_clouds[s], q_masks[s], art.clouds, art.masks,
                                              art.covs, index.config, HARD_RERANK_K)
                picked = out.result.frames.gather(1, pick[:, None])[:, 0]
                picks.append(torch.where(out.refined, picked, -1))
            frames[name] = torch.cat(picks)
        if outs[name]["success_rate"] < sr_desc + 0.02:
            fail(f"hard world {name}: success rate {outs[name]['success_rate']} is not 0.02 above "
                 f"the descriptor-only {sr_desc}")
    if not torch.equal(frames["refined unfused"], frames["refined fused"]):
        fail("hard world: fused and unfused reranks pick different frames")
    log(f"hard world: fused and unfused pick the same frame on all {NUM_QUERIES} queries; SR "
        f"{sr_desc:.4f} -> {outs['refined unfused']['success_rate']:.4f} (unfused), "
        f"{outs['refined fused']['success_rate']:.4f} (fused)")

    # One query that the descriptor leg got right, under a scan cap far
    # below its scan: localize_exact, then _rerank_single, on the card.
    qi = next(i for i in range(NUM_QUERIES) if within(i))
    capped = dataclasses.replace(index, config=index.config.replace(
        caps=dataclasses.replace(index.config.caps, max_scan_slots=1024)))
    flagged = localize(capped.db, stack_graphs(queries[qi : qi + 1], dev), capped.config).truncated
    if not bool((flagged & TRUNC_SCAN) != 0):
        fail("hard world: the 1,024-slot cap left TRUNC_SCAN unset")
    with mock.patch.object(runner, "_rerank_single", wraps=runner._rerank_single) as rerank, \
            mock.patch.object(runner, "localize_exact", wraps=runner.localize_exact) as exact:
        out = runner.evaluate(capped, queries[qi : qi + 1], batch_size=1, query_cloud_fn=lambda i: q_fn(qi + i),
                              rerank_k=HARD_RERANK_K, map_artifacts=art)
    if exact.call_count != 1 or rerank.call_count != 1 or out["success_rate"] != 1.0:
        fail(f"hard world fallback: localize_exact x{exact.call_count}, _rerank_single "
             f"x{rerank.call_count}, success rate {out['success_rate']}")
    log(f"hard world fallback, query {qi} under a 1,024-slot cap: TRUNC_SCAN set, localize_exact and "
        f"_rerank_single ran once each, pose error {out['mean_trans_m']:.4f} m / {out['mean_rot_deg']:.4f} deg")
    return pipeline_ok


def oracle_gate(oracle, pipeline_ok: list) -> None:
    """Phase 7's gate of tests/test_hard_workload.py:87-109 on the
    subsample of HARD_EVAL_r05.json's oracle_subsample: the port's
    descriptor-only success rate on the first ``ORACLE_QUERIES`` hard-world
    queries is at least the port oracle's (``oracle``: the future of
    ``oracle_subsample``)."""
    t0 = time.perf_counter()
    frames, oracle_ok = zip(*oracle.result())
    n = len(pipeline_ok)
    log(f"hard world oracle (eval.oracle, a worker process; waited {time.perf_counter() - t0:.1f} s for it): best "
        f"frames {list(frames)}, SR {sum(oracle_ok) / n:.4f}; pipeline SR {sum(pipeline_ok) / n:.4f} on the same "
        f"{n} queries")
    if sum(pipeline_ok) < sum(oracle_ok):
        fail(f"hard world: pipeline SR {sum(pipeline_ok) / n} below the oracle's {sum(oracle_ok) / n}")


# Phase 9: the front end on the card. Labeled scans of a make_world world
# (seed FRONT_SEED) at a SemanticKITTI HDL-64 scan's size, as .bin/.label
# files; build-map on them, the port's localize on the graphs it writes.
FRONT_SEED, FRONT_MAP, FRONT_QUERIES = 2026, 64, 16
FRONT_TARGET_PTS, FRONT_GROUND_PTS, FRONT_MIN_BLOB = 120_000, 24_000, 400
FRONT_VIEW_M, FRONT_LOCAL_RADIUS_M, FRONT_LOCAL_FRAMES = 50.0, 15.0, 16
# The JAX reference's graphs of these map keyframes (sgtd_tpu.cli's
# build_graph on the CPU): tests/test_torch_frontend.py's
# test_reference_frontend_graphs computes them again from sgtd_tpu.
FRONT_REF_FRAMES = (0, 21, 42, 63)
FRONT_REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "frontend_reference.json")
# Centres and densities against the reference's: each cluster sums its
# points in point order on the card as on the CPU, with the same voxels;
# the tolerance covers one float32 rounding apart in a few sums.
FRONT_CENTER_TOL_M, FRONT_DENSITY_RTOL = 1e-4, 1e-4
FEC_POINTS, FEC_MAX_N, FEC_TOL_M, FEC_MIN_SIZE = 32768, 16, 0.5, 50


def front_world():
    from sgtd_tpu_torch.data.synthetic import make_world

    return make_world(np.random.default_rng(FRONT_SEED), num_map_frames=FRONT_MAP, num_queries=FRONT_QUERIES)


def render_labeled_scan(world, pose, seed):
    """A labeled scan as a semantic-only segmentation network labels one
    (tests/test_cli.py:103-130's renderer at an HDL-64 scan's size): every
    instance within ``FRONT_VIEW_M`` a Gaussian blob (sigma 0.15 m) of at
    least ``FRONT_MIN_BLOB`` points, class ``min(label, 11) + 7``, instance
    id 0; a class-10 sidewalk sheet of ``FRONT_GROUND_PTS`` points; about
    ``FRONT_TARGET_PTS`` points in all and never above 131,072. Returns
    (points (N, 3) float32, sem (N,) uint32, inst (N,) uint32, the visible
    instances' world indices, their point counts)."""
    rng = np.random.default_rng(seed)
    Tinv = np.linalg.inv(pose)
    local = world.instance_xyz @ Tinv[:3, :3].T + Tinv[:3, 3]
    vis = np.nonzero(np.linalg.norm(local[:, :2], axis=1) < FRONT_VIEW_M)[0]
    ppi = max(FRONT_MIN_BLOB, (FRONT_TARGET_PTS - FRONT_GROUND_PTS) // max(len(vis), 1))
    pts = [local[j] + rng.normal(0, 0.15, (ppi, 3)) for j in vis]
    sem = [np.full(ppi, min(int(world.instance_label[j]), 11) + 7) for j in vis]
    pts.append(np.column_stack([rng.uniform(-FRONT_VIEW_M, FRONT_VIEW_M, (FRONT_GROUND_PTS, 2)),
                                rng.normal(0, 0.03, FRONT_GROUND_PTS)]))
    sem.append(np.full(FRONT_GROUND_PTS, 10))
    pts = np.concatenate(pts).astype(np.float32)
    if len(pts) > 131072:
        fail(f"render_labeled_scan: {len(pts)} points exceed 131,072")
    return pts, np.concatenate(sem).astype(np.uint32), np.zeros(len(pts), np.uint32), vis, np.full(len(vis), ppi)


def write_front_world(root: str, world) -> dict:
    """The phase-9 world as files under ``root``: map and query .bin/.label
    scans (``io.readers``) and KITTI-layout pose files. Returns the
    directories and files by name, and each scan's visible instances."""
    from sgtd_tpu_torch.io.readers import write_bin, write_label

    out, seen = {}, {}
    for side, poses, base in (("map", world.map_poses, 0), ("query", world.query_poses, 10_000)):
        for kind in ("scans", "labels", "graphs"):
            out[f"{side}_{kind}"] = os.path.join(root, f"{side}_{kind}")
            os.makedirs(out[f"{side}_{kind}"])
        for i, pose in enumerate(poses):
            pts, sem, inst, vis, counts = render_labeled_scan(world, pose, (FRONT_SEED, base + i))
            write_bin(os.path.join(out[f"{side}_scans"], f"{i:06d}.bin"), pts)
            write_label(os.path.join(out[f"{side}_labels"], f"{i:06d}.label"), sem, inst)
            seen[side, i] = (vis, counts)
        out[f"{side}_poses"] = os.path.join(root, f"{side}_poses.txt")
        np.savetxt(out[f"{side}_poses"], poses[:, :3, :].reshape(len(poses), 12))
    out["seen"] = seen
    return out


def front_reference_gate(graph_dir: str, card: str) -> None:
    """Phase 9, gate 1: the built graphs of ``FRONT_REF_FRAMES`` against the
    JAX reference's (``FRONT_REF_FILE``): labels and masks equal, centres
    within ``FRONT_CENTER_TOL_M``, densities within ``FRONT_DENSITY_RTOL``."""
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.io.graph_json import read_graph_json

    with open(FRONT_REF_FILE) as f:
        ref = json.load(f)
    if ref["frames"] != list(FRONT_REF_FRAMES):
        fail(f"{FRONT_REF_FILE}: frames {ref['frames']}, not {list(FRONT_REF_FRAMES)}")
    d_c = d_d = 0.0
    for i, want in zip(FRONT_REF_FRAMES, ref["graphs"]):
        g = read_graph_json(os.path.join(graph_dir, f"{i:06d}.json"), SGTDConfig(), "cpu")
        if g.labels.tolist() != want["labels"] or g.mask.int().tolist() != want["mask"]:
            fail(f"build-map keyframe {i}: node labels or mask differ from the JAX reference's")
        m = g.mask.numpy()
        d_c = max(d_c, float(np.abs(g.centers.numpy()[m] - np.asarray(want["centers"], np.float32)).max()))
        wd = np.asarray(want["density"], np.float32)
        d_d = max(d_d, float((np.abs(g.density.numpy()[m] - wd) / np.maximum(np.abs(wd), 1e-6)).max()))
    if d_c > FRONT_CENTER_TOL_M or d_d > FRONT_DENSITY_RTOL:
        fail(f"build-map: centres {d_c} m or densities {d_d} (relative) off the JAX reference's")
    log(f"build-map against the JAX reference (keyframes {list(FRONT_REF_FRAMES)}, "
        f"{sum(sum(g['mask']) for g in ref['graphs'])} nodes): labels and masks equal, centres within {d_c:.3e} m "
        f"(gate {FRONT_CENTER_TOL_M}), densities within {d_d:.3e} relative (gate {FRONT_DENSITY_RTOL}) [{card}]")


def front_world_gate(world, seen: dict, graphs: dict):
    """Phase 9, gate 2: the share of rendered instances (of a class the
    routing clusters, at least its ``min_seg`` points, inside the range
    gates) that have a node of the right label within 0.1 m, and their
    count."""
    from sgtd_tpu_torch.graph.build import MULRAN_ROUTING

    is_inst, min_seg, node_label = MULRAN_ROUTING.tables()
    hit = total = 0
    for (side, i), (vis, counts) in seen.items():
        g = graphs[side][i]
        m = g.mask.cpu().numpy()
        lab, cen = g.labels.cpu().numpy()[m], g.centers.cpu().numpy()[m]
        pose = (world.map_poses if side == "map" else world.query_poses)[i]
        Tinv = np.linalg.inv(pose)
        local = world.instance_xyz[vis] @ Tinv[:3, :3].T + Tinv[:3, 3]
        for c_xyz, j, n in zip(local, vis, counts):
            cls = min(int(world.instance_label[j]), 11) + 7
            if not is_inst[cls] or n < min_seg[cls] or not 0.5 < np.linalg.norm(c_xyz) < 120.0:
                continue
            total += 1
            hit += bool(((lab == node_label[cls]) & (np.linalg.norm(cen - c_xyz, axis=1) < 0.1)).any())
    return hit / max(total, 1), total


def fec_on_b5(dev, card: str, scan_file: str, label_file: str):
    """Phase 9, FEC: one class-filtered cloud of a rendered scan, padded to
    ``FEC_POINTS``, through ``fec_cluster`` on the card (B5 at P = 1, N =
    N), against the same call with B5's plain version; then B5's body at
    this shape. Returns (B5's launches in the FEC call, B5's record at
    this shape)."""
    from sgtd_tpu_torch.cluster import fec
    from sgtd_tpu_torch.io.readers import read_bin, read_label
    from sgtd_tpu_torch.ops import nn

    pts, (sem, _) = read_bin(scan_file)[:, :3], read_label(label_file)
    cls = int(np.bincount(sem[sem != 10]).argmax())
    cloud = pts[sem == cls][:FEC_POINTS]
    n = len(cloud)
    points = torch.zeros((FEC_POINTS, 3), dtype=torch.float32, device=dev)
    points[:n] = torch.from_numpy(cloud).to(dev)
    mask = torch.zeros(FEC_POINTS, dtype=torch.bool, device=dev)
    mask[:n] = True
    args = (points, mask, FEC_TOL_M, FEC_MIN_SIZE, FEC_MAX_N)
    reset_counts()
    fec.ITERATIONS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fec.fec_cluster(*args)
    torch.cuda.synchronize()
    fec_s, launches, sweeps = time.perf_counter() - t0, read_counts()[4], fec.ITERATIONS
    if launches < 1:
        fail(f"FEC: B5 never launched on its path ({launches})")
    with mock.patch.object(nn, "knn", nn.knn_plain):
        plain = fec.fec_cluster(*args)
    if not (torch.equal(got.labels, plain.labels) and torch.equal(got.counts, plain.counts)):
        fail("FEC: labels or counts with B5 differ from the same call with B5's plain version")
    eff = torch.where(mask[:, None], points, 1e6)
    knn_idx, plain_idx = nn.knn(eff, eff, FEC_MAX_N), nn.knn_plain(eff, eff, FEC_MAX_N)
    n_rows, err = check_nn_rows(f"B5 knn FEC (1, {FEC_POINTS}) self", eff, eff, knn_idx, plain_idx)
    ms = event_ms(lambda: nn.knn(eff, eff, FEC_MAX_N), 10)
    plain_ms = event_ms(lambda: nn.knn_plain(eff, eff, FEC_MAX_N), 1, 3, spin=False)
    rec = kernel_record("knn", "nn.cu", "sgtd_tpu/ops/pallas_nn.py:133", err, ms, plain_ms,
                        nbytes=4 * FEC_POINTS * (3 + 3 + FEC_MAX_N), flops=8 * FEC_POINTS * FEC_POINTS)
    queries, warps, blocks = nn.scan_plan(1, FEC_POINTS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"FEC on B5: class {cls}, {n} points padded to {FEC_POINTS}, tolerance {FEC_TOL_M} m, max_n {FEC_MAX_N}: "
        f"{int((got.counts > 0).sum())} clusters in {sweeps} sweeps, {fec_s:.3f} s; labels and counts equal with "
        f"B5's plain version; B5 launches {launches}; neighbour rows differing (1-ulp rule) {n_rows} [{card}]")
    log(f"   B5 knn (1, {FEC_POINTS}) self, k {FEC_MAX_N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events); "
        f"grid {-(-FEC_POINTS // nn.KNN_QUERIES_PER_BLOCK)} blocks on {sms} SMs (nn1's scan_plan at this shape: "
        f"{blocks} blocks of {warps} warps, {queries} queries a thread) [{card}]")
    log_bound(rec)
    return launches, {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")} | {
        "launches": launches, "shape": [1, FEC_POINTS, FEC_POINTS], "k": FEC_MAX_N}


def build_map_split(dev, scans: list, labels: list) -> dict:
    """build-map's work on each scan stage by stage, synchronized after
    each (the CLI's steps for ``--dataset raw``): ms medians of reading the
    files and padding, the transfer, DCVC, the rest of ``build_graph`` and
    the JSON write."""
    import tempfile

    from sgtd_tpu_torch.config import DcvcConfig, SGTDConfig
    from sgtd_tpu_torch.graph import build
    from sgtd_tpu_torch.io import readers
    from sgtd_tpu_torch.io.graph_json import write_graph_json

    n_max, caps = DcvcConfig().max_points, SGTDConfig().caps
    ms = {k: [] for k in ("read_and_pad", "to_device", "dcvc", "rest_of_build_graph", "write_json")}
    dcvc_ms = []

    def timed_dcvc(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dcvc_cluster(*a, **k)
        torch.cuda.synchronize()
        dcvc_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    dcvc_cluster = build.dcvc_cluster
    with tempfile.TemporaryDirectory() as out_dir, mock.patch.object(build, "dcvc_cluster", timed_dcvc):
        for sp, lp in zip(scans, labels):
            t = [time.perf_counter()]

            def tick(name):
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                ms[name].append((t[-1] - t[-2]) * 1e3)

            pts = readers.read_bin(sp)[:, :3]
            sem, inst = readers.read_label(lp)
            arrays = [np.zeros((n_max, 3), np.float32), np.zeros(n_max, np.int32), np.zeros(n_max, np.int32),
                      np.zeros(n_max, bool)]
            for a, v in zip(arrays, (pts, sem, inst, True)):
                a[: len(pts)] = v
            tick("read_and_pad")
            tensors = [torch.from_numpy(a).to(dev) for a in arrays]
            tick("to_device")
            g = build.build_graph(*tensors, np.eye(4, dtype=np.float32), caps)
            tick("rest_of_build_graph")
            write_graph_json(os.path.join(out_dir, "g.json"), g)
            tick("write_json")
            ms["dcvc"].append(dcvc_ms[-1])
            ms["rest_of_build_graph"][-1] -= dcvc_ms[-1]
    return {k: statistics.median(v) for k, v in ms.items()}


def frontend(dev, card: str):
    """Phase 9: the front end on the card. Returns (B5's launches on FEC's
    path, B5's record at FEC's shape)."""
    import contextlib
    import io
    import tempfile

    from sgtd_tpu_torch import cli
    from sgtd_tpu_torch.cluster import dcvc
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.eval import runner
    from sgtd_tpu_torch.graph.types import stack_graphs
    from sgtd_tpu_torch.io.graph_json import read_graph_dir
    from sgtd_tpu_torch.match.pipeline import localize
    from sgtd_tpu_torch.match.search import TRUNC_SCAN

    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    world = front_world()
    with tempfile.TemporaryDirectory(prefix="sgtd_front_") as root:
        t0 = time.perf_counter()
        files = write_front_world(root, world)
        n_pts = [os.path.getsize(os.path.join(files["map_scans"], f)) // 16 for f in os.listdir(files["map_scans"])]
        log(f"phase 9 world (make_world seed {FRONT_SEED}, {len(world.instance_xyz)} instances): {FRONT_MAP} map and "
            f"{FRONT_QUERIES} query labeled scans of {min(n_pts)}-{max(n_pts)} points written in "
            f"{time.perf_counter() - t0:.2f} s (host)")

        # build-map in processes of their own, map and queries side by side.
        t0 = time.perf_counter()
        procs = {side: subprocess.Popen(
            [sys.executable, "-m", "sgtd_tpu_torch.cli", "build-map", "--scans", files[f"{side}_scans"],
             "--labels", files[f"{side}_labels"], "--dataset", "raw", "--poses", files[f"{side}_poses"],
             "--out", files[f"{side}_graphs"]],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for side in ("map", "query")}
        for side, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"CLI build-map ({side}): exit {proc.returncode}\n{err[-3000:]}")
        log(f"CLI build-map, map and queries side by side: {time.perf_counter() - t0:.2f} s of wall time")
        cfg = SGTDConfig()
        graphs = {side: read_graph_dir(files[f"{side}_graphs"], cfg, dev) for side in ("map", "query")}
        if [len(graphs["map"]), len(graphs["query"])] != [FRONT_MAP, FRONT_QUERIES]:
            fail(f"build-map wrote {len(graphs['map'])} map and {len(graphs['query'])} query graphs")

        front_reference_gate(files["map_graphs"], card)
        share, total = front_world_gate(world, files["seen"], graphs)
        if share < 0.95:
            fail(f"build-map: {share:.4f} of {total} rendered instances have a node within 0.1 m (gate 0.95)")
        log(f"build-map against the rendered world: {share:.4f} of {total} instances have a node of their label "
            f"within 0.1 m (gate 0.95)")

        # The port's localize on the graphs the port built.
        index = runner.build_map_index(graphs["map"], cfg, dev)
        q = stack_graphs(graphs["query"], dev)
        trunc = int(((localize(index.db, q, index.config).truncated & TRUNC_SCAN) != 0).sum())
        reset_counts()
        out = runner.evaluate(index, graphs["query"], batch_size=FRONT_QUERIES)
        counts = read_counts()
        if trunc or out["success_rate"] < SR_GATE or min(counts[:3]) < 1:
            fail(f"localize on the built graphs: SR {out['success_rate']}, {trunc} TRUNC_SCAN, launches {counts}")
        log(f"localize on the built graphs: SR {out['success_rate']:.4f} (gate {SR_GATE}), R@1 {out['recall_at_1']}, "
            f"TRUNC_SCAN 0, {out['db_rows']} DB rows, launches (B1-B8) {counts} [{card}]")

        # A local map of the first keyframes, in process, timed.
        sub = os.path.join(root, "local")
        for kind in ("scans", "labels"):
            os.makedirs(os.path.join(sub, kind))
            for f in sorted(os.listdir(files[f"map_{kind}"]))[:FRONT_LOCAL_FRAMES]:
                os.symlink(os.path.join(files[f"map_{kind}"], f), os.path.join(sub, kind, f))
        np.savetxt(os.path.join(sub, "poses.txt"), world.map_poses[:FRONT_LOCAL_FRAMES, :3, :].reshape(-1, 12))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["build-map", "--scans", os.path.join(sub, "scans"), "--labels", os.path.join(sub, "labels"),
                      "--dataset", "raw", "--poses", os.path.join(sub, "poses.txt"), "--local-map-radius",
                      str(FRONT_LOCAL_RADIUS_M), "--out", os.path.join(sub, "graphs"), "--device", str(dev)])
        local_s = time.perf_counter() - t0
        local = read_graph_dir(os.path.join(sub, "graphs"), cfg, "cpu")
        n_local = [int(g.mask.sum()) for g in local]
        n_single = [int(g.mask.sum()) for g in graphs["map"][:FRONT_LOCAL_FRAMES]]
        if len(local) != FRONT_LOCAL_FRAMES or any(a < b for a, b in zip(n_local, n_single)):
            fail(f"local map: nodes {n_local} against single scans {n_single}")
        log(f"local map (radius {FRONT_LOCAL_RADIUS_M} m) of {FRONT_LOCAL_FRAMES} keyframes: {local_s:.2f} s in "
            f"process; nodes {sum(n_local)} against {sum(n_single)} single-scan, none fewer [{card}]")

        # build-map in process, three passes over the map scans.
        times, sweeps = [], []
        for k in range(3):
            dcvc.ITERATIONS = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
                cli.main(["build-map", "--scans", files["map_scans"], "--labels", files["map_labels"], "--dataset",
                          "raw", "--poses", files["map_poses"], "--out", os.path.join(root, f"pass{k}"),
                          "--device", str(dev)])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            sweeps.append(dcvc.ITERATIONS / FRONT_MAP)
        log(f"build-map in process: {FRONT_MAP / statistics.median(times):.2f} scans/s (median of 3 passes over "
            f"{FRONT_MAP} scans: {', '.join(f'{t:.3f}' for t in times)} s, file reads and JSON writes included); "
            f"DCVC sweeps a scan {sweeps[0]:.2f} [{card}]")
        split = build_map_split(dev, *(sorted(os.path.join(files[f"map_{k}"], f) for f in os.listdir(files[f"map_{k}"]))
                                       for k in ("scans", "labels")))
        log("build-map a scan, ms (median over the map scans, synchronized per stage): "
            + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f"; total {sum(split.values()):.2f} [{card}]")
        out = fec_on_b5(dev, card, os.path.join(files["map_scans"], "000000.bin"),
                        os.path.join(files["map_labels"], "000000.label"))
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 10: the back end and multi-session SLAM on the card.


def circle_poses(n: int, radius: float) -> np.ndarray:
    """tests/test_pgo.py's ``_circle_poses``: n poses on a circle, each
    heading along it."""
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = c, -s, s, c
    T[:, 0, 3], T[:, 1, 3] = radius * np.cos(th), radius * np.sin(th)
    return T


def se3_exp_np(xi) -> np.ndarray:
    """The port's float32 se(3) exp of (..., 6) on the host."""
    from sgtd_tpu_torch.geom import se3

    return se3.se3_exp(torch.tensor(np.asarray(xi, np.float32))).numpy()


def to_dev(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def pgo_problem(n: int, dev):
    """tests/test_pgo.py::test_pgo_cg_large_graph's graph at n nodes: a
    300 m circle, odometry drifting by PGO_DRIFT a step, a loop of weight
    10 to node 0 every n / 32 nodes. (PoseGraph on ``dev``, truth, odometry)."""
    from sgtd_tpu_torch.backend.pgo import chain_with_loops

    gt = circle_poses(n, 300.0)
    rels = np.linalg.inv(gt[:-1]) @ gt[1:]
    drift = se3_exp_np(PGO_DRIFT)
    odom = np.empty_like(gt)
    odom[0] = gt[0]
    for i in range(n - 1):
        odom[i + 1] = odom[i] @ rels[i] @ drift
    li = np.arange(n // 32, n, n // 32)
    lt = (np.linalg.inv(gt[li]) @ gt[0]).astype(np.float32)
    pg = chain_with_loops(*to_dev(dev, odom, li, np.zeros_like(li), lt, np.full(len(li), 10.0, np.float32)))
    return pg, gt, odom


def ba_problem(rng, f_n: int, l_n: int, o_n: int, dev, yaw_step: float, pose_noise: float, lm_noise: float):
    """tests/test_ba.py's problems (its vectorized generator,
    ``_make_problem_vec``): keyframes 5 m apart on a line, yawing by
    ``yaw_step`` each, landmarks scattered around them, each seen
    noise-free by its ``o_n`` nearest keyframes; every pose but the anchored
    first perturbed by exp(N(0, pose_noise)), every landmark by N(0,
    lm_noise). (BAProblem on ``dev``, true poses)."""
    from sgtd_tpu_torch.backend.ba import BAProblem

    gt = np.tile(np.eye(4, dtype=np.float32), (f_n, 1, 1))
    th = yaw_step * np.arange(f_n, dtype=np.float32)
    gt[:, 0, 3] = np.arange(f_n, dtype=np.float32) * 5.0
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = np.cos(th), -np.sin(th), np.sin(th), np.cos(th)
    lms = np.column_stack([rng.uniform(-5, f_n * 5 + 5, l_n), rng.uniform(-15, 15, l_n),
                           rng.uniform(0, 5, l_n)]).astype(np.float32)
    d = np.linalg.norm(gt[None, :, :3, 3] - lms[:, None], axis=-1)  # (L, F)
    near = np.argpartition(d, o_n - 1, axis=1)[:, :o_n]
    obs_frame = np.take_along_axis(near, np.argsort(np.take_along_axis(d, near, 1), axis=1), 1).astype(np.int32)
    P = gt[obs_frame]
    obs_local = np.einsum("loji,loj->loi", P[..., :3, :3], lms[:, None, :] - P[..., :3, 3]).astype(np.float32)
    xi = rng.normal(0, pose_noise, (f_n, 6)).astype(np.float32)
    xi[0] = 0.0
    init = gt @ se3_exp_np(xi)
    init_lms = lms + rng.normal(0, lm_noise, (l_n, 3)).astype(np.float32)
    anchor = np.zeros(f_n, bool)
    anchor[0] = True
    return BAProblem(*to_dev(dev, init, init_lms, obs_frame, obs_local, np.ones((l_n, o_n), bool), anchor)), gt


def session_inputs(world, observe, cfg, n: int):
    """A drifting session of ``n`` scans at map keyframes 0..n-1 of
    ``world``: the scans' graphs (``observe``, from SESSION_SEED, with
    SESSION_OBS), their true poses (float64) and the odometry, each relative
    motion followed by exp(SESSION_DRIFT) (tests/test_multisession.py's
    construction). ``observe`` is the port's or, for the reference's run,
    sgtd_tpu's (the generators are bit-identical)."""
    rng = np.random.default_rng(SESSION_SEED)
    gt = np.asarray(world.map_poses[:n], np.float64)
    drift = se3_exp_np(SESSION_DRIFT).astype(np.float64)
    odom = [gt[0]]
    for i in range(1, n):
        odom.append(odom[-1] @ (np.linalg.inv(gt[i - 1]) @ gt[i]) @ drift)
    graphs = [observe(world, p, cfg, rng, **SESSION_OBS) for p in gt]
    return graphs, gt, np.stack(odom)


def pose_gaps(a: torch.Tensor, b: torch.Tensor):
    """Largest translation (m) and rotation-entry gaps between (N, 4, 4) poses."""
    d = (a.double() - b.double()).abs()
    return float(d[:, :3, 3].max()), float(d[:, :3, :3].max())


def check_session(name: str, res, gt, odom, reference=None) -> None:
    """tests/test_multisession.py's gates on a corrected session, and
    ``reference``'s loop decisions where one is given."""
    s_n = len(gt)
    before = float(np.linalg.norm(odom[-1, :3, 3] - gt[-1, :3, 3]))
    errs = np.linalg.norm(res.poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    got = {"num_loops": res.num_loops, "loop_frames": tuple(int(f) for f in res.loop_frames)}
    log(f"   {name}: {res.num_loops}/{s_n} loops, loop frames {list(got['loop_frames'])}; odometry end error "
        f"{before:.4f} m -> corrected max error {errs.max():.4f} m (mean {errs.mean():.4f})")
    if not before > 1.0:
        fail(f"{name}: the odometry's end error {before:.4f} m is no drift")
    if res.num_loops < s_n // 2 or errs.max() >= 1.0 or not np.isfinite(res.poses).all():
        fail(f"{name}: {res.num_loops} loops (at least {s_n // 2}) or a pose 1.0 m or more off ({errs.max():.4f})")
    if reference is not None and got != reference:
        fail(f"{name}: loops {got} differ from the JAX reference's {reference}")


def backend_path(dev, card: str, bench, large) -> dict:
    """Phase 10: PGO and BA at the reference tests' sizes and the session
    correction on phases 3 and 5's maps (``bench``, ``large``: tuned
    config, DB, world). Returns the calls whose device activities the
    final profiling session counts: one GN step of PGO-CG and of BA-CG with
    one and with two CG iterations."""
    from sgtd_tpu_torch.backend import ba, pgo
    from sgtd_tpu_torch.data.synthetic import observe
    from sgtd_tpu_torch.slam import localize_and_optimize_session, multisession

    t_phase = time.perf_counter()
    end_err = lambda poses, gt: float(np.linalg.norm(np.asarray(poses)[-1, :3, 3] - gt[-1, :3, 3]))

    # PGO-CG at 4,096 nodes, twice: the same bits.
    pg, gt, odom = pgo_problem(PGO_NODES, dev)
    run = lambda: pgo.optimize_pose_graph_cg(pg, iterations=PGO_GN, cg_iterations=PGO_CG)
    (a, s_a), (b, s_b) = synced_s(run), synced_s(run)
    before, after = end_err(odom, gt), end_err(a.cpu(), gt)
    log(f"PGO-CG {PGO_NODES} nodes, {PGO_GN} GN steps x {PGO_CG} CG iterations: {s_a:.3f} s, again {s_b:.3f} s; "
        f"end error {before:.4f} -> {after:.4f} m [{card}]")
    if not torch.equal(a, b):
        fail("PGO-CG: two runs on the same graph gave different bits")
    if not (bool(torch.isfinite(a).all()) and after < 0.2 * before):
        fail(f"PGO-CG: end error {after:.4f} m not below 0.2 of the drift's {before:.4f} m")

    # Dense PGO at 1,024 nodes, the largest the session sends to it, held
    # to the same function on float64 tensors: at this size the float32
    # LU solve with its 1e8 anchor weight is itself off by ~2 cm (the JAX
    # reference's by 1.5e-2 m, the port's by 2.15e-2 m on the CPU), and 300
    # CG iterations stop metres short of convergence (printed).
    pg1, gt1, odom1 = pgo_problem(PGO_DENSE_NODES, dev)
    dense, s_dense = synced_s(lambda: pgo.optimize_pose_graph(pg1, iterations=PGO_GN))
    pg64 = pg1._replace(poses=pg1.poses.double(), t_meas=pg1.t_meas.double(), weight=pg1.weight.double())
    d64, s_64 = synced_s(lambda: pgo.optimize_pose_graph(pg64, iterations=PGO_GN))
    cg1, s_cg1 = synced_s(lambda: pgo.optimize_pose_graph_cg(pg1, iterations=PGO_GN, cg_iterations=PGO_CG))
    g64, gcg = pose_gaps(dense, d64), pose_gaps(dense, cg1)
    before1, after1 = end_err(odom1, gt1), end_err(dense.cpu(), gt1)
    log(f"dense PGO {PGO_DENSE_NODES} nodes, {PGO_GN} GN steps: {s_dense:.3f} s (float64 {s_64:.3f} s, PCG at "
        f"{PGO_CG} iterations {s_cg1:.3f} s); end error {before1:.4f} -> {after1:.4f} m; from float64 "
        f"{g64[0]:.3e} m / {g64[1]:.3e}, from PCG {gcg[0]:.3e} m / {gcg[1]:.3e} [{card}]")
    if not (bool(torch.isfinite(dense).all()) and after1 < 0.2 * before1):
        fail(f"dense PGO: end error {after1:.4f} m not below 0.2 of the drift's {before1:.4f} m")
    if g64[0] >= DENSE_F64_TOL[0] or g64[1] >= DENSE_F64_TOL[1]:
        fail(f"dense PGO: {g64} from the float64 solve, beyond {DENSE_F64_TOL}")

    # BA-CG at 5,000 keyframes, twice: the same bits.
    prob, gt_ba = ba_problem(np.random.default_rng(SEED + 10), *BA_LARGE, dev, 0.02, 0.05, 0.2)
    run = lambda: ba.optimize_ba_cg(prob, iterations=BA_GN, cg_iterations=BA_CG)
    (r1, s1), (r2, s2) = synced_s(run), synced_s(run)
    costs = r1.costs.cpu().numpy()
    t_err = np.linalg.norm(r1.poses.cpu().numpy()[:, :3, 3] - gt_ba[:, :3, 3], axis=1)
    log(f"BA-CG {BA_LARGE[0]} keyframes x {BA_LARGE[1]} landmarks x {BA_LARGE[2]} observations, {BA_GN} GN steps x "
        f"{BA_CG} CG iterations: {s1:.3f} s, again {s2:.3f} s; cost {costs[0]:.4e} -> {costs[-1]:.4e}, median "
        f"translation error {np.median(t_err):.4f} m [{card}]")
    if not all(torch.equal(x, y) for x, y in zip(r1, r2)):
        fail("BA-CG: two runs on the same problem gave different bits")
    if not (costs[-1] < 1e-2 * costs[0] and np.median(t_err) < 0.05):
        fail(f"BA-CG: cost {costs[0]:.4e} -> {costs[-1]:.4e} or median error {np.median(t_err):.4f} m")

    # Dense BA on test_ba.py's 6-keyframe problem, against BA-CG.
    small, _ = ba_problem(np.random.default_rng(SEED + 11), 6, 40, 6, dev, 0.1, 0.1, 0.3)
    dba, s_dba = synced_s(lambda: ba.optimize_ba(small, iterations=6))
    cba = ba.optimize_ba_cg(small, iterations=6, cg_iterations=200)
    gap = max(float((x - y).abs().max()) for x, y in ((dba.poses, cba.poses), (dba.landmarks, cba.landmarks)))
    log(f"dense BA 6 keyframes x 40 landmarks x 6, 6 GN steps: {s_dba:.3f} s; {gap:.3e} from BA-CG (gate 2e-3)")
    if not gap < 2e-3:
        fail(f"dense BA: {gap:.3e} from BA-CG")

    # The session correction on the bench world: B1-B3 on the path.
    cfg, db, world = bench
    graphs, gt_s, odom_s = session_inputs(world, observe, cfg, SESSION_SCANS)
    reset_counts()
    res, s_sess = synced_s(lambda: localize_and_optimize_session(db, graphs, odom_s, cfg))
    counts = read_counts()
    nodes = db.frame_poses.shape[0] + SESSION_SCANS
    log(f"session correction on the bench world ({SESSION_SCANS} scans, {nodes} nodes, dense): {s_sess:.3f} s; "
        f"kernel launches (B1-B8) {counts} [{card}]")
    check_session("bench world session", res, gt_s, odom_s, REFERENCE_SESSION)
    if min(counts[:3]) <= 0:
        fail(f"bench world session: B1-B3 must launch: {counts}")

    # The session correction on the 5,000-keyframe map: PCG, B6 in B1's place.
    cfg5, db5, world5 = large
    graphs5, gt5, odom5 = session_inputs(world5, observe, cfg5, SESSION_SCANS_5K)
    nodes5 = db5.frame_poses.shape[0] + SESSION_SCANS_5K
    if nodes5 <= multisession.DENSE_MAX_NODES:
        fail(f"large-map session: {nodes5} nodes do not take the PCG solver")
    reset_counts()
    res5, s5 = synced_s(lambda: localize_and_optimize_session(db5, graphs5, odom5, cfg5))
    counts5 = read_counts()
    log(f"session correction on the {db5.frame_poses.shape[0]}-keyframe map ({SESSION_SCANS_5K} scans, {nodes5} "
        f"nodes, PCG): {s5:.3f} s; kernel launches (B1-B8) {counts5} [{card}]")
    check_session("large-map session", res5, gt5, odom5)
    if counts5[0] != 0 or counts5[5] <= 0 or min(counts5[1:3]) <= 0:
        fail(f"large-map session: B2, B3 and B6 must launch and B1 must not: {counts5}")
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")

    return {
        "PGO-CG, 1 iteration": lambda: pgo.optimize_pose_graph_cg(pg, iterations=1, cg_iterations=1),
        "PGO-CG, 2 iterations": lambda: pgo.optimize_pose_graph_cg(pg, iterations=1, cg_iterations=2),
        "BA-CG, 1 iteration": lambda: ba.optimize_ba_cg(prob, iterations=1, cg_iterations=1),
        "BA-CG, 2 iterations": lambda: ba.optimize_ba_cg(prob, iterations=1, cg_iterations=2),
    }, {"problem": prob, "gt": gt_ba, "result": r1}


def check_localizer_leg(name: str, got: dict, single, gts, cfg, exact: bool, digest: str | None = None) -> None:
    """Phase 11's gates on one localizer leg's outputs against the
    single-device ``single`` (LocalizationResult of the same queries).
    ``exact``: frames, votes, found and best frame equal and accepted
    candidates' poses within POS_TOL_M (one shard); else the votes sorted
    bit-identical, found equal and every top pose within the success gates."""
    from sgtd_tpu_torch.eval.metrics import rpe
    from sgtd_tpu_torch.match.search import TRUNC_SCAN

    host = {f: getattr(single, f).cpu().numpy() for f in single._fields}
    n_trunc = int(((got["truncated"] & TRUNC_SCAN) != 0).sum())
    if n_trunc:
        fail(f"{name}: {n_trunc} queries flagged TRUNC_SCAN")
    if exact:
        for f in ("frames", "votes", "found", "best_frame"):
            if not np.array_equal(got[f], host[f]):
                fail(f"{name}: {f} differ from the single-device localize")
        ok = host["scores"] >= 0
        gap = float(np.abs(got["poses"][ok] - host["poses"][ok]).max())
        if not gap <= POS_TOL_M:
            fail(f"{name}: accepted candidates' poses {gap:.3e} from the single-device localize (gate {POS_TOL_M})")
        log(f"   {name}: frames, votes, found, best_frame equal to the single-device localize; poses within "
            f"{gap:.3e}")
        return
    if not np.array_equal(np.sort(got["votes"], -1), np.sort(host["votes"], -1)):
        fail(f"{name}: sorted votes differ from the single-device localize's")
    if not np.array_equal(got["found"], host["found"]):
        fail(f"{name}: found differs from the single-device localize's on queries "
             f"{np.flatnonzero(got['found'] != host['found']).tolist()}")
    errs = [rpe(np.asarray(gt), est) for gt, est in zip(gts, got["poses"][:, 0])]
    worst = max(errs)
    if not all(t < cfg.success_trans_m and r < cfg.success_rot_deg for t, r in errs):
        fail(f"{name}: a top pose beyond {cfg.success_trans_m} m / {cfg.success_rot_deg} deg: {worst}")
    line = f"   {name}: votes sorted bit-identical, found equal, TRUNC_SCAN 0, worst top pose {worst[0]:.3f} m"
    if digest is not None:
        got_digest = found_frames_sha256(got["found"], got["best_frame"])
        if got_digest != digest:
            fail(f"{name}: sha256 of found and best_frame {got_digest} differs from the JAX reference's {digest}")
        line += f"; sha256 {got_digest[:8]}... = REFERENCE_SHARDED"
    log(line)


def check_ba_leg(name: str, got: dict, gt, phase10) -> None:
    """Phase 10's BA gates on a sharded BA leg, and its gap to phase 10's BA-CG."""
    costs = got["costs"]
    t_err = np.linalg.norm(got["poses"][:, :3, 3] - gt[:, :3, 3], axis=1)
    gap = max(float(np.abs(got[f] - getattr(phase10, f).cpu().numpy()).max()) for f in ("poses", "landmarks"))
    log(f"   {name}: cost {costs[0]:.4e} -> {costs[-1]:.4e}, median translation error {np.median(t_err):.4f} m; "
        f"largest gap to phase 10's BA-CG {gap:.3e}")
    if not (np.isfinite(got["poses"]).all() and costs[-1] < 1e-2 * costs[0] and np.median(t_err) < 0.05):
        fail(f"{name}: cost {costs[0]:.4e} -> {costs[-1]:.4e} or median error {np.median(t_err):.4f} m")


def log_world(name: str, summary: dict, card: str) -> None:
    log(f"{name}: {summary['world']} rank(s), {summary['backend']}, start-up {summary['startup_s']:.2f} s [{card}]")
    for leg, ranks in summary["legs"].items():
        if not ranks[0]:
            continue
        secs = [r["seconds"] for r in ranks]
        coll = [r["collective_s"] for r in ranks]
        first = f", first pass {max(r['first_s'] for r in ranks):.3f} s" if "first_s" in ranks[0] else ""
        log(f"   {leg}: {max(secs):.3f} s (slowest rank; fastest {min(secs):.3f}{first}), "
            f"load {max(r['load_s'] for r in ranks):.2f} s, "
            f"collectives {ranks[0]['collective_calls']} calls a rank, {max(coll):.3f} s "
            f"(share {max(c / s for c, s in zip(coll, secs)):.3f} of the slowest), launches B1-B8 of rank 0 "
            f"{ranks[0]['launches']}")


def multi_device(card: str, bench, bench_run: dict, large, large_run: dict, ba_run: dict, num_map: int) -> dict:
    """Phase 11: the multi-device paths, each rank a process on this card
    (``parallel.multihost_check.run_world``), on phase 3's and phase 5's DBs
    and phase 10's BA problem written under build/phase11. World A: NCCL,
    one rank; world B: gloo, 8 ranks (NCCL takes one rank a card, which a
    2-rank NCCL world shows first). Returns every rank's launches (B1-B8)
    on world B's localizer legs."""
    from sgtd_tpu_torch.eval.metrics import success_rate
    from sgtd_tpu_torch.graph.types import SemanticGraph
    from sgtd_tpu_torch.match.pipeline import LocalizationResult
    from sgtd_tpu_torch.parallel.multihost_check import read_outputs, run_world, write_inputs

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase11")
    shutil.rmtree(root, ignore_errors=True)
    cat = lambda parts: type(parts[0])(*(torch.cat(xs) for xs in zip(*parts)))
    head = lambda t, n: type(t)(*(x[:n] for x in t))
    cfg, db, _ = bench
    graphs, single = cat(bench_run["chunks"]), cat(bench_run["results"])
    cfg5, db5, _ = large
    single5 = cat(large_run["results"])
    t0 = time.perf_counter()
    write_inputs(os.path.join(root, "bench64"), db=db, graphs=graphs, config=cfg)
    write_inputs(os.path.join(root, "bench16"), db=db, graphs=head(graphs, SHARDED_QUERIES), config=cfg)
    write_inputs(os.path.join(root, "large"), db=db5, graphs=large_run["graphs"], config=cfg5)
    write_inputs(os.path.join(root, "ba"), ba=ba_run["problem"])
    log(f"phase 11 inputs written in {time.perf_counter() - t0:.2f} s ({db.keys.shape[0]} and {db5.keys.shape[0]} "
        f"DB rows, BA {tuple(ba_run['problem'].obs_frame.shape)} observations)")
    torch.cuda.empty_cache()
    gt_ba = ba_run["gt"]
    ba_leg = f"ba:{BA_GN}:{BA_CG}@ba"

    # World A: NCCL, one rank. Every collective is the identity and the
    # pair quota whole: the single-device results, exactly.
    legs_a = [f"sharded:1x1:{CHUNK}@bench64", f"ring:{CHUNK}@bench64", ba_leg]
    out_a = os.path.join(root, "out_a")
    sa = run_world(1, "nccl", "cuda:0", root, legs_a, timeout=600, outputs=out_a)
    log_world("world A", sa, card)
    for leg in legs_a[:2]:
        check_localizer_leg(f"A {leg}", read_outputs(out_a, leg), single, bench_run["gts"], cfg, exact=True)
        if min(r["launches"][i] for r in sa["legs"][leg_key(leg)] for i in range(3)) <= 0:
            fail(f"A {leg}: B1-B3 must launch: {[r['launches'] for r in sa['legs'][leg_key(leg)]]}")
    check_ba_leg(f"A {ba_leg}", read_outputs(out_a, ba_leg), gt_ba, ba_run["result"])

    # NCCL refuses two ranks on one card: shown, not gated.
    try:
        with mock.patch.dict(os.environ, {"NCCL_DEBUG": "WARN"}):
            run_world(2, "nccl", "cuda:0", root, ["ping"], timeout=120, outputs=os.path.join(root, "out_dup"))
        log("NCCL, two ranks on one card: the world ran")
    except (RuntimeError, TimeoutError) as err:
        lines = [ln.strip() for ln in str(err).splitlines() if "Duplicate GPU" in ln]
        lines += [ln.strip() for ln in str(err).splitlines() if "NCCL error" in ln]
        log(f"NCCL, two ranks on one card: refused ({type(err).__name__}): {(lines or [str(err).splitlines()[0]])[0]}")

    # World B: gloo, 8 ranks on this card (the reference tests' 8 devices).
    leg_a, leg_b, leg_c = "sharded:2x4@bench16", "ring@bench16", f"sharded:1x8:{SCALE_CHUNK}@large"
    out_b = os.path.join(root, "out_b")
    sb = run_world(8, "gloo", "cuda:0", root, [leg_a, leg_b, leg_c, ba_leg], timeout=900, outputs=out_b)
    log_world("world B", sb, card)
    single16 = LocalizationResult(*(x[:SHARDED_QUERIES] for x in single))
    gts16 = bench_run["gts"][:SHARDED_QUERIES]
    check_localizer_leg(f"B {leg_a}", read_outputs(out_b, leg_a), single16, gts16, cfg, exact=False,
                        digest=REFERENCE_SHARDED["sha256"])
    check_localizer_leg(f"B {leg_b}", read_outputs(out_b, leg_b), single16, gts16, cfg, exact=False)
    got_c = read_outputs(out_b, leg_c)
    host5 = {f: getattr(single5, f).cpu().numpy() for f in ("votes", "found")}
    if int((got_c["truncated"] & 1).sum()) or not np.array_equal(np.sort(got_c["votes"], -1),
                                                                  np.sort(host5["votes"], -1)):
        fail(f"B {leg_c}: TRUNC_SCAN set or sorted votes differ from phase 5's")
    sr = success_rate(large_run["gts"], got_c["poses"][:, 0], got_c["found"], cfg5)
    differ = np.flatnonzero(got_c["found"] != host5["found"]).tolist()
    log(f"   B {leg_c} ({num_map} keyframes): votes sorted bit-identical to phase 5's, TRUNC_SCAN 0, SR {sr:.4f}; "
        f"queries whose found differs from phase 5's (a pair quota of "
        f"{max(cfg5.caps.pairs_per_candidate // 8, 1)} a shard): {differ}")
    if sr < SR_GATE:
        fail(f"B {leg_c}: success rate {sr:.4f} below {SR_GATE}")
    check_ba_leg(f"B {ba_leg}", read_outputs(out_b, ba_leg), gt_ba, ba_run["result"])
    launches = {leg: [r["launches"] for r in sb["legs"][leg_key(leg)]] for leg in (leg_a, leg_b, leg_c)}
    for leg, need in ((leg_a, (0, 1, 2)), (leg_b, (0, 1, 2)), (leg_c, (5, 1, 2))):
        if min(n[i] for n in launches[leg] for i in need) <= 0:
            fail(f"B {leg}: every rank must launch B{', B'.join(str(i + 1) for i in need)}: {launches[leg]}")
    log(f"   every rank launched B1-B3 on {leg_a} and {leg_b}, B6, B2 and B3 on {leg_c}")
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return launches


def leg_key(leg: str) -> str:
    from sgtd_tpu_torch.parallel.multihost_check import Leg

    return Leg.parse(leg).name


def ptxas_usage(text: str) -> list:
    """'entry: Used N registers, ...' for each kernel in nvcc's -Xptxas -v
    output (mangled entry names)."""
    out, entry, spills = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        elif "spill stores" in ln:
            spills = ln.strip()
        elif "Used" in ln and entry:
            out.append(f"{entry}: {ln.split('Used', 1)[1].strip()}; {spills}")
            entry = None
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale-frames", type=int, default=5000,
                        help="keyframes of phase 5's large map (default 5000)")
    parser.add_argument("--baseline", metavar="TREE", action="append",
                        help="another tree of the port (e.g. the parent commit unpacked under build/): "
                             "phase 2 also times its wrappers and its kernel bodies against this tree's, in "
                             "turns; may be given several times (wrappers: the first tree's only)")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 2 and the --baseline comparison (which then skips the host "
                             "costs): no path is driven and no result line is printed")
    parser.add_argument("--sass", metavar="FILE",
                        help="write the SASS of the built kernel library (cuobjdump -sass) to FILE")
    parser.add_argument("--host-cost-of", metavar="TREE",
                        help="only measure the wrappers' host costs of the port's tree at TREE and print "
                             "them as one JSON line (what --baseline runs, a process a reading)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a card")
    if args.host_cost_of:
        sys.path.insert(0, os.path.abspath(args.host_cost_of))
    from sgtd_tpu_torch.ops import _build
    from sgtd_tpu_torch.utils import disable_tf32

    dev = torch.device("cuda", 0)
    if args.host_cost_of:
        print(json.dumps({"lib": str(_build.build()), "host_us": host_costs(dev)}), flush=True)
        return
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
    log("ptxas: " + " | ".join(ptxas_usage(path.with_suffix(".log").read_text())))
    if args.sass:
        with open(args.sass, "w") as f:
            subprocess.run([shutil.which("cuobjdump") or CUOBJDUMP_DEFAULT, "-sass", str(path)], stdout=f, check=True)
        log(f"SASS of {path.name} written to {args.sass}")

    records = check_kernels(dev, card)
    costs = host_costs(dev)
    for rec in records:
        rec["host_us"] = costs[rec["name"]]
    records[7]["library_host_us"] = costs["index_select"]
    log(f"host cost of a call, us (host clock over {HOST_COST_CALLS} back-to-back calls on tiny inputs, one "
        f"synchronize at the end, least of {HOST_COST_ROUNDS} rounds): "
        + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()) + f" [{card}]")
    old_probe, votes_libs = None, []
    if args.baseline:
        old_probe, votes_libs = compare_baselines(dev, card, args.baseline, with_host_costs=not args.kernels_only)
    if args.kernels_only:
        log_frame_votes_activities(dev, card, old_probe)
        log(f"--kernels-only: stopping after phase 2 ({time.perf_counter() - T_START:.1f} s)")
        return
    b8_launches, ctx, bench_results = main_path(dev, card)
    bench = ctx[:3]
    bench_run = {"chunks": ctx[4], "gts": [g.pose for g in ctx[3]], "results": bench_results}
    launches, map_knn_launches, *refined = refined_path(dev, card, *ctx, votes_libs=votes_libs)
    del ctx
    # Phase 7's oracle (plain Python on the host, about a minute on one of
    # the host's cores) runs in a worker process of its own beside phases
    # 5-8 and is read after phase 8.
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        oracle = pool.submit(oracle_subsample, ORACLE_QUERIES)
        b6_launches, large, large_run = large_map(dev, card, args.scale_frames)
        b7_launches = fused_path(dev, card, *refined)
        del refined
        torch.cuda.empty_cache()
        pipeline_ok = hard_world(dev, card)
        b5_vgicp_launches = cli_on_files(dev, card)
        fec_launches, fec_rec = frontend(dev, card)
        oracle_gate(oracle, pipeline_ok)
    cg_calls, ba_run = backend_path(dev, card, bench, large)
    multi_launches = multi_device(card, bench, bench_run, large, large_run, ba_run, args.scale_frames)
    # Launches on the path that runs each kernel: B1-B5 the refined main
    # path (phase 4), B6 the large map (phase 5), B7 the fused refined
    # path (phase 6); B8, which no module calls, the row-gather drive at
    # the end of phase 3.
    launches += [b6_launches, b7_launches, b8_launches]
    for rec, n in zip(records, launches):
        rec["launches"] = n
    records[4]["map"]["launches"] = map_knn_launches
    records[4]["vgicp_launches"] = b5_vgicp_launches
    records[4]["fec_launches"] = fec_launches
    records[4]["fec"] = fec_rec
    # Phase 11's launches a rank on the multi-device legs, of B1-B3 and B6.
    for i in (0, 1, 2, 5):
        records[i]["multi_device_launches"] = {leg: [n[i] for n in ranks] for leg, ranks in multi_launches.items()}
    # After every timed phase, so that none runs under or after a
    # profiling session.
    log_frame_votes_activities(dev, card, old_probe, cg_calls)
    for name in ("cli", "io.readers", "io.graph_json", "io.config_yaml", "native", "refine.vgicp", "eval.oracle",
                 "eval.plotting", "cluster.dcvc", "cluster.fec", "graph.build", "graph.local_map", "refine.ndt",
                 "match.graph_match", "match.lapjv", "backend.cg", "backend.pgo", "backend.ba",
                 "slam.multisession", "parallel.mesh", "parallel.sharded_match", "parallel.ring_sweep",
                 "parallel.sharded_ba", "parallel.multihost_check", "eval.benchworld", "utils.profiling"):
        importlib.import_module(f"sgtd_tpu_torch.{name}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sgtd_tpu"))
    if loaded:
        fail(f"modules of JAX or of the JAX package were loaded: {loaded}")
    print(json.dumps({"kernels": records}), flush=True)
    log(f"total: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
