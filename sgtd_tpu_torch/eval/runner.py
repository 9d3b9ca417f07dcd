"""End-to-end evaluation runner (port of sgtd_tpu.eval.runner): the analog
of the reference's benchmark node.

The main loop of ``semantic_graph_localization``
(src/sgtd/src/semantic_graph_localization.cpp:352-646): build the
descriptor DB from the map keyframe graphs, localize every query graph,
and report SR / RMSE / Recall@K / timing with the reference's metric
definitions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.db.artifacts import build_map_artifacts, validate_map_artifacts
from sgtd_tpu_torch.db.database import DBBuildReport, DescriptorDB, tuned_config
from sgtd_tpu_torch.db.device_build import build_database_on_device
from sgtd_tpu_torch.desc.triangles import Descriptors, build_descriptors
from sgtd_tpu_torch.eval.metrics import EvalAccumulator
from sgtd_tpu_torch.graph.types import SemanticGraph, stack_graphs
from sgtd_tpu_torch.interop import to_numpy
from sgtd_tpu_torch.match.pipeline import localize, localize_exact, localize_refined
from sgtd_tpu_torch.match.search import TRUNC_SCAN
from sgtd_tpu_torch.refine.gicp import gicp_rerank
from sgtd_tpu_torch.refine.vgicp import GaussianVoxelMap, vgicp_rerank


@dataclasses.dataclass
class MapIndex:
    db: DescriptorDB
    config: SGTDConfig  # bucket-cap-tuned
    build_seconds: float
    report: DBBuildReport


# Frames per descriptor-build call.
BUILD_CHUNK = 32


def build_descriptors_chunked(
    batch: SemanticGraph, config: SGTDConfig, chunk: int = BUILD_CHUNK
) -> Descriptors:
    """Descriptors of a stacked graph batch, ``chunk`` frames per
    :func:`build_descriptors` call, so the build's working memory is
    bounded by the chunk at any map size. Equal to one unchunked call.
    (The reference pads the tail chunk to reuse one compiled program;
    eager calls need no padding.)"""
    n = batch.centers.shape[0]
    outs = [
        build_descriptors(SemanticGraph(*(x[i : i + chunk] for x in batch)), config.desc, config.caps)
        for i in range(0, n, chunk)
    ]
    return Descriptors(*(torch.cat(xs) for xs in zip(*outs)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_map_index(
    map_graphs: Sequence[SemanticGraph],
    config: SGTDConfig,
    device: torch.device | str = "cuda",
) -> MapIndex:
    """The descriptor DB of the keyframe graphs, built on ``device``. Its
    seconds are the reference's startup DB rebuild (src/readme.txt:5),
    excluded from the query timing as there."""
    device = torch.device(device)
    t0 = time.time()
    batch = stack_graphs(map_graphs, device)
    descs = build_descriptors_chunked(batch, config)
    db, report = build_database_on_device(descs, batch.pose, config.desc)
    _sync(device)
    return MapIndex(
        db=db,
        config=tuned_config(config, report),
        build_seconds=time.time() - t0,
        report=report,
    )


def _apply_rerank_pick(cfg, ks, frames_q, fitg, frac, tf, init_poses, frame_poses, best_poses):
    """Host twin of ``match.pipeline.rerank_pick`` (NumPy, as in the
    reference): the overlap-normalized score maximised under the
    per-candidate divergence guard, for the queries ``ks``."""
    for j, k in enumerate(ks):
        refined = frame_poses[frames_q[k]] @ tf[j]  # (K, 4, 4)
        shift = np.linalg.norm(refined[:, :3, 3] - init_poses[k][:, :3, 3], axis=-1)
        dR = refined[:, :3, :3] @ np.swapaxes(init_poses[k][:, :3, :3], -1, -2)
        tr = np.clip((np.trace(dR, axis1=-2, axis2=-1) - 1.0) * 0.5, -1, 1)
        rot_deg = np.degrees(np.arccos(tr))
        guard_ok = (shift <= cfg.gicp.max_refine_shift_m) & (rot_deg <= cfg.gicp.max_refine_rot_deg)
        if not guard_ok.any():
            continue
        score = np.where(guard_ok, frac[j] - 0.1 * fitg[j], -np.inf)
        best_poses[k] = refined[int(score.argmax())]
    return best_poses


def _rerank_single(index, cfg, res_one, qc, qm, art, rerank_k, best_pose):
    """Artifact rerank of ONE query (the truncation-fallback path).

    res_one: that query's LocalizationResult as NumPy fields without a
    batch axis; qc (S, 3) / qm (S,) its cloud on the DB's device. VGICP on
    the artifacts' voxel maps with the VGICP engine; as in the reference,
    GICP refines here whenever the artifacts carry no voxel maps, whatever
    ``cfg.gicp.engine`` says."""
    if not bool(res_one.found):
        return best_pose
    frames_k = res_one.frames[:rerank_k].astype(np.int32)
    inits = np.tile(np.eye(4, dtype=np.float32), (rerank_k, 1, 1))
    inits[:, :3, :3] = res_one.rot[:rerank_k]
    inits[:, :3, 3] = res_one.trans[:rerank_k]
    fk = torch.from_numpy(frames_k).long().to(qc.device)
    inits_t = torch.from_numpy(inits).to(qc.device)[None]
    if cfg.gicp.engine == "vgicp" and art.vmaps is not None:
        vm_k = GaussianVoxelMap(*(x[fk][None] for x in art.vmaps))
        out = vgicp_rerank(qc[None], qm[None], None, None, inits_t, cfg.gicp, voxel_maps=vm_k)
    else:
        out = gicp_rerank(
            qc[None], qm[None], art.clouds[fk][None], art.masks[fk][None], inits_t, cfg.gicp,
            tgt_covs=art.covs[fk][None],
        )
    out = to_numpy(out)
    best = _apply_rerank_pick(
        cfg, [0], frames_k[None], out.fitness_gated, out.inlier_frac, out.transform,
        res_one.poses[None, :rerank_k], index.db.frame_poses.cpu().numpy(), [best_pose],
    )
    return best[0]


def evaluate(
    index: MapIndex,
    query_graphs: Sequence[SemanticGraph],
    batch_size: int = 16,
    gt_poses: Optional[Sequence[np.ndarray]] = None,
    query_cloud_fn=None,
    map_cloud_fn=None,
    rerank_k: int = 4,
    map_artifacts=None,
) -> dict:
    """Localize every query on the DB's device; return the reference-style
    metric summary.

    gt_poses defaults to each query graph's own pose field (the reference
    reads GT from the graph JSON the same way,
    semantic_graph_localization.cpp:627-638).

    When ``config.gicp.enable`` and clouds are available (``map_artifacts``,
    or a ``map_cloud_fn(frame_id) -> (points, mask)`` from which artifacts
    are built once, plus ``query_cloud_fn(i)``), every chunk runs
    ``localize_refined``: descriptor search, verification and the
    multi-candidate GICP or VGICP rerank (VGICP on the artifacts' voxel
    maps where they carry them). ``mean_time_ms`` is the steady-state
    per-query cost, every chunk synchronized before the clock is read; the
    warm-up call on chunk 0 (``compile_seconds``, the reference's key: it
    also covers the kernels' build at first use) and the host-side data
    staging (``artifact_build_seconds``, ``query_cloud_load_seconds``) are
    reported apart, as the reference excludes its map build
    (src/readme.txt:5).
    """
    cfg = index.config
    device = index.db.frame_poses.device
    acc = EvalAccumulator(cfg)
    n = len(query_graphs)
    if gt_poses is None:
        gt_poses = [torch.as_tensor(g.pose).cpu().numpy() for g in query_graphs]

    use_gicp = (
        cfg.gicp.enable
        and query_cloud_fn is not None
        and (map_cloud_fn is not None or map_artifacts is not None)
    )
    art = map_artifacts
    art_build_s = 0.0
    if use_gicp and art is None:
        t0 = time.time()
        art = build_map_artifacts(
            map_cloud_fn, index.db.num_frames, cfg.gicp,
            f_pad=index.db.frame_poses.shape[0], device=device,
        )
        _sync(device)
        art_build_s = time.time() - t0
    if use_gicp:
        validate_map_artifacts(art, index.db, cfg.gicp)

    # Stage every chunk's inputs up front (graph stacking and query-cloud
    # loads are host-side data preparation, timed apart).
    t0 = time.time()
    chunks = []
    for i in range(0, n, batch_size):
        chunk = list(query_graphs[i : i + batch_size])
        n_real = len(chunk)
        pad = batch_size - n_real
        batch = stack_graphs(chunk + [chunk[-1]] * pad, device)
        qc = qm = None
        if use_gicp:
            qcm = [query_cloud_fn(i + k) for k in range(n_real)]
            qcm += [qcm[-1]] * pad
            qc = torch.from_numpy(np.stack([np.asarray(c) for c, _ in qcm])).to(device)
            qm = torch.from_numpy(np.stack([np.asarray(m) for _, m in qcm])).to(device)
        chunks.append((batch, n_real, qc, qm))
    load_s = time.time() - t0

    if use_gicp:
        # VGICP on the artifacts' voxel maps where they have them; else the
        # engine's rerank on the clouds and covariances.
        use_vm = cfg.gicp.engine == "vgicp" and art.vmaps is not None
        covs = None if use_vm else art.covs
        vmaps = art.vmaps if use_vm else None
        call = lambda c: localize_refined(
            index.db, c[0], c[2], c[3], art.clouds, art.masks, covs,
            config=cfg, rerank_k=rerank_k, map_vmaps=vmaps,
        )
    else:
        call = lambda c: localize(index.db, c[0], cfg)

    # Warm-up on chunk 0 (run again below for timing; results equal).
    _sync(device)
    t0 = time.time()
    call(chunks[0])
    _sync(device)
    compile_s = time.time() - t0

    # Steady-state pass: every chunk synchronized before the clock is read.
    t0 = time.time()
    outs = []
    for c in chunks:
        outs.append(call(c))
        _sync(device)
    steady_ms = (time.time() - t0) * 1000.0 / n

    for (batch, n_real, qc, qm), out in zip(chunks, outs):
        i0 = acc.total
        res = to_numpy(out.result if use_gicp else out)
        best_poses = np.array(out.pose.cpu().numpy() if use_gicp else res.poses[:, 0])
        # Capacity-cap fallback: a query whose probe scan overflowed
        # max_scan_slots lost votes. It runs again through the uncapped
        # exact path and, with GICP on, is re-ranked against the
        # artifacts. TRUNC_PAIRS alone is benign (votes exact; pair lists
        # subsampled, as the reference's own skip_len sampling does,
        # STDesc.cpp:467-468) and does not rerun.
        trunc = res.truncated & TRUNC_SCAN
        if np.any(trunc[:n_real] != 0):
            res_fields = {f: np.array(getattr(res, f)) for f in res._fields}
            for k in np.nonzero(trunc[:n_real])[0]:
                k = int(k)
                g_k = SemanticGraph(*(x[k : k + 1] for x in batch))
                ex = type(res)(*(v[0] for v in to_numpy(localize_exact(index.db, g_k, cfg))))
                for f in res._fields:
                    res_fields[f][k] = getattr(ex, f)
                best_poses[k] = ex.poses[0]
                if use_gicp:
                    best_poses[k] = _rerank_single(
                        index, cfg, ex, qc[k], qm[k], art, rerank_k, best_poses[k]
                    )
            res = type(res)(**res_fields)
        for k in range(n_real):
            acc.add(np.asarray(gt_poses[i0 + k]), best_poses[k], res.poses[k], time_ms=steady_ms)

    out = acc.summary()
    out["map_build_seconds"] = index.build_seconds
    out["db_rows"] = index.report.num_rows
    out["compile_seconds"] = compile_s
    out["artifact_build_seconds"] = art_build_s
    out["query_cloud_load_seconds"] = load_s
    return out
