"""Command-line tools of the port (port of sgtd_tpu.cli), the analog of the
reference's ROS nodes.

  build-map   : raw .bin + .label scans -> per-scan semantic graph JSONs
                (the ``create_semantic_graph`` node, get_json.cpp): each
                padded scan goes to the device once and through DCVC and
                the graph builder there; ``--local-map-radius`` merges the
                scans around each keyframe first (local_map.cpp).
  localize    : map graph dir + query graph dir -> SR/RMSE/Recall metrics
                (the ``semantic_graph_localization`` node), optionally with
                the GICP or VGICP rerank from the scans' .bin files.
  eval-synth  : self-contained synthetic-world evaluation (no dataset needed).

Run as ``python -m sgtd_tpu_torch.cli <command> ... [--device cuda|cpu]``;
the device defaults to the card. The graph files and the JSON summary
are the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _cmd_build_map(args):
    import torch

    from sgtd_tpu_torch.config import DcvcConfig, SGTDConfig
    from sgtd_tpu_torch.graph.build import MULRAN_ROUTING, WILD_ROUTING, build_graph
    from sgtd_tpu_torch.io import readers
    from sgtd_tpu_torch.io.graph_json import write_graph_json

    cfg = SGTDConfig()
    dcvc = DcvcConfig()
    scans = readers.list_scans(args.scans, ".bin")
    labels = readers.list_scans(args.labels, ".label")
    if len(scans) != len(labels):
        raise SystemExit(f"{len(scans)} .bin scans but {len(labels)} .label files")

    poses = None
    if args.poses:
        if args.dataset == "mulran":
            stamps, pose_mats = readers.read_mulran_poses(args.poses)
            pose_mats = readers.apply_mulran_utm_offset(pose_mats, args.sequence or "")
            scan_stamps = np.asarray([int(os.path.splitext(os.path.basename(s))[0]) for s in scans], dtype=np.int64)
            poses = pose_mats[readers.associate_by_timestamp(scan_stamps, stamps)]
        else:
            poses = readers.read_kitti_poses(args.poses, args.calib)

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    n_max = dcvc.max_points

    if args.local_map_radius > 0:
        # Multi-frame densified keyframes (ref local_map.cpp; the map
        # variant behind the headline "multi" results).
        from sgtd_tpu_torch import native
        from sgtd_tpu_torch.graph.local_map import build_local_map_graphs

        if poses is None:
            raise SystemExit("--local-map-radius requires --poses")

        def load_scan(j):
            xyz, sem_j, inst_j = native.load_scan(scans[j], labels[j])
            if args.dataset == "kitti":
                sem_j = readers.to_reference_train_ids(readers.remap_semantic_kitti(sem_j))
            return xyz, sem_j, inst_j

        graphs = build_local_map_graphs(load_scan, poses.astype(np.float32), args.local_map_radius, cfg.caps, dcvc,
                                        device=args.device)
        for sp, g in zip(scans, graphs):
            write_graph_json(os.path.join(args.out, os.path.splitext(os.path.basename(sp))[0] + ".json"), g)
        print(f"[build-map] wrote {len(graphs)} local-map graphs to {args.out}")
        return

    # Wild-Places profile (ref get_json_wild.cpp): 3-float .bin stride,
    # 13-class identity routing.
    routing = WILD_ROUTING if args.dataset == "wild" else MULRAN_ROUTING
    for i, (sp, lp) in enumerate(zip(scans, labels)):
        pts = readers.read_bin_wild(sp) if args.dataset == "wild" else readers.read_bin(sp)[:, :3]
        sem, inst = readers.read_label(lp)
        if args.dataset == "kitti":
            sem = readers.to_reference_train_ids(readers.remap_semantic_kitti(sem))
        if args.label_corrupt_rate > 0:
            sem = readers.corrupt_labels(sem, args.label_corrupt_rate, rng)
        n = min(len(pts), n_max)
        p = np.zeros((n_max, 3), np.float32)
        p[:n] = pts[:n]
        s = np.zeros(n_max, np.int32)
        s[:n] = sem[:n]
        ii = np.zeros(n_max, np.int32)
        ii[:n] = inst[:n]
        mask = np.zeros(n_max, bool)
        mask[:n] = True
        pose = poses[i] if poses is not None else np.eye(4, dtype=np.float32)
        g = build_graph(*(torch.from_numpy(a).to(args.device) for a in (p, s, ii, mask)),
                        pose.astype(np.float32), cfg.caps, dcvc, routing)
        write_graph_json(os.path.join(args.out, os.path.splitext(os.path.basename(sp))[0] + ".json"), g)
        if i % 50 == 0:
            print(f"[build-map] {i}/{len(scans)}", file=sys.stderr)
    print(f"[build-map] wrote {len(scans)} graphs to {args.out}")


def _cmd_localize(args):
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.eval.runner import build_map_index, evaluate
    from sgtd_tpu_torch.io.graph_json import read_graph_dir

    cfg = SGTDConfig()
    if args.enable_gicp:
        cfg = cfg.replace(
            gicp=dataclasses.replace(
                cfg.gicp,
                enable=True,
                engine=args.engine,
                leaf_size=args.leaf_size,
                max_points=args.gicp_max_points,
            )
        )
    map_graphs = read_graph_dir(args.map_graphs, cfg, args.device)
    query_graphs = read_graph_dir(args.query_graphs, cfg, args.device)
    print(f"[localize] map={len(map_graphs)} queries={len(query_graphs)}", file=sys.stderr)

    # Rerank cloud loaders (ref semantic_graph_localization.cpp:651-723:
    # the query .bin is origin-filtered and voxel-downsampled at leaf_size,
    # the candidate keyframe .bins are used as they are). Scan files pair
    # with graphs by sorted basename, as the reference builds its paths.
    query_cloud_fn = map_cloud_fn = None
    q_loader = None
    if args.enable_gicp:
        from sgtd_tpu_torch.io import readers
        from sgtd_tpu_torch.native import PrefetchingLoader
        from sgtd_tpu_torch.ops.voxel import load_query_cloud

        if not (args.query_scans and args.map_scans):
            raise SystemExit("--enable-gicp requires --query-scans/--map-scans")
        q_bins = readers.list_scans(args.query_scans, ".bin")
        m_bins = readers.list_scans(args.map_scans, ".bin")
        if len(q_bins) != len(query_graphs) or len(m_bins) != len(map_graphs):
            raise SystemExit(
                f"scan/graph count mismatch: {len(q_bins)} query bins vs "
                f"{len(query_graphs)} graphs, {len(m_bins)} map bins vs "
                f"{len(map_graphs)} graphs"
            )
        # Query scans stream through the native prefetching loader (C++
        # background threads, native/loader.cpp), so disk reads overlap the
        # device; map scans are read once each into the map artifacts.
        q_loader = PrefetchingLoader(q_bins)

        def query_cloud_fn(i):
            pts = q_loader.get(i)[0]
            return load_query_cloud(pts, cfg.gicp.leaf_size, cfg.gicp.max_points)

        def map_cloud_fn(fid):
            # Map clouds are not downsampled (ref :703-711, commented out).
            pts = readers.read_bin(m_bins[fid])[:, :3]
            return load_query_cloud(pts, 0.0, cfg.gicp.max_points)

    index = build_map_index(map_graphs, cfg, args.device)

    # Persistent map artifacts (keyframe clouds, covariances and, for
    # VGICP, voxel maps): built once and saved beside the DB, loaded and
    # checked against the DB and the GICP parameters on later runs.
    artifacts = None
    if args.enable_gicp and args.map_artifacts:
        from sgtd_tpu_torch.db.artifacts import build_map_artifacts, load_map_artifacts, save_map_artifacts

        if os.path.exists(args.map_artifacts):
            artifacts = load_map_artifacts(
                args.map_artifacts,
                expect_frames=index.db.frame_poses.shape[0],
                expect_gicp=cfg.gicp,
                device=args.device,
            )
            print(f"[localize] loaded map artifacts: {args.map_artifacts}", file=sys.stderr)
        else:
            artifacts = build_map_artifacts(
                map_cloud_fn, len(map_graphs), cfg.gicp,
                f_pad=index.db.frame_poses.shape[0], device=args.device,
            )
            save_map_artifacts(args.map_artifacts, artifacts, cfg.gicp)
            print(f"[localize] built+saved map artifacts: {args.map_artifacts}", file=sys.stderr)

    try:
        out = evaluate(
            index,
            query_graphs,
            batch_size=args.batch_size,
            query_cloud_fn=query_cloud_fn,
            map_cloud_fn=map_cloud_fn,
            rerank_k=args.rerank_k,
            map_artifacts=artifacts,
        )
    finally:
        if q_loader is not None:
            q_loader.close()
    if args.viz_dir:
        out["viz"] = _write_candidate_viz(args.viz_dir, index, query_graphs, args.viz_queries)
    print(json.dumps(out, indent=2))


def _cmd_eval_synth(args):
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.data.synthetic import make_map_and_queries
    from sgtd_tpu_torch.eval.runner import build_map_index, evaluate

    cfg = SGTDConfig()
    maps, queries, _ = make_map_and_queries(
        cfg,
        seed=args.seed,
        num_map_frames=args.map_frames,
        num_queries=args.queries,
        center_noise_m=0.05,
        dropout=0.1,
        label_corrupt_rate=args.label_corrupt_rate,
    )
    index = build_map_index(maps, cfg, args.device)
    out = evaluate(index, queries, batch_size=min(16, args.queries))
    if args.viz_dir:
        out["viz"] = _write_candidate_viz(args.viz_dir, index, queries, args.viz_queries)
    if args.plot:
        from sgtd_tpu_torch.eval.plotting import plot_localization
        from sgtd_tpu_torch.graph.types import stack_graphs
        from sgtd_tpu_torch.match.pipeline import localize

        # Localize again for the plot, all queries in one batch.
        res = localize(index.db, stack_graphs(queries, args.device), index.config)
        gt = np.stack([np.asarray(g.pose) for g in queries])
        est = res.poses[:, 0].cpu().numpy()
        succ = res.found.cpu().numpy()
        path = plot_localization(args.plot, np.stack([np.asarray(g.pose) for g in maps]), gt, est, succ)
        out["plot"] = path
    print(json.dumps(out, indent=2))


def _write_candidate_viz(viz_dir, index, query_graphs, n):
    """Per-query candidate/match PNGs (ref rviz marker topics,
    semantic_graph_localization.cpp:784-953)."""
    from sgtd_tpu_torch.eval.plotting import plot_query_candidates

    os.makedirs(viz_dir, exist_ok=True)
    paths = []
    for i, g in enumerate(query_graphs[: max(n, 0)]):
        p = plot_query_candidates(
            os.path.join(viz_dir, f"query_{i:04d}.png"), index.db, g, index.config, title=f"query {i}"
        )
        if p:
            paths.append(p)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sgtd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device of the graphs, the DB and the rerank (default cuda; cpu runs "
                            "the kernels' plain versions)")

    b = sub.add_parser("build-map", help="raw scans -> semantic graph JSONs")
    b.add_argument("--scans", required=True)
    b.add_argument("--labels", required=True)
    b.add_argument("--poses", default=None)
    b.add_argument("--calib", default=None)
    b.add_argument("--dataset", choices=["kitti", "mulran", "raw", "wild"], default="kitti")
    b.add_argument("--sequence", default=None)
    b.add_argument("--label-corrupt-rate", type=float, default=0.0)
    b.add_argument("--local-map-radius", type=float, default=0.0,
                   help="merge scans within this radius into each keyframe "
                        "(multi-frame densified maps; 0 = single-scan)")
    b.add_argument("--out", required=True)
    device_arg(b)
    b.set_defaults(fn=_cmd_build_map)

    l = sub.add_parser("localize", help="map+query graph dirs -> metrics")
    l.add_argument("--map-graphs", required=True)
    l.add_argument("--query-graphs", required=True)
    l.add_argument("--batch-size", type=int, default=16)
    l.add_argument("--enable-gicp", action="store_true",
                   help="multi-candidate registration rerank from raw scans "
                        "(the reference's enable_gicp headline path)")
    l.add_argument("--engine", choices=["gicp", "vgicp"], default="gicp")
    l.add_argument("--query-scans", default=None,
                   help=".bin dir pairing with --query-graphs by sort order")
    l.add_argument("--map-scans", default=None,
                   help=".bin dir pairing with --map-graphs by sort order")
    l.add_argument("--leaf-size", type=float, default=3.0,
                   help="query-cloud voxel downsample leaf (ref SG_data)")
    l.add_argument("--gicp-max-points", type=int, default=8192)
    l.add_argument("--rerank-k", type=int, default=4)
    l.add_argument("--map-artifacts", default=None,
                   help="path to the persistent keyframe-cloud/covariance/"
                        "voxel-map .npz (built and saved on the first run, "
                        "loaded afterwards)")
    l.add_argument("--viz-dir", default=None,
                   help="write per-query candidate/match PNGs here")
    l.add_argument("--viz-queries", type=int, default=4,
                   help="how many queries to visualize")
    device_arg(l)
    l.set_defaults(fn=_cmd_localize)

    e = sub.add_parser("eval-synth", help="synthetic-world evaluation")
    e.add_argument("--map-frames", type=int, default=100)
    e.add_argument("--queries", type=int, default=32)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--label-corrupt-rate", type=float, default=0.05)
    e.add_argument("--plot", default=None, help="write a trajectory PNG here")
    e.add_argument("--viz-dir", default=None, help="write per-query candidate/match PNGs here")
    e.add_argument("--viz-queries", type=int, default=4)
    device_arg(e)
    e.set_defaults(fn=_cmd_eval_synth)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
