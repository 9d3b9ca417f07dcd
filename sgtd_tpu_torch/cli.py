"""Command-line tools of the port (port of sgtd_tpu.cli), the analog of the
reference's ROS nodes.

  localize    : map graph dir + query graph dir -> SR/RMSE/Recall metrics
                (the ``semantic_graph_localization`` node), optionally with
                the GICP or VGICP rerank from the scans' .bin files.
  eval-synth  : self-contained synthetic-world evaluation (no dataset needed).
  build-map   : registered; raises until the front end is ported.

Run as ``python -m sgtd_tpu_torch.cli <command> ... [--device cuda|cpu]``;
the device defaults to the card. The JSON summary's keys are the
reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _cmd_build_map(args):
    raise NotImplementedError(
        "build-map is not ported yet: it needs the front end (clustering and "
        "graph building, ROADMAP queue 1 item 3); build the graph JSONs with "
        "`python -m sgtd_tpu.cli build-map`, which this CLI reads"
    )


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
                       help="torch device of the DB and the rerank (default cuda; cpu runs the "
                            "kernels' plain versions)")

    # The reference's flags, so that its command line reaches the error.
    b = sub.add_parser("build-map", help="raw scans -> semantic graph JSONs (not ported yet)")
    b.add_argument("--scans", required=True)
    b.add_argument("--labels", required=True)
    b.add_argument("--poses", default=None)
    b.add_argument("--calib", default=None)
    b.add_argument("--dataset", choices=["kitti", "mulran", "raw", "wild"], default="kitti")
    b.add_argument("--sequence", default=None)
    b.add_argument("--label-corrupt-rate", type=float, default=0.0)
    b.add_argument("--local-map-radius", type=float, default=0.0)
    b.add_argument("--out", required=True)
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
