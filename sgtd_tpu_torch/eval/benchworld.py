"""The bench workload as a reusable builder (port of
sgtd_tpu.eval.benchworld).

The bench, the bench-scale multi-device checks and the scale tools all need
the same world: 200 keyframes, ~400k descriptor rows, a calibrated scan
budget. This builds it once, with the chunked descriptor builder (working
memory bounded at any map size).
"""

from __future__ import annotations

import torch

from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.data.synthetic import make_map_and_queries
from sgtd_tpu_torch.db.database import tuned_config
from sgtd_tpu_torch.db.device_build import build_database_on_device
from sgtd_tpu_torch.eval.runner import build_descriptors_chunked
from sgtd_tpu_torch.graph.types import SemanticGraph, stack_graphs
from sgtd_tpu_torch.match.search import calibrate_scan_slots


def build_bench_world(
    num_map: int = 200,
    num_q: int = 16,
    seed: int = 2026,
    config: SGTDConfig | None = None,
    calibrate_n: int = 16,
    device: torch.device | str = "cuda",
):
    """Returns (tuned_config, db, query_graph_batch, report, world).

    The bench's seed and noise profile; the query batch is a stacked
    SemanticGraph (leading axis num_q) on ``device``, as is the DB. The
    scan budget is fitted to the first ``calibrate_n`` queries.
    """
    cfg = config or SGTDConfig()
    maps, queries, world = make_map_and_queries(
        cfg, seed=seed, num_map_frames=num_map, num_queries=num_q,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    batch = stack_graphs(maps, device)
    descs = build_descriptors_chunked(batch, cfg)
    db, report = build_database_on_device(descs, batch.pose, cfg.desc)
    qall = stack_graphs(queries, device)
    sample = SemanticGraph(*(x[: min(calibrate_n, num_q)] for x in qall))
    sample_descs = build_descriptors_chunked(sample, cfg)
    cfg = tuned_config(cfg, report)
    cfg = calibrate_scan_slots(db, sample_descs, cfg)
    return cfg, db, qall, report, world
