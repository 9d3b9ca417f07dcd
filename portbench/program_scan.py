"""The system under test for the scan kind: ``sgtd_tpu_torch`` as a
relocalization service that answers raw labeled scans, driven through its
public functions only.

``ScanService`` is ``program.Service`` with scans in place of graphs. At
construction it builds the map's keyframe graphs, and those of the first
queries that calibrate the scan budget, with the program's front end on
the card (``graph.build.build_graph``, one call a scan, as ``build-map``
runs it); ``build`` makes the index from them as the graph kind does. A
request is one call of ``localize_scan`` on one batch of host scans, its
answer and the scans' graphs read back to the host, TRUNC_SCAN queries
answered again as the graph kind answers them. ``staged`` answers the
same request stage by stage, the front end its own stage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.graph.build import build_graph
from sgtd_tpu_torch.graph.types import stack_graphs
from sgtd_tpu_torch.match.pipeline import localize_scan, rank_candidates
from sgtd_tpu_torch.match.search import candidate_search
from sgtd_tpu_torch.match.verify import verify_candidates
from sgtd_tpu_torch.utils import disable_tf32, profiling

from portbench.program import Service, _sync, sgtd_config


def scan_config(config: dict):
    """The program's configuration: ``program.sgtd_config``'s, its nodes
    capped at the world's ``max_nodes``."""
    cfg = sgtd_config(config)
    return cfg.replace(caps=dataclasses.replace(cfg.caps, max_nodes=config["world"]["max_nodes"]))


class ScanService(Service):
    def __init__(self, inputs: dict, config: dict, traffic: dict, device):
        self.dev = torch.device(device)
        self.k = 0
        self.base = scan_config(config)
        self.calibrate_n = config["calibrate_queries"]
        self.batch = b = traffic["batch"]
        disable_tf32()
        q = inputs["queries"]
        n_q, n = q["sem"].shape
        self.inst = np.zeros((b, n), np.int32)  # the scans carry no instance ids
        self.batches = [(list(range(s, min(s + b, n_q))),
                         [q["points"][s : s + b], q["sem"][s : s + b], self.inst[: min(b, n_q - s)], q["mask"][s : s + b]])
                        for s in range(0, n_q, b)]
        m, poses = inputs["maps"], inputs["world"].map_poses
        _sync(self.dev)
        t0 = time.perf_counter()
        maps = [self._graph(m, i, poses[i]) for i in range(len(poses))]
        sample = [self._graph(q, i, np.eye(4, dtype=np.float32)) for i in range(min(self.calibrate_n, n_q))]
        _sync(self.dev)
        self.frontend_s = time.perf_counter() - t0
        self.inputs = {"maps": maps, "queries": sample}

    def _graph(self, scans: dict, i: int, pose):
        """Scan ``i`` of a stacked set: its graph, built on the card."""
        points, sem, mask = (torch.from_numpy(scans[k][i]).to(self.dev) for k in ("points", "sem", "mask"))
        inst = torch.from_numpy(self.inst[0]).to(self.dev)
        return build_graph(points, sem, inst, mask, torch.as_tensor(pose, device=self.dev), self.base.caps,
                           self.base.dcvc)

    def _scans(self, host):
        return [torch.from_numpy(a).to(self.dev) for a in host]

    def _frontend(self, points, sem, inst, mask):
        """The graphs of a batch of scans, as ``localize_scan`` builds them."""
        eye = torch.eye(4, dtype=torch.float32, device=self.dev)
        return stack_graphs([build_graph(points[b], sem[b], inst[b], mask[b], eye, self.cfg.caps, self.cfg.dcvc)
                             for b in range(points.shape[0])], self.dev)

    def _to_device(self, host):
        """A batch's graphs on the card (what ``program.Service`` reads
        where it hands graphs over: the fallback's warm-up, ``work``)."""
        return self._frontend(*self._scans(host)), None

    @staticmethod
    def _read_graphs(g) -> dict:
        return {"graph_centers": g.centers.cpu().numpy(), "graph_labels": g.labels.cpu().numpy(),
                "graph_mask": g.mask.cpu().numpy()}

    def serve(self, i: int) -> dict:
        """Request ``i``: ``localize_scan`` on batch i; the answers and the
        scans' graphs on the host."""
        res, g = localize_scan(self.db, *self._scans(self.batches[i][1]), self.cfg)
        ans, graphs = self._read(res), self._read_graphs(g)
        if ans["trunc"].any():
            self._fallback(g, ans, None)
        return {**ans, **graphs}

    def staged(self, i: int, spans: dict, profiled: bool = False) -> dict:
        """Request ``i`` stage by stage in ``localize_scan``'s order,
        synchronized around each stage; adds each stage's ms to ``spans``
        (and, ``profiled``, marks it as a profiler range ``pb:<stage>``),
        and the request's DCVC sweeps a scan, read from the program's
        tracer, to ``spans["dcvc_sweeps"]``."""

        @contextlib.contextmanager
        def stage(name):
            rng = torch.profiler.record_function(f"pb:{name}") if profiled else contextlib.nullcontext()
            _sync(self.dev)
            t0 = time.perf_counter()
            with rng:
                yield
                _sync(self.dev)
            spans.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

        cfg, db = self.cfg, self.db
        with stage("input"):
            scans = self._scans(self.batches[i][1])
        own = profiling.active() is None
        tracer = profiling.enable() if own else profiling.active()
        before = len(tracer.counters.get("dcvc.sweeps", ()))
        try:
            with stage("frontend"):
                g = self._frontend(*scans)
        finally:
            if own:
                profiling.disable()
        sweeps = [v for _, v in list(tracer.counters.get("dcvc.sweeps", ()))[before:]]
        if sweeps:
            spans.setdefault("dcvc_sweeps", []).append(sum(sweeps) / len(self.batches[i][0]))
        with stage("desc"):
            query = build_descriptors(g, cfg.desc, cfg.caps)
        with stage("search"):
            cand = candidate_search(db, query, cfg.desc, cfg.search, cfg.caps)
        with stage("verify"):
            res = rank_candidates(db, query, cand, verify_candidates(db, query, cand, cfg.search), cfg)
        with stage("output"):
            ans, graphs = self._read(res), self._read_graphs(g)
        if ans["trunc"].any():
            with stage("fallback"):
                self._fallback(g, ans, None)
        return {**ans, **graphs}

    def describe(self) -> str:
        return (f"{super().describe()}; map front end {self.frontend_s:.3f} s for "
                f"{len(self.inputs['maps']) + len(self.inputs['queries'])} scans")
