"""The system under test: ``sgtd_tpu_torch`` as a relocalization service
serves it, driven through its public functions only.

``Service`` builds the map index from host graphs (and keyframe clouds),
then answers requests: one call of the cell's entry on one batch of query
scans, from host arrays handed over to the answer on the host. Queries the
entry flags TRUNC_SCAN are answered again through ``localize_exact`` (and,
in refined cells, re-ranked alone) inside the request, as
``eval.runner.evaluate`` does. ``staged`` answers the same request stage by
stage, synchronized between stages, for the per-layer spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from sgtd_tpu_torch import ops
from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.eval.runner import _rerank_single, build_descriptors_chunked, build_map_index
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.graph.types import SemanticGraph, stack_graphs
from sgtd_tpu_torch.interop import map_clouds_to_device, to_numpy
from sgtd_tpu_torch.match.pipeline import localize, localize_exact, localize_refined, rank_candidates, rerank_pick
from sgtd_tpu_torch.match.search import TRUNC_SCAN, calibrate_scan_slots, candidate_search, scan_totals
from sgtd_tpu_torch.match.verify import verify_candidates
from sgtd_tpu_torch.refine.gicp import gicp_align, point_covariances
from sgtd_tpu_torch.utils import disable_tf32

from portbench.work import bound_s, refine_flops, search_bytes

# Index of the B4 (nn1) and B5 (knn) launch counters in ops.launch_counts().
NN1, KNN = 3, 4


def sgtd_config(config: dict) -> SGTDConfig:
    """The program's configuration: defaults, the file's overrides."""
    cfg = SGTDConfig()
    for group, fields in config.get("overrides", {}).items():
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group), **fields)})
    return cfg


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Service:
    def __init__(self, inputs: dict, config: dict, traffic: dict, device):
        self.dev = torch.device(device)
        self.inputs = inputs
        self.k = traffic.get("rerank_k", 0)
        self.base = sgtd_config(config)
        self.calibrate_n = config["calibrate_queries"]
        self.batch = b = traffic["batch"]
        q = inputs["queries"]
        self.batches = []
        for s in range(0, len(q), b):
            part = q[s : s + b]
            host = [np.stack([getattr(g, f) for g in part]) for f in SemanticGraph._fields]
            if self.k:
                host += [inputs["query_clouds"][s : s + b], inputs["query_masks"][s : s + b]]
            self.batches.append((list(range(s, s + len(part))), host))
        disable_tf32()

    # -- the index --

    def build(self, frames: int | None = None) -> float:
        """Build the index of the first ``frames`` keyframes (all by
        default), calibrated on the first queries; seconds, synchronized."""
        maps = self.inputs["maps"][:frames]
        _sync(self.dev)
        t0 = time.perf_counter()
        index = build_map_index(maps, self.base, self.dev)
        db, cfg = index.db, index.config
        sample = stack_graphs(self.inputs["queries"][: self.calibrate_n], self.dev)
        cfg = calibrate_scan_slots(db, build_descriptors_chunked(sample, cfg), cfg)
        clouds = None
        if self.k:
            n = len(maps)
            mc, mm, _ = map_clouds_to_device(self.inputs["map_clouds"][:n], self.inputs["map_masks"][:n], None,
                                             self.dev, f_pad=db.frame_poses.shape[0])
            clouds = SimpleNamespace(clouds=mc, masks=mm, covs=point_covariances(mc, mm, cfg.gicp), vmaps=None)
        _sync(self.dev)
        seconds = time.perf_counter() - t0
        self.index, self.db, self.cfg, self.clouds, self.report = index, db, cfg, clouds, index.report
        return seconds

    def free(self) -> None:
        """Drop the index; its memory stays in the caching allocator."""
        self.index = self.db = self.clouds = None
        _sync(self.dev)

    # -- a request --

    def _to_device(self, host):
        t = [torch.from_numpy(a).to(self.dev) for a in host]
        return SemanticGraph(*t[:5]), t[5:]

    def _read(self, res, final=None) -> dict:
        out = {
            "num_desc": res.num_descriptors.cpu().numpy(), "frames": res.frames.cpu().numpy(),
            "votes": res.votes.cpu().numpy(), "found": res.found.cpu().numpy(),
            "best_frame": res.best_frame.cpu().numpy(), "pose": res.poses[:, 0].cpu().numpy(),
            "trunc": (res.truncated & TRUNC_SCAN).cpu().numpy() != 0,
        }
        if final is not None:
            out["refined"] = final.refined.cpu().numpy()
            out["final_pose"] = final.pose.cpu().numpy()
        return out

    def _fallback(self, g, ans, clouds) -> None:
        """Answer TRUNC_SCAN queries again, uncapped, and re-rank them by
        the program's own fallback (``eval.runner._rerank_single``)."""
        for j in np.nonzero(ans["trunc"])[0]:
            g_j = SemanticGraph(*(x[j : j + 1] for x in g))
            ex = localize_exact(self.db, g_j, self.cfg)
            one = self._read(ex)
            if self.k:
                start = one["pose"][0]
                ex1 = type(ex)(*(v[0] for v in to_numpy(ex)))
                pose = _rerank_single(self.index, self.cfg, ex1, clouds[0][j], clouds[1][j], self.clouds,
                                      self.k, start.copy())
                # The pick replaced the start: a refinement was accepted.
                one.update(final_pose=pose[None], refined=np.array([not np.array_equal(pose, start)]))
            for key in ans:
                ans[key][j] = one[key][0]

    def warm(self) -> None:
        """Answer the first query through the TRUNC_SCAN fallback once."""
        g, clouds = self._to_device(self.batches[0][1])
        ans = self._read(localize(self.db, g, self.cfg))
        ans["trunc"][:] = False
        ans["trunc"][0] = True
        self._fallback(g, ans, clouds)

    def serve(self, i: int) -> dict:
        """Request ``i``: the entry on batch i, answers on the host."""
        g, clouds = self._to_device(self.batches[i][1])
        if self.k:
            c = self.clouds
            out = localize_refined(self.db, g, clouds[0], clouds[1], c.clouds, c.masks, c.covs, config=self.cfg,
                                   rerank_k=self.k)
            ans = self._read(out.result, out)
        else:
            ans = self._read(localize(self.db, g, self.cfg))
        if ans["trunc"].any():
            self._fallback(g, ans, clouds)
        return ans

    def staged(self, i: int, spans: dict, profiled: bool = False) -> dict:
        """Request ``i`` stage by stage in ``localize_refined``'s order,
        synchronized around each stage; adds each stage's ms to ``spans``
        and, ``profiled``, marks it as a profiler range ``pb:<stage>``."""

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
            g, clouds = self._to_device(self.batches[i][1])
        with stage("desc"):
            query = build_descriptors(g, cfg.desc, cfg.caps)
        with stage("search"):
            cand = candidate_search(db, query, cfg.desc, cfg.search, cfg.caps)
        with stage("verify"):
            res = rank_candidates(db, query, cand, verify_candidates(db, query, cand, cfg.search), cfg)
        fin = None
        if self.k:
            c0 = ops.launch_counts()
            with stage("refine"):
                qc, qm = clouds
                src_cov = point_covariances(qc, qm, cfg.gicp)
                frames_k = res.frames[:, : self.k].long()
                inits = se3.rt_to_mat(res.rot[:, : self.k], res.trans[:, : self.k])
                per_k = lambda x: x[:, None].expand((x.shape[0], self.k) + x.shape[1:])
                c = self.clouds
                out = gicp_align(per_k(qc), per_k(qm), c.clouds[frames_k], c.masks[frames_k], inits, cfg.gicp,
                                 src_cov=per_k(src_cov), tgt_cov=c.covs[frames_k])
                pick, use, refined = rerank_pick(out.fitness_gated, out.inlier_frac,
                                                 db.frame_poses[frames_k] @ out.transform,
                                                 res.poses[:, : self.k], res.found, cfg.gicp)
                rows = torch.arange(pick.shape[0], device=pick.device)
                fin = _Final(torch.where(use[:, None, None], refined[rows, pick], res.poses[:, 0]), use)
            c1 = ops.launch_counts()
            spans.setdefault("nn1_launches", []).append(c1[NN1] - c0[NN1])
            spans.setdefault("knn_launches", []).append(c1[KNN] - c0[KNN])
        with stage("output"):
            ans = self._read(res, fin)
        if ans["trunc"].any():
            with stage("fallback"):
                self._fallback(g, ans, clouds)
        return ans

    def scan_totals(self, i: int) -> np.ndarray:
        """Probe-scan total of each query of batch ``i`` (the rows its
        probes read)."""
        g, _ = self._to_device(self.batches[i][1])
        return scan_totals(self.db, build_descriptors(g, self.cfg.desc, self.cfg.caps), self.cfg.desc).cpu().numpy()

    # -- what the harness reads --

    def describe(self) -> str:
        """The index and the traffic, for the set-up's log line."""
        return (f"{self.report.num_rows} rows, scan budget {self.cfg.caps.max_scan_slots}, "
                f"{len(self.batches)} batches of {self.batch}")

    def valid_points(self, ids, frames_k) -> tuple[int, int]:
        """Point pairs of a request's rerank, counted from the clouds' masks:
        (sum over its problems of the query's valid points times its
        candidate keyframe's, sum over its queries of valid points
        squared). ``frames_k`` indexes the map's clouds as the program's
        gather does, padded rows holding no point."""
        nq = self.inputs["query_masks"][ids].sum(1).astype(np.int64)
        nm = np.zeros(self.db.frame_poses.shape[0], np.int64)
        counts = self.inputs["map_masks"].sum(1)
        nm[: counts.size] = counts
        return int((nq[:, None] * nm[frames_k]).sum()), int((nq * nq).sum())

    def work(self, profiled_answers, spans: dict) -> dict:
        """The least seconds the card needs for each stage of the profiled
        staged requests ``[(batch, answer)]`` (``work.py``): the search's
        scanned slots and vote rows, and in refined cells the rerank's
        nearest-neighbour distances, by the launch counts ``staged`` put
        in ``spans``."""
        f_pad = self.db.frame_poses.shape[0]
        need = {"search": sum(bound_s(nbytes=search_bytes(self.scan_totals(b), f_pad)) for b, _ in profiled_answers)}
        if self.k:
            need["refine"] = sum(
                bound_s(flops=refine_flops(nn, kn, *self.valid_points(self.batches[b][0], a["frames"][:, : self.k])))
                for nn, kn, (b, a) in zip(spans.get("nn1_launches", []), spans.get("knn_launches", []),
                                          profiled_answers))
        return need


@dataclasses.dataclass
class _Final:
    pose: torch.Tensor
    refined: torch.Tensor
