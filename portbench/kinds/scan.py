"""The scan kind: relocalization from raw labeled scans. Each request is a
batch of labeled LiDAR scans (``gen.scans``); the program builds their
semantic graphs on the card and localizes them (``localize_scan``) against
a map index whose keyframe graphs its own front end built at set-up
(``program_scan.ScanService``). The reference builds every map and query
graph with the plain front end (``reference.frontend``, float64) and
answers the queries from them with the graph kind's reference
(``reference.pipeline``).

The check judges the front end and the answer. A query's graph shares a
node with the reference's where the two have the same label and are each
other's nearest of it within ``SHARE_M``; the others are unshared. Float32
and float64 centroids may flip a quantised triangle side and so move a
vote or a descriptor: the candidates are counted, not held equal. The
numbers, each query counted once however often the window answers it:

- ``node_off``: unshared nodes, summed over the queries (each query's
  most over its answers);
- ``node_gap_med_m``: the median centroid gap of the shared nodes;
- ``cand_off``: queries with an answer whose ``found`` or best keyframe
  differs from the reference's (where both found one);
- ``pose_gap_med_m`` and ``pose_far_n``: the graph kind's (``check.py``).

Beside them, in ``extras``: ``cand_list_off``, the queries with an answer
whose descriptor count, candidates, votes, ``found`` or best keyframe
differs (the graph kind's exact ``cand_off``, counted here and not held to
a limit: sound runs reach most queries with it), and ``found_off``.

The program is imported by ``check``, before set-up, so that a program
without ``localize_scan`` fails within seconds.
"""

from __future__ import annotations

import numpy as np

from portbench.check import POSE_FAR_M, far, gaps, per_query
from portbench.gen import scans
from portbench.kinds.graph import LADDER
from portbench.reference import frontend, pipeline

# A node is shared within this distance, set from readings (PERF.md
# section 2): sound runs share every node with centroids at most 9.6e-5 m
# apart; the control, on points rounded to bfloat16, leaves ~11,000
# unshared at this distance.
SHARE_M = 1e-3
# The distances at which ``readings`` counts unshared nodes.
SHARE_LADDER = (1e-5, 1e-4, 1e-3, 1e-2, 0.1)
GRAPH_KEYS = ("graph_centers", "graph_labels", "graph_mask")


def check(config: dict, traffic: dict) -> None:
    if traffic["entry"] != "localize_scan" or traffic["rerank_k"] != 0:
        raise ValueError("the scan kind serves localize_scan, without a rerank")
    from sgtd_tpu_torch.match.pipeline import localize_scan  # noqa: F401 - the entry, before anything is rendered


def make_inputs(seed: int, config: dict, traffic: dict) -> dict:
    return scans.make_inputs(seed, config, traffic["queries"])


def Service(inputs: dict, config: dict, traffic: dict, device):  # noqa: N802 - the kind's constructor
    from portbench.program_scan import ScanService

    return ScanService(inputs, config, traffic, device)


def reference(inputs: dict, config: dict, traffic: dict, device, control: bool = False) -> dict:
    """The reference's graph of every scan (each built once) and its
    answer to every query; the control rounds the points to bfloat16
    before the front end."""
    n = config["world"]["max_nodes"]
    built = {}
    eye = np.tile(np.eye(4), (len(inputs["queries"]["sem"]), 1, 1))
    for side, poses in (("maps", inputs["world"].map_poses), ("queries", eye)):
        s = inputs[side]
        built[side] = [frontend.build_graph(s["points"][i], s["sem"][i], s["mask"][i], poses[i], n, device,
                                            bf16=control) for i in range(len(poses))]
    out = pipeline.answers(built, config, traffic, device)
    q = built["queries"]
    out.update(graph_centers=np.stack([g.centers for g in q]), graph_labels=np.stack([g.labels for g in q]),
               graph_mask=np.stack([g.mask for g in q]))
    return out


def node_gaps(answers, ref: dict, share_m: float = SHARE_M):
    """Per answer, its unshared nodes; and the centroid gaps of its shared
    ones, pooled."""
    off, shared = [], []
    for ids, a in answers:
        for j, q in enumerate(ids):
            pm, rm = a["graph_mask"][j], ref["graph_mask"][q]
            pc, rc = a["graph_centers"][j][pm].astype(np.float64), ref["graph_centers"][q][rm].astype(np.float64)
            pl, rl = a["graph_labels"][j][pm], ref["graph_labels"][q][rm]
            d = np.linalg.norm(pc[:, None] - rc[None], axis=-1)
            d[pl[:, None] != rl[None]] = np.inf
            if d.size:
                near_r, near_p = d.argmin(1), d.argmin(0)
                mutual = near_p[near_r] == np.arange(len(pc))
                gap = d[np.arange(len(pc)), near_r]
                ok = mutual & (gap <= share_m)
            else:
                ok, gap = np.zeros(len(pc), bool), np.zeros(len(pc))
            off.append(len(pc) + len(rc) - 2 * int(ok.sum()))
            shared.append(gap[ok])
    return np.array(off), np.concatenate(shared) if shared else np.zeros(0)


def numbers(answers, ref: dict, share_m: float = SHARE_M) -> dict:
    """The compared numbers, the answers counted and ``extras``."""
    g = gaps(answers, ref)
    ids, n = g["ids"], g["n"]
    off, shared = node_gaps(answers, ref, share_m)
    found = np.concatenate([a["found"] for _, a in answers]) != ref["found"][ids]
    once = lambda x: int((per_query(ids, x.astype(np.float64), n) > 0).sum())  # noqa: E731
    out = {"node_off": int(np.maximum(per_query(ids, off.astype(np.float64), n), 0).sum()),
           "node_gap_med_m": float(np.median(shared)) if shared.size else 0.0,
           "cand_off": once(found | g["best_off"]),
           "pose_gap_med_m": float(np.median(g["top"])) if g["top"].size else 0.0,
           "pose_far_n": far(g, "top", POSE_FAR_M), "answers": int(ids.size)}
    out["extras"] = {"cand_list_off": once(g["cand"]), "found_off": once(found),
                     "node_gap_max_m": float(shared.max(initial=0.0)), "pose_gap_max_m": float(g["top"].max(initial=0.0))}
    return out


def control_answers(ref_ctl: dict) -> list:
    """The control's answers as the check reads the program's."""
    keys = ("num_desc", "frames", "votes", "found", "best_frame", "pose") + GRAPH_KEYS
    return [(np.arange(len(ref_ctl["found"])), {k: ref_ctl[k] for k in keys})]


def readings(answers, ref: dict) -> dict:
    """The compared numbers, the queries the reference answered through
    TRUNC_SCAN, the far counts at each threshold of the graph kind's
    ``LADDER`` and the unshared nodes at each distance of ``SHARE_LADDER``."""
    g = gaps(answers, ref)
    return dict(numbers(answers, ref), trunc=int(ref["trunc"].sum()),
                far={"top": {str(t): far(g, "top", t) for t in LADDER}},
                node_off_at={str(s): numbers(answers, ref, s)["node_off"] for s in SHARE_LADDER})
