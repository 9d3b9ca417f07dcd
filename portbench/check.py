"""The comparison that decides ``correct``: every answer the window (or a
traced run) produced, judged against the plain reference's answer to the
same query.

The numbers, each held to the cell's limit (``cells/<cell>.json``):

- ``cand_off``: answers whose descriptor count, candidate list (frames and
  votes, in (votes desc, frame asc) order), ``found`` flag or best
  keyframe differs from the reference's. Counts of integers: an exact
  comparison, limit 0.
- ``pose_gap_med_m``: over answers found on both sides, the median gap
  between the program's top world pose and the reference's pose for the
  same keyframe, as the largest displacement of a point within the
  sensor's 50 m view radius (translation gap + 50 m x rotation gap).
- ``pose_far_n``: queries with an answer whose top-pose gap is above
  ``POSE_FAR_M``. The median sees a fault that moves most answers, this
  count one that moves a few: one slot of a batch, a third of the queries.
- refined cells, over the answers whose ``rerank_k`` candidates all passed
  verification in the reference (the configuration defines no starting
  pose for a candidate that failed, so the two sides' rerank of one need
  not agree): ``refined_off``, answers whose refined flag differs (exact,
  limit 0); ``refined_gap_med_m``, the median gap between the final poses;
  ``refined_far_n``, queries with a final-pose gap above ``REFINED_FAR_M``.

A query is answered many times in a window; the ``_far_n`` counts count
each query once, so that they do not grow with the window. Medians and
counts, not widest gaps: on a few answers of some seeds one pair on the
inlier threshold, or one LM step near rho = 0, falls the other way in
float32 than in float64 and moves that answer's pose by centimetres to
metres; ``extras`` reports the widest gaps beside them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.geometry import pose_gap

LEVER_M = 50.0
# Set from readings on the card (PERF.md section 2): sound runs put 0-1
# queries of 64-256 above 1e-3 m on the top pose and 2-7 of 256 above 3 cm
# on the final pose; the TF32 control puts nearly all of them there.
POSE_FAR_M = 1e-3
REFINED_FAR_M = 3e-2


def canonical(frames, votes):
    frames, votes = np.asarray(frames, np.int64), np.asarray(votes, np.int64)
    order = np.lexsort((frames, -votes), axis=-1)
    return np.take_along_axis(frames, order, -1), np.take_along_axis(votes, order, -1)


def _gap(a, b) -> np.ndarray:
    return pose_gap(torch.as_tensor(a), torch.as_tensor(b), LEVER_M).numpy()


def _median(x) -> float:
    return float(np.median(x)) if x.size else 0.0


def per_query(ids, gaps, n: int) -> np.ndarray:
    """The widest gap of each query id below ``n`` over its answers (-1
    where it has none)."""
    out = np.full(n, -1.0)
    np.maximum.at(out, ids, gaps)
    return out


def gaps(answers, ref: dict) -> dict:
    """answers: [(query ids, answer dict of arrays over those queries)];
    ref: the reference's arrays over all queries (``reference.pipeline``).
    Per answer: which integers differ, and the pose gaps with the query
    ids they belong to."""
    ids = np.concatenate([q for q, _ in answers])
    got = {k: np.concatenate([a[k] for _, a in answers]) for k in answers[0][1]}
    want = {k: v[ids] for k, v in ref.items()}
    gf, gv = canonical(got["frames"], np.rint(got["votes"]))
    wf, wv = canonical(want["frames"], want["votes"])
    found = got["found"] & want["found"]
    best_off = found & (got["best_frame"] != want["best_frame"])
    cand = ((got["num_desc"] != want["num_desc"]) | (gf != wf).any(-1) | (gv != wv).any(-1)
            | (got["found"] != want["found"]) | best_off)
    # The reference's pose for the program's best keyframe.
    at = want["frames"] == got["best_frame"][:, None]
    both = found & at.any(-1)
    j = at.argmax(-1)
    rows = np.arange(ids.size)
    out = {"ids": ids, "n": len(ref["found"]), "cand": cand, "best_off": best_off, "top_ids": ids[both],
           "top": _gap(got["pose"][both], want["cand_pose"][rows, j][both])}
    if "refined" in want:
        ok = want["rerank_ok"] & found
        out.update(refined_off=ok & (got["refined"] != want["refined"]), fin_ids=ids[ok],
                   fin=_gap(got["final_pose"][ok], want["final_pose"][ok]))
    return out


def far(g: dict, kind: str, threshold: float) -> int:
    """Queries with an answer whose ``kind`` ("top" or "fin") gap is above
    ``threshold``."""
    return int((per_query(g[f"{kind}_ids"], g[kind], g["n"]) > threshold).sum())


def numbers(answers, ref: dict) -> dict:
    """The compared numbers, the answers counted and ``extras``."""
    g = gaps(answers, ref)
    out = {"cand_off": int(g["cand"].sum()), "pose_gap_med_m": _median(g["top"]),
           "pose_far_n": far(g, "top", POSE_FAR_M)}
    extras = {"pose_gap_max_m": float(g["top"].max(initial=0.0)), "best_frame_off": int(g["best_off"].sum())}
    if "fin" in g:
        out.update(refined_off=int(g["refined_off"].sum()), refined_gap_med_m=_median(g["fin"]),
                   refined_far_n=far(g, "fin", REFINED_FAR_M))
        extras["refined_gap_max_m"] = float(g["fin"].max(initial=0.0))
    out["answers"] = int(g["ids"].size)
    out["extras"] = extras
    return out


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    table = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    return all(nums[k] <= limits[k] for k in limits), table
