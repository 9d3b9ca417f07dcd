"""The plain reference of a cell: every answer the timed path gives,
worked out again from the cell's inputs.

Descriptors, database and candidate search as ``descriptors`` and
``search`` define them; verification as STDesc.cpp:462-547 with the
configuration's hypothesis sampling (every ``n // max_hypotheses + 1``-th
pair, at most ``max_hypotheses``), inliers within ``verify_dis_threshold``
on all three vertices, the first hypothesis of most inliers, accepted from
``min_hypothesis_votes``, and the pose refitted by Kabsch over every
inlier vertex (two inlier pairs or more); candidates ranked by inliers
(stable); found above ``icp_threshold``. In refined cells the top
``rerank_k`` candidates of each query align by GICP (``gicp``) and the
guarded pick of semantic_graph_localization.cpp:651-747 chooses the pose.

Imports nothing of the program; the program's outputs are only judged.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import descriptors, gicp, search
from portbench.reference.geometry import Arith, kabsch, to_mat, transform
from portbench.reference.params import Params, params_of


def _stack(graphs, field, dev):
    return torch.as_tensor(np.stack([getattr(g, field) for g in graphs]), device=dev)


def _verify(ar: Arith, db: search.DB, qverts, q: search.Query, p: Params):
    """Per candidate (vote order): score, rot, trans."""
    c_n, n_pair, h = q.frames.numel(), p.pairs_per_candidate, p.max_hypotheses
    dev = qverts.device
    vq = torch.zeros((c_n, n_pair, 3, 3), dtype=ar.dtype, device=dev)
    vdb = torch.zeros_like(vq)
    valid = torch.zeros((c_n, n_pair), dtype=torch.bool, device=dev)
    for c, (qi, ri) in enumerate(zip(q.pair_q, q.pair_row)):
        vq[c, : qi.numel()] = qverts[qi].to(ar.dtype)
        vdb[c, : qi.numel()] = db.verts[ri].to(ar.dtype)
        valid[c, : qi.numel()] = True
    n = valid.sum(-1)
    skip = n // h + 1
    ar_h = torch.arange(h, device=dev)
    h_idx = (ar_h[None] * skip[:, None]).clamp(max=n_pair - 1)
    h_ok = ar_h[None] < (n // skip)[:, None]
    cc = torch.arange(c_n, device=dev)[:, None]
    rot_h, t_h = kabsch(ar, vq[cc, h_idx], vdb[cc, h_idx])  # (C, H, 3, 3)
    thr2 = p.verify_dis_threshold ** 2
    votes = []
    for c in range(c_n):  # (H, P, 3) a candidate
        moved = transform(ar, rot_h[c][:, None], t_h[c][:, None], vq[c][None])
        d2 = ((moved - vdb[c][None]) ** 2).sum(-1)
        votes.append(((d2 < thr2).all(-1) & valid[c][None]).sum(-1))
    votes = torch.where(h_ok, torch.stack(votes), -1)
    best = votes.argmax(-1)
    accepted = (votes.max(-1).values >= p.min_hypothesis_votes) & q.valid
    rot_b, t_b = rot_h[cc[:, 0], best], t_h[cc[:, 0], best]
    moved = transform(ar, rot_b[:, None], t_b[:, None], vq)
    inl = (((moved - vdb) ** 2).sum(-1) < thr2).all(-1) & valid  # (C, P)
    score = torch.where(accepted, inl.sum(-1).to(ar.dtype), -1.0)
    w3 = inl[..., None].expand(c_n, n_pair, 3).reshape(c_n, 3 * n_pair).to(ar.dtype)
    rot_r, t_r = kabsch(ar, vq.reshape(c_n, -1, 3), vdb.reshape(c_n, -1, 3), w3)
    use = accepted & (inl.sum(-1) >= 2)
    rot = torch.where(use[:, None, None], rot_r, rot_b)
    trans = torch.where(use[:, None], t_r, t_b)
    return score, rot, trans, accepted


def answers(inputs: dict, config: dict, traffic: dict, device, control: bool = False) -> dict:
    """The reference's answer to every query of the cell, as NumPy arrays
    over queries: descriptor counts, candidates and votes in vote order
    with each candidate's score (inliers, -1 when rejected) and world pose,
    found, best frame, the top candidate's world pose and, in refined
    cells, the refined flag, the final pose and whether all ``rerank_k``
    candidates passed verification."""
    p = params_of(config)
    ar = Arith(control)
    dev = torch.device(device)
    maps, queries = inputs["maps"], inputs["queries"]
    md = descriptors.build_chunked(_stack(maps, "centers", dev), _stack(maps, "labels", dev),
                                   _stack(maps, "mask", dev), p)
    db = search.build_db(md, np.stack([g.pose for g in maps]), p)
    del md
    qd = descriptors.build_chunked(_stack(queries, "centers", dev), _stack(queries, "labels", dev),
                                   _stack(queries, "mask", dev), p)
    first = range(min(p.calibrate_queries, len(queries)))
    budget = search.scan_budget([search.scan_total(db, qd.sides[i], qd.labels[i], qd.mask[i], p) for i in first], p)

    n_q, k = len(queries), traffic.get("rerank_k", 0)
    c_n = min(p.candidate_num, db.f_pad)
    out = {
        "num_desc": qd.count.cpu().numpy(), "frames": np.zeros((n_q, c_n), np.int64),
        "votes": np.zeros((n_q, c_n), np.int64), "found": np.zeros(n_q, bool),
        "best_frame": np.full(n_q, -1, np.int64), "pose": np.zeros((n_q, 4, 4)), "trunc": np.zeros(n_q, bool),
        "cand_score": np.zeros((n_q, c_n)), "cand_pose": np.zeros((n_q, c_n, 4, 4)),
    }
    poses_db = db.poses.to(ar.dtype)
    rerank = []
    for i in range(n_q):
        q = search.query(db, qd.sides[i], qd.labels[i], qd.mask[i], p, budget)
        score, rot, trans, accepted = _verify(ar, db, qd.verts[i], q, p)
        order = torch.sort(-score, stable=True).indices
        frames = q.frames[order]
        poses = ar.mm(poses_db[frames], to_mat(rot[order], trans[order]))
        found = bool(score[order[0]] > p.icp_threshold)
        out["frames"][i], out["votes"][i] = q.frames.cpu().numpy(), q.cand_votes.cpu().numpy()
        out["found"][i], out["trunc"][i] = found, q.trunc
        out["best_frame"][i] = int(frames[0]) if found else -1
        out["pose"][i] = poses[0].double().cpu().numpy()
        back = torch.argsort(order)  # vote order again
        out["cand_score"][i] = score.double().cpu().numpy()
        out["cand_pose"][i] = poses[back].double().cpu().numpy()
        if k:
            rerank.append((frames[:k], rot[order][:k], trans[order][:k], poses[:k], found,
                           bool(accepted[order][:k].all())))
    if k:
        out.update(_rerank(ar, inputs, db, rerank, p))
    return out


def _rerank(ar: Arith, inputs, db, rerank, p: Params, chunk: int = 64) -> dict:
    """GICP of every query's top-K candidates and the guarded pick."""
    dev = db.poses.device
    f = lambda x: torch.as_tensor(x, device=dev)
    qc, qm = f(inputs["query_clouds"]).to(ar.dtype), f(inputs["query_masks"])
    mc, mm = f(inputs["map_clouds"]).to(ar.dtype), f(inputs["map_masks"])
    need = sorted({int(x) for fr, *_ in rerank for x in fr.tolist()})
    slot = {fr: i for i, fr in enumerate(need)}
    mcov = gicp.covariances(ar, mc[need], mm[need], p)
    qcov = gicp.covariances(ar, qc, qm, p)
    k = rerank[0][0].numel()
    probs = [(i, j) for i in range(len(rerank)) for j in range(k)]
    T_all, fg_all, fr_all = [], [], []
    for s in range(0, len(probs), chunk):
        part = probs[s : s + chunk]
        qi = torch.tensor([i for i, _ in part], device=dev)
        fi = [int(rerank[i][0][j]) for i, j in part]
        ti = torch.tensor([slot[x] for x in fi], device=dev)
        T0 = torch.stack([to_mat(rerank[i][1][j], rerank[i][2][j]) for i, j in part])
        T, fg, frac = gicp.align(ar, qc[qi], qm[qi], qcov[qi], mc[fi], mm[fi], mcov[ti], T0, p)
        T_all.append(T)
        fg_all.append(fg)
        fr_all.append(frac)
    T_all, fg_all, fr_all = torch.cat(T_all), torch.cat(fg_all), torch.cat(fr_all)
    n_q = len(rerank)
    pose = np.zeros((n_q, 4, 4))
    refined = np.zeros(n_q, bool)
    all_ok = np.zeros(n_q, bool)
    poses_db = db.poses.to(ar.dtype)
    for i, (frames, _, _, init, found, ok) in enumerate(rerank):
        T = T_all[i * k : (i + 1) * k]
        ref = ar.mm(poses_db[frames], T)
        shift = torch.linalg.vector_norm(ref[:, :3, 3] - init[:, :3, 3], dim=-1)
        tr = ((ar.mm(ref[:, :3, :3], init[:, :3, :3].transpose(-1, -2))).diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
        rot_deg = torch.rad2deg(torch.arccos(tr.clamp(-1.0, 1.0)))
        guard = (shift <= p.max_refine_shift_m) & (rot_deg <= p.max_refine_rot_deg)
        score = torch.where(guard, fr_all[i * k : (i + 1) * k] - 0.1 * fg_all[i * k : (i + 1) * k], -torch.inf)
        use = found and bool(guard.any())
        refined[i] = use
        pose[i] = (ref[int(score.argmax())] if use else init[0]).double().cpu().numpy()
        all_ok[i] = ok
    return {"refined": refined, "final_pose": pose, "rerank_ok": all_ok}
