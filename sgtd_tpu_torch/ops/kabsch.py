"""K1 ``triangle_hypotheses`` and K2 ``verify_epilogue``: the Kabsch solves
of geometric verification (kernels in ``csrc/kabsch.cu``; no TPU kernel:
the reference solves them in plain jnp, ``sgtd_tpu/ops/linalg3.py``).

K1 samples each candidate's hypotheses from its pair list (the
reference's skip_len sampling, STDesc.cpp:467-482) and solves each: the
rigid transform of the pair's query triangle onto its DB triangle. K2
takes B3's votes over those hypotheses and finishes each candidate: the
best valid hypothesis (ties to the lowest index), its inlier mask over the
pairs, acceptance and score, and the weighted Kabsch over every inlier
vertex, falling back to the sampled pose below 2 inlier pairs.

Both take any leading dimensions before a candidate's (P, ...) axes and
flatten them to N = queries x candidates. A CUDA tensor launches the
hand-written kernel; a CPU tensor takes the plain PyTorch version, whose
arithmetic (``linalg3.kabsch``) is the oracle. There is no fallback
between the two.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sgtd_tpu_torch.ops import _build
from sgtd_tpu_torch.ops.linalg3 import kabsch
from sgtd_tpu_torch.utils import profiling, sqrt_rn

# Most hypotheses a candidate, as for B3 (ops/verify.py MAX_H).
MAX_H = 512


def triangle_hypotheses_plain(vq: torch.Tensor, vdb: torch.Tensor, pair_valid: torch.Tensor, h: int):
    """Plain version of K1 on (N, P, 3, 3) vertex triples and an (N, P)
    mask: (rot_h (N, H, 3, 3), t_h (N, H, 3)), every slot solved."""
    p = pair_valid.shape[-1]
    n_pairs = pair_valid.sum(-1, dtype=torch.int32)
    skip = n_pairs // h + 1
    ar = torch.arange(h, dtype=torch.int32, device=vq.device)
    h_idx = (ar * skip[..., None]).clamp(max=p - 1)  # (N, H)
    take_h = lambda x: torch.gather(x, -3, h_idx[..., None, None].long().expand(h_idx.shape + (3, 3)))
    return kabsch(take_h(vq), take_h(vdb))


def verify_epilogue_plain(votes_h, rot_h, t_h, vq, vdb, pair_valid, cand_valid, thr: float, min_votes: int):
    """Plain version of K2 on N candidates: (score (N,), rot (N, 3, 3),
    trans (N, 3), inliers (N, P), polished (N,)). The inlier test moves
    the query vertices by the best hypothesis and takes
    sqrt((d0^2 + d1^2) + d2^2) < thr on all three; the polish weighs each
    inlier vertex 1."""
    n, p = pair_valid.shape
    h = votes_h.shape[-1]
    n_pairs = pair_valid.sum(-1, dtype=torch.int32)
    use_size = n_pairs // (n_pairs // h + 1)
    ar = torch.arange(h, dtype=torch.int32, device=votes_h.device)
    votes_h = torch.where(ar < use_size[..., None], votes_h, -1)

    # Best hypothesis, ties to the lowest index.
    max_vote = votes_h.max(-1).values
    best_h = torch.where(votes_h == max_vote[..., None], ar, h).min(-1).values
    rot_b = torch.gather(rot_h, -3, best_h[..., None, None, None].long().expand(n, 1, 3, 3))[..., 0, :, :]
    t_b = torch.gather(t_h, -2, best_h[..., None, None].long().expand(n, 1, 3))[..., 0, :]
    # Inlier mask of the best hypothesis only: norm < thr on all vertices.
    moved_b = torch.einsum("...ij,...pkj->...pki", rot_b, vq) + t_b[..., None, None, :]
    d = moved_b - vdb
    s = d * d
    d_b = sqrt_rn((s[..., 0] + s[..., 1]) + s[..., 2])  # (N, P, 3)
    inl_b = (d_b < thr).all(-1) & pair_valid

    accepted = (max_vote >= min_votes) & cand_valid
    score = torch.where(accepted, inl_b.to(torch.float32).sum(-1), -1.0)

    # Pose polish: weighted Kabsch over all inlier vertex correspondences,
    # falling back to the sampled hypothesis below 2 inlier pairs.
    w3 = inl_b.to(torch.float32)[..., None].expand(n, p, 3).reshape(n, 3 * p)
    rot_r, t_r = kabsch(vq.reshape(n, 3 * p, 3), vdb.reshape(n, 3 * p, 3), weights=w3)
    n_inl = inl_b.sum(-1, dtype=torch.int32)
    use_ref = accepted & (n_inl >= 2)
    rot_f = torch.where(use_ref[..., None, None], rot_r, rot_b)
    t_f = torch.where(use_ref[..., None], t_r, t_b)
    return score, rot_f, t_f, inl_b & accepted[..., None], use_ref


def _check_h(name: str, h: int) -> None:
    if not 1 <= h <= MAX_H:
        raise ValueError(f"{name}: {h} hypotheses a candidate, 1 to {MAX_H} allowed")


def triangle_hypotheses(vq: torch.Tensor, vdb: torch.Tensor, pair_valid: torch.Tensor, h: int):
    """vq, vdb (..., P, 3, 3) float32 vertex rows A, B, C of each pair's
    query and DB triangle; pair_valid (..., P) bool -> (rot_h (..., H, 3,
    3), t_h (..., H, 3)) float32: hypothesis k solves pair
    min(k * (n_pairs // H + 1), P - 1), n_pairs the valid pairs."""
    lead, p = tuple(pair_valid.shape[:-1]), pair_valid.shape[-1]
    f32 = torch.float32
    dev = _build.check("triangle_hypotheses", ("vq", vq, lead + (p, 3, 3), f32),
                       ("vdb", vdb, lead + (p, 3, 3), f32), ("pair_valid", pair_valid, lead + (p,), torch.bool))
    _check_h("triangle_hypotheses", h)
    n = math.prod(lead)
    profiling.count("verify.kabsch_problems", n * h)
    vq, vdb, pair_valid = vq.reshape(n, p, 3, 3), vdb.reshape(n, p, 3, 3), pair_valid.reshape(n, p)
    if dev.type == "cpu":
        rot_h, t_h = triangle_hypotheses_plain(vq, vdb, pair_valid, h)
    else:
        vq, vdb, pair_valid = vq.contiguous(), vdb.contiguous(), pair_valid.contiguous()
        rot_h, t_h = vq.new_empty((n, h, 3, 3)), vq.new_empty((n, h, 3))
        _build.launch("sgtd_triangle_hypotheses", dev, vq.data_ptr(), vdb.data_ptr(), pair_valid.data_ptr(),
                      rot_h.data_ptr(), t_h.data_ptr(), n, h, p)
    return rot_h.reshape(lead + (h, 3, 3)), t_h.reshape(lead + (h, 3))


def verify_epilogue(votes_h, rot_h, t_h, vq, vdb, pair_valid, cand_valid, thr: float, min_votes: int):
    """votes_h (..., H) int32, B3's votes; rot_h (..., H, 3, 3), t_h (..., H,
    3) float32, K1's hypotheses; vq, vdb (..., P, 3, 3) float32; pair_valid
    (..., P), cand_valid (...) bool -> (score (...) float32, the inlier
    count or -1 where rejected; rot (..., 3, 3), trans (..., 3) float32;
    inliers (..., P) bool; polished (...) bool, whether the pose came from
    the polish and not from the sampled hypothesis)."""
    lead, h, p = tuple(votes_h.shape[:-1]), votes_h.shape[-1], pair_valid.shape[-1]
    f32, b = torch.float32, torch.bool
    dev = _build.check("verify_epilogue", ("votes_h", votes_h, lead + (h,), torch.int32),
                       ("rot_h", rot_h, lead + (h, 3, 3), f32), ("t_h", t_h, lead + (h, 3), f32),
                       ("vq", vq, lead + (p, 3, 3), f32), ("vdb", vdb, lead + (p, 3, 3), f32),
                       ("pair_valid", pair_valid, lead + (p,), b), ("cand_valid", cand_valid, lead, b))
    _check_h("verify_epilogue", h)
    n = math.prod(lead)
    profiling.count("verify.kabsch_problems", n)
    args = (votes_h.reshape(n, h), rot_h.reshape(n, h, 3, 3), t_h.reshape(n, h, 3), vq.reshape(n, p, 3, 3),
            vdb.reshape(n, p, 3, 3), pair_valid.reshape(n, p), cand_valid.reshape(n))
    if dev.type == "cpu":
        score, rot, trans, inliers, polished = verify_epilogue_plain(*args, thr, min_votes)
    else:
        args = [a.contiguous() for a in args]
        vq = args[3]
        score, rot, trans = vq.new_empty((n,)), vq.new_empty((n, 3, 3)), vq.new_empty((n, 3))
        inliers, polished = vq.new_empty((n, p), dtype=b), vq.new_empty((n,), dtype=b)
        _build.launch("sgtd_verify_epilogue", dev, *(a.data_ptr() for a in args), score.data_ptr(),
                      rot.data_ptr(), trans.data_ptr(), inliers.data_ptr(), polished.data_ptr(), n, h, p,
                      float(np.float32(thr)), int(min_votes))
    return (score.reshape(lead), rot.reshape(lead + (3, 3)), trans.reshape(lead + (3,)),
            inliers.reshape(lead + (p,)), polished.reshape(lead))
