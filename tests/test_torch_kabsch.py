"""Verification's Kabsch solves: the K1 ``triangle_hypotheses`` and K2
``verify_epilogue`` wrappers (sgtd_tpu_torch/ops/kabsch.py) on the CPU.

CPU tensors take the plain versions, so ``verify_pairs`` must give, bit
for bit, what it gave when it solved Kabsch inline (``_verify_pairs_inline``
below, the composition before the kernels) on the candidates of a world
searched by the JAX reference. The wrappers' contract (devices, dtypes,
shapes, the hypothesis limit) raises before any work. The CUDA kernels
run only on a card (tests/test_torch_kabsch_card.py, chip_smoke.py); here
the arithmetic they implement (csrc/kabsch.cu: the QCP solve of one
triangle in the plain version's rounding order, the epilogue's pick,
inlier test and two-pass polish) is written out in NumPy float32 and held
against the plain versions.
"""

import re

import numpy as np
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db.database import build_database, tuned_config
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.match.search import candidate_search as jax_candidate_search
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.match.verify import VerifyResult, verify_pairs
from sgtd_tpu_torch.ops import _build, kabsch as kabsch_ops, launch_counts
from sgtd_tpu_torch.ops import verify as verify_ops
from sgtd_tpu_torch.ops.linalg3 import kabsch
from sgtd_tpu_torch.utils import profiling, sqrt_rn

torch.set_num_threads(1)
f32 = np.float32


@pytest.fixture(scope="module")
def world(small_config):
    """Per query of a small world: the vertex triples, pair mask and
    candidate mask of its candidates, as the JAX reference's search finds
    them (the inputs of verify_pairs)."""
    cfg = small_config
    maps, queries, _ = make_map_and_queries(
        cfg, seed=13, num_map_frames=24, num_queries=4,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    descs = [jax_build_descriptors(g, cfg.desc, cfg.caps) for g in maps]
    db, report = build_database(descs, [np.asarray(g.pose) for g in maps], cfg.desc, cfg.caps)
    cfg = tuned_config(cfg, report)
    out = []
    for g in queries:
        q = jax_build_descriptors(g, cfg.desc, cfg.caps)
        cand = jax_candidate_search(db, q, cfg.desc, cfg.search, cfg.caps)
        arrays = (q.vertices[cand.pair_qidx], db.vertices[cand.pair_row], cand.pair_valid, cand.valid)
        out.append(tuple(torch.tensor(np.asarray(a)) for a in arrays))
    return interop.config_from_reference(cfg).search, out


def _verify_pairs_inline(vq, vdb, pair_valid, cand_valid, search):
    """verify_pairs as it was before K1 and K2: sampling, linalg3.kabsch,
    B3's plain version, the pick, the inlier mask and the polish inline."""
    lead, p, h = pair_valid.shape[:-1], pair_valid.shape[-1], search.max_hypotheses
    n_pairs = pair_valid.sum(-1, dtype=torch.int32)
    skip = n_pairs // h + 1
    use_size = n_pairs // skip
    ar = torch.arange(h, dtype=torch.int32)
    h_idx = (ar * skip[..., None]).clamp(max=p - 1)
    h_valid = ar < use_size[..., None]
    take_h = lambda x: torch.gather(x, -3, h_idx[..., None, None].long().expand(lead + (h, 3, 3)))
    rot_h, t_h = kabsch(take_h(vq), take_h(vdb))
    n = pair_valid[..., 0].numel()
    votes_h = verify_ops.hypothesis_votes_plain(
        rot_h.reshape(n, h, 3, 3), t_h.reshape(n, h, 3), vq.reshape(n, p, 3, 3), vdb.reshape(n, p, 3, 3),
        pair_valid.reshape(n, p), search.verify_dis_threshold,
    ).reshape(lead + (h,))
    votes_h = torch.where(h_valid, votes_h, -1)
    max_vote = votes_h.max(-1).values
    best_h = torch.where(votes_h == max_vote[..., None], ar, h).min(-1).values
    rot_b = torch.gather(rot_h, -3, best_h[..., None, None, None].long().expand(lead + (1, 3, 3)))[..., 0, :, :]
    t_b = torch.gather(t_h, -2, best_h[..., None, None].long().expand(lead + (1, 3)))[..., 0, :]
    moved_b = torch.einsum("...ij,...pkj->...pki", rot_b, vq) + t_b[..., None, None, :]
    d = moved_b - vdb
    s = d * d
    d_b = sqrt_rn((s[..., 0] + s[..., 1]) + s[..., 2])
    inl_b = (d_b < search.verify_dis_threshold).all(-1) & pair_valid
    accepted = (max_vote >= search.min_hypothesis_votes) & cand_valid
    score = torch.where(accepted, inl_b.to(torch.float32).sum(-1), -1.0)
    w3 = inl_b.to(torch.float32)[..., None].expand(lead + (p, 3)).reshape(lead + (3 * p,))
    rot_r, t_r = kabsch(vq.reshape(lead + (3 * p, 3)), vdb.reshape(lead + (3 * p, 3)), weights=w3)
    n_inl = inl_b.sum(-1, dtype=torch.int32)
    use_ref = (accepted & (n_inl >= 2))[..., None]
    return VerifyResult(score, torch.where(use_ref[..., None], rot_r, rot_b), torch.where(use_ref, t_r, t_b),
                        inl_b & accepted[..., None])


@pytest.mark.parametrize("query", range(4))
def test_cpu_verify_pairs_takes_the_plain_path_and_keeps_its_bits(world, query):
    search, inputs = world
    vq, vdb, pv, cv = inputs[query]
    before = launch_counts()
    got = verify_pairs(vq, vdb, pv, cv, search)
    want = _verify_pairs_inline(vq, vdb, pv, cv, search)
    assert launch_counts() == before
    for name in VerifyResult._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert bool((got.scores >= 0).any())


def test_leading_dimensions_are_flattened_and_restored(world):
    search, inputs = world
    stack = lambda i: torch.stack([x[i] for x in inputs])
    vq, vdb, pv, cv = (stack(i) for i in range(4))  # (B, C, ...)
    h = search.max_hypotheses
    rot_h, t_h = kabsch_ops.triangle_hypotheses(vq, vdb, pv, h)
    assert rot_h.shape == vq.shape[:2] + (h, 3, 3) and t_h.shape == vq.shape[:2] + (h, 3)
    votes = torch.zeros(vq.shape[:2] + (h,), dtype=torch.int32)
    out = kabsch_ops.verify_epilogue(votes, rot_h, t_h, vq, vdb, pv, cv, search.verify_dis_threshold, 0)
    assert [tuple(o.shape) for o in out] == [tuple(vq.shape[:2]), tuple(vq.shape[:2]) + (3, 3),
                                             tuple(vq.shape[:2]) + (3,), tuple(pv.shape), tuple(cv.shape)]
    for b in range(vq.shape[0]):
        one = kabsch_ops.triangle_hypotheses(vq[b], vdb[b], pv[b], h)
        assert torch.equal(one[0], rot_h[b]) and torch.equal(one[1], t_h[b])
        one = kabsch_ops.verify_epilogue(votes[b], rot_h[b], t_h[b], vq[b], vdb[b], pv[b], cv[b],
                                         search.verify_dis_threshold, 0)
        assert all(torch.equal(x, y[b]) for x, y in zip(one, out))


def test_the_counters_record_problems_and_the_polished_share(world):
    search, inputs = world
    vq, vdb, pv, cv = inputs[0]
    c, h = pv.shape[0], search.max_hypotheses
    tracer = profiling.enable()
    try:
        ver = verify_pairs(vq, vdb, pv, cv, search)
        profiling.flush()
    finally:
        profiling.disable()
    assert [v for _, v in tracer.counters["verify.kabsch_problems"]] == [c * h, c]
    polished = sum(v for _, v in tracer.counters["verify.polished"])
    n_inl = ver.inliers.sum(-1)
    assert polished == int(((ver.scores >= 0) & (n_inl >= 2)).sum()) > 0


def _args(n=3, h=5, p=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    vq = torch.randn(n, p, 3, 3, generator=g, dtype=dtype)
    vdb = torch.randn(n, p, 3, 3, generator=g, dtype=dtype)
    pv = torch.arange(p)[None].expand(n, p) < torch.tensor([[0], [3], [p]])[:n]
    votes = torch.randint(0, p, (n, h), generator=g, dtype=torch.int32)
    rot = torch.eye(3, dtype=dtype).expand(n, h, 3, 3).contiguous()
    t = torch.zeros(n, h, 3, dtype=dtype)
    return dict(votes_h=votes, rot_h=rot, t_h=t, vq=vq, vdb=vdb, pair_valid=pv, cand_valid=torch.ones(n, dtype=torch.bool))


def _k1(a, h=5):
    return kabsch_ops.triangle_hypotheses(a["vq"], a["vdb"], a["pair_valid"], h)


def _k2(a):
    return kabsch_ops.verify_epilogue(*a.values(), 3.0, 2)


def _with(**changes):
    a = _args()
    a.update({k: v(a) for k, v in changes.items()})
    return a


_BAD = {
    "K1 mixed devices": (lambda: _k1(_with(vdb=lambda a: a["vdb"].to("meta"))), ValueError, "one device"),
    "K2 mixed devices": (lambda: _k2(_with(cand_valid=lambda a: a["cand_valid"].to("meta"))), ValueError,
                         "one device"),
    "K1 on a device that is neither": (
        lambda: _k1({k: v.to("meta") for k, v in _args().items()}), ValueError, "CUDA tensors required"),
    "K2 on a device that is neither": (
        lambda: _k2({k: v.to("meta") for k, v in _args().items()}), ValueError, "CUDA tensors required"),
    "K1 float64 vertices": (lambda: _k1(_args(dtype=torch.float64)), TypeError, "vq must be torch.float32"),
    "K2 float64 hypotheses": (lambda: _k2(_with(rot_h=lambda a: a["rot_h"].double())), TypeError,
                              "rot_h must be torch.float32"),
    "K2 int64 votes": (lambda: _k2(_with(votes_h=lambda a: a["votes_h"].long())), TypeError,
                       "votes_h must be torch.int32"),
    "K1 a float mask": (lambda: _k1(_with(pair_valid=lambda a: a["pair_valid"].float())), TypeError,
                        "pair_valid must be torch.bool"),
    "K1 vdb of other pairs": (lambda: _k1(_with(vdb=lambda a: a["vdb"][:, :-1])), ValueError, "vdb of shape"),
    "K1 vertices of two coordinates": (lambda: _k1(_with(vq=lambda a: a["vq"][..., :2])), ValueError,
                                       "vq of shape"),
    "K2 votes of other candidates": (lambda: _k2(_with(votes_h=lambda a: a["votes_h"][:-1])), ValueError,
                                     "rot_h of shape"),
    "K2 hypotheses of another count": (lambda: _k2(_with(t_h=lambda a: a["t_h"][:, :-1])), ValueError,
                                       "t_h of shape"),
    "K2 a candidate mask of pairs": (lambda: _k2(_with(cand_valid=lambda a: a["pair_valid"])), ValueError,
                                     "cand_valid of shape"),
    "K1 H above the limit": (lambda: _k1(_args(), kabsch_ops.MAX_H + 1), ValueError, "hypotheses a candidate"),
    "K1 no hypotheses": (lambda: _k1(_args(), 0), ValueError, "hypotheses a candidate"),
    "K2 H above the limit": (
        lambda: _k2(_with(votes_h=lambda a: torch.zeros(3, kabsch_ops.MAX_H + 1, dtype=torch.int32),
                          rot_h=lambda a: torch.zeros(3, kabsch_ops.MAX_H + 1, 3, 3),
                          t_h=lambda a: torch.zeros(3, kabsch_ops.MAX_H + 1, 3))),
        ValueError, "hypotheses a candidate"),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_the_wrappers_raise_on_what_the_kernels_do_not_take(case):
    call, err, match = _BAD[case]
    before = launch_counts()
    with pytest.raises(err, match=match):
        call()
    assert launch_counts() == before


# -- step-by-step models of csrc/kabsch.cu ---------------------------------------

K = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", (_build.CSRC / "kabsch.cu").read_text())}


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(f32)


def _dot3(a0, b0, a1, b1, a2, b2):
    return _fma(a2, b2, _fma(a1, b1, a0 * b0))


def _det3(a, b, c, d, e, f, g, h, i):
    return (a * (e * i - f * h) - b * (d * i - f * g)) + c * (d * h - e * g)


def _minor_det(m, r, c):
    rows = [k for k in range(4) if k != r]
    cols = [k for k in range(4) if k != c]
    return _det3(*(m[..., i, j] for i in rows for j in cols))


def _qcp_rotation(H):
    """csrc/kabsch.cu qcp_rotation on (M, 3, 3) float32."""
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = [[H[:, i, j] for j in range(3)] for i in range(3)]
    Km = np.stack([
        np.stack([(sxx + syy) + szz, syz - szy, szx - sxz, sxy - syx], -1),
        np.stack([syz - szy, (sxx - syy) - szz, sxy + syx, szx + sxz], -1),
        np.stack([szx - sxz, sxy + syx, (-sxx + syy) - szz, syz + szy], -1),
        np.stack([sxy - syx, szx + sxz, syz + szy, (-sxx - syy) + szz], -1),
    ], -2)
    hh = (H * H).reshape(-1, 9)
    sum9 = (((hh[:, 0] + hh[:, 8]) + hh[:, 4]) + (hh[:, 2] + hh[:, 6])) + ((hh[:, 1] + hh[:, 5]) + (hh[:, 3] + hh[:, 7]))
    c2 = f32(-2) * sum9
    c1 = f32(-8) * _det3(sxx, sxy, sxz, syx, syy, syz, szx, szy, szz)
    c0 = Km[:, 0, 0] * _minor_det(Km, 0, 0)
    for j in range(1, 4):
        c0 = c0 + (f32((-1) ** j) * Km[:, 0, j]) * _minor_det(Km, 0, j)
    lam = np.ones_like(c2)
    for _ in range(K["kNewton"]):
        p = (((lam * lam + c2) * lam + c1) * lam) + c0
        dp = ((f32(4) * lam) * lam + f32(2) * c2) * lam + c1
        lam = lam - p / np.where(np.abs(dp) > f32(1e-12), dp, f32(1e-12))
    A = Km.copy()
    for i in range(4):
        A[:, i, i] = Km[:, i, i] - lam
    cof = np.stack([np.stack([f32((-1) ** (i + j)) * _minor_det(A, i, j) for j in range(4)], -1)
                    for i in range(4)], -2)
    sq = cof * cof
    norms = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3]
    q = cof[np.arange(len(H)), norms.argmax(-1)]
    qq = q * q
    qn = np.sqrt((qq[:, 0] + qq[:, 2]) + (qq[:, 1] + qq[:, 3]))
    ok = qn > f32(1e-12)
    q = np.where(ok[:, None], q / (qn + f32(1e-12))[:, None], np.array([1, 0, 0, 0], f32))
    w, x, y, z = q.T
    two, one = f32(2), f32(1)
    return np.stack([
        one - two * (y * y + z * z), two * (x * y - w * z), two * (x * z + w * y),
        two * (x * y + w * z), one - two * (x * x + z * z), two * (y * z - w * x),
        two * (x * z - w * y), two * (y * z + w * x), one - two * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def _translation(R, mu_s, mu_r):
    return mu_r - (_fma(R[..., 1], mu_s[:, None, 1], R[..., 0] * mu_s[:, None, 0]) + R[..., 2] * mu_s[:, None, 2])


def _kabsch3_model(src, ref):
    """csrc/kabsch.cu kabsch3 on (M, 3, 3) float32 triangles (rows A, B,
    C); the kernel's rsqrtf taken as the correctly rounded 1/sqrt."""
    wn = f32(1) / f32(3)
    mu_s = ((src[:, 0] * wn + src[:, 1] * wn) + src[:, 2] * wn)
    mu_r = ((ref[:, 0] * wn + ref[:, 1] * wn) + ref[:, 2] * wn)
    s, r = src - mu_s[:, None], ref - mu_r[:, None]
    inner = lambda x: (x[..., 0] + x[..., 2]) + x[..., 1]
    sigma2 = f32(0.5) * (inner(wn * inner(s * s)) + inner(wn * inner(r * r)))
    inv = (1.0 / np.sqrt(sigma2.astype(np.float64) + 1e-12)).astype(f32)
    sw, r = (s * inv[:, None, None]) * wn, r * inv[:, None, None]
    H = _dot3(sw[:, 0, :, None], r[:, 0, None, :], sw[:, 1, :, None], r[:, 1, None, :], sw[:, 2, :, None],
              r[:, 2, None, :])
    R = _qcp_rotation(H)
    return R, _translation(R, mu_s, mu_r)


def _triangles(rng, m, kind):
    src = rng.uniform(-30, 30, (m, 3, 3)).astype(f32)
    if kind == "collinear":
        src = (src[:, :1] + np.linspace(0, 1, 3, dtype=f32)[None, :, None] * (src[:, 2:] - src[:, :1])).astype(f32)
    ang = rng.uniform(-np.pi, np.pi, m)
    rot = np.zeros((m, 3, 3), f32)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
    rot[:, 2, 2] = 1
    ref = (np.einsum("bij,bnj->bni", rot, src) + rng.normal(0, 20, (m, 1, 3))
           + rng.normal(0, 0.05, src.shape)).astype(f32)
    if kind == "coincident":
        src[:] = src[:, :1]
    return src, ref


@pytest.mark.parametrize("kind", ["well_shaped", "collinear", "coincident"])
def test_the_kernel_solve_of_a_triangle_agrees_with_the_plain_version(kind):
    """K1's arithmetic against linalg3.kabsch on the CPU, whose einsum and
    sums round in another order than torch's on the card: well-shaped
    triangles agree to float32 rounding (rotation entries within 5e-6,
    translations of up to 80 m within 1e-4 m). A collinear triangle leaves
    the rotation about its line to rounding, in both versions alike (12
    Newton steps on a double root, an adjugate near 0): there both must give
    rotations, orthonormal within 1e-4.
    Coincident source points give the identity in both."""
    rng = np.random.default_rng({"well_shaped": 1, "collinear": 2, "coincident": 3}[kind])
    src, ref = _triangles(rng, 400, kind)
    if kind == "well_shaped":
        sv = np.linalg.svd(src - src.mean(1, keepdims=True), compute_uv=False)
        keep = sv[:, 1] > 0.3 * sv[:, 0]
        src, ref = src[keep], ref[keep]
    R, t = _kabsch3_model(src, ref)
    want_r, want_t = (x.numpy() for x in kabsch(torch.from_numpy(src), torch.from_numpy(ref)))
    assert np.isfinite(R).all() and np.isfinite(t).all()
    if kind == "collinear":
        for rot in (R, want_r):
            np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape), atol=1e-4)
            np.testing.assert_allclose(np.linalg.det(rot.astype(np.float64)), 1.0, atol=1e-4)
        return
    if kind == "coincident":
        for rot in (R, want_r):
            np.testing.assert_allclose(rot, np.broadcast_to(np.eye(3), rot.shape), atol=1e-6, rtol=0)
    np.testing.assert_allclose(R, want_r, atol=5e-6, rtol=0)
    np.testing.assert_allclose(t, want_t, atol=1e-4, rtol=0)


def _epilogue_model(votes, rot_h, t_h, vq, vdb, pv, cv, thr, min_votes, threads):
    """csrc/kabsch.cu verify_epilogue_kernel, a candidate at a time, its
    block's threads taking pairs tid, tid + threads, ...: (score, rot,
    trans, inliers, polished)."""
    n, h = votes.shape
    p = pv.shape[1]
    out = ([], [], [], [], [])
    for c in range(n):
        n_pairs = int(pv[c].sum())
        use_size = n_pairs // (n_pairs // h + 1)
        masked = np.where(np.arange(h) < use_size, votes[c], -1)
        hb = int(np.flatnonzero(masked == masked.max())[0])
        accepted = bool(masked.max() >= min_votes and cv[c])
        Rb, tb = rot_h[c, hb], t_h[c, hb]
        moved = _dot3(Rb[None, None, :, 0], vq[c, :, :, None, 0], Rb[None, None, :, 1], vq[c, :, :, None, 1],
                      Rb[None, None, :, 2], vq[c, :, :, None, 2]) + tb
        s = (moved - vdb[c]) ** 2
        dist = np.sqrt(((s[..., 0] + s[..., 1]) + s[..., 2]).astype(np.float64)).astype(f32)
        inl = (dist < f32(thr)).all(-1) & pv[c]
        n_inl = int(inl.sum())
        use_ref = accepted and n_inl >= 2
        R, t = Rb, tb
        if use_ref:
            lanes = [np.flatnonzero(inl[tid::threads]) * threads + tid for tid in range(threads)]
            verts = lambda x, ps: x[c, ps].reshape(-1, 3)
            part = [verts(vq, ps).sum(0, dtype=f32) for ps in lanes]  # each thread's sums, then the block's
            wn = f32(1) / f32(3 * n_inl)
            mu_s = np.sum(part, 0, dtype=f32) * wn
            mu_r = np.sum([verts(vdb, ps).sum(0, dtype=f32) for ps in lanes], 0, dtype=f32) * wn
            sv, rv = verts(vq, np.flatnonzero(inl)) - mu_s, verts(vdb, np.flatnonzero(inl)) - mu_r
            sigma2 = f32(0.5) * (wn * (sv * sv).sum(dtype=f32) + wn * (rv * rv).sum(dtype=f32))
            inv = f32(1.0 / np.sqrt(float(sigma2) + 1e-12))
            H = (sv[:, :, None] * rv[:, None, :]).sum(0, dtype=f32) * (wn * inv * inv)
            R = _qcp_rotation(H[None])[0]
            t = _translation(R[None], mu_s[None], mu_r[None])[0]
        for lst, v in zip(out, (f32(n_inl) if accepted else f32(-1), R, t, inl & accepted, use_ref)):
            lst.append(v)
    return tuple(np.stack(x) for x in out)


def _epilogue_threads(p):
    t = -(-(-(-p // K["kPairsPerThread"])) // 32) * 32
    return min(max(t, 32), K["kMaxEpilogueThreads"])


@pytest.mark.parametrize("p,h,mask", [(128, 50, "prefix"), (130, 7, "prefix"), (40, 50, "holes"), (1, 1, "all")])
def test_the_kernel_epilogue_agrees_with_the_plain_version(world, p, h, mask):
    """K2's arithmetic against verify_epilogue_plain on the world's
    candidates (their first p pairs, hypotheses from K1's plain version,
    votes from B3's): scores and inlier masks equal, poses of the polish
    within 1e-5 (rotation entries) and 1e-4 m, every sampled pose equal."""
    search, inputs = world
    vq, vdb, pv, cv = (torch.cat([x[i] for x in inputs]) for i in range(4))
    vq, vdb, pv = vq[:, :p].contiguous(), vdb[:, :p].contiguous(), pv[:, :p].contiguous()
    if mask == "holes":
        pv = pv | (torch.arange(p) % 3 == 0)
    elif mask == "all":
        pv = torch.ones_like(pv)
    rot_h, t_h = kabsch_ops.triangle_hypotheses(vq, vdb, pv, h)
    votes = verify_ops.hypothesis_votes(rot_h, t_h, vq, vdb, pv, search.verify_dis_threshold)
    want = kabsch_ops.verify_epilogue_plain(votes, rot_h, t_h, vq, vdb, pv, cv, search.verify_dis_threshold,
                                            search.min_hypothesis_votes)
    got = _epilogue_model(*(x.numpy() for x in (votes, rot_h, t_h, vq, vdb, pv, cv)), search.verify_dis_threshold,
                          search.min_hypothesis_votes, _epilogue_threads(p))
    want = [x.numpy() for x in want]
    for i in (0, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])
    pol = want[4]
    assert 0 < pol.sum() or mask == "all"
    np.testing.assert_allclose(got[1][pol], want[1][pol], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2][pol], want[2][pol], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[1][~pol], want[1][~pol])
    np.testing.assert_array_equal(got[2][~pol], want[2][~pol])
