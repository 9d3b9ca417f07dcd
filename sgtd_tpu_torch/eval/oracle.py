"""Slow, obviously-correct NumPy transliteration of the reference
descriptor pipeline — the parity oracle (port of sgtd_tpu.eval.oracle, the
same code on the port's config types).

This module re-implements, with plain Python loops and no cleverness, the
EXACT semantics of the reference's core IP so the fast pipeline can be
property-tested against it:

  * ``Combinatorial_Binary_Encoding``  (src/sgtd/src/STDesc.cpp:3-16)
  * ``STDescManager::BuildSingleScanSTD``  (STDesc.cpp:174-315)
  * ``STDescManager::AddSTDescs``  (STDesc.cpp:149-172)
  * ``STDescManager::candidate_selector``  (STDesc.cpp:318-460)
  * ``STDescManager::candidate_verify``  (STDesc.cpp:462-547)
  * ``STDescManager::triangle_solver``  (STDesc.cpp:549-571)
  * ``STDescManager::SearchLoop``  (STDesc.cpp:84-147)

Every non-obvious line carries the reference file:line it transliterates.
It is NOT used by the production pipeline; the reference's
tests/test_reference_oracle.py holds its pipeline to it, and
``chip_smoke.py`` phase 7 holds the port's success rate on a subsample of
the hard world to it.

Documented deviations of the production pipeline, switchable here so both
sides can be compared exactly:

  * ``dtype``: the reference computes in C++ double; the production pipeline
    computes descriptors in float32. ``dtype=np.float32`` mirrors the
    pipeline's arithmetic (all sums/sqrts in float32), ``np.float64`` is
    reference-true. A dedicated test bounds the drift between the two.
  * ``fixed_point_filter``: the production rough side-length filter runs on
    1/256 fixed-point sides (DB packing, match/search.py); the reference
    compares floats. ``True`` mirrors the pipeline, ``False`` is
    reference-true. Max perturbation per side is 1/512 cell — two orders
    below the 0.03 * ||sides|| threshold; a dedicated test bounds the vote
    flips this can cause.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from sgtd_tpu_torch.config import DescriptorConfig, SearchConfig


def combinatorial_binary_encoding(a: int, b: int, c: int) -> int:
    """4-bit binary concatenation of the label triple (STDesc.cpp:3-16).

    std::bitset<4>(x) keeps the low 4 bits; the concatenated 12-bit string
    parsed base-2 is (a << 8) | (b << 4) | c.
    """
    return ((int(a) & 15) << 8) | ((int(b) & 15) << 4) | (int(c) & 15)


@dataclasses.dataclass
class OracleSTD:
    """One triangle descriptor (reference STDesc struct, STDesc.h:86-124)."""

    side_length: np.ndarray  # (3,) scaled, ascending
    angle: np.ndarray  # (3,)
    A: np.ndarray  # (3,)
    B: np.ndarray
    C: np.ndarray
    center: np.ndarray
    vertex_attached: Tuple[int, int, int]
    frame_id: int
    node_id: Tuple[int, int, int]  # (i, m, n) loop indices as the ref stores


def _norm(v: np.ndarray, dtype) -> np.ndarray:
    """sqrt of the ordered sum of squares, in dtype arithmetic."""
    v = v.astype(dtype)
    s = dtype(0.0)
    for k in range(v.shape[0]):
        s = dtype(s + v[k] * v[k])
    return dtype(np.sqrt(s))


def build_single_scan_std(
    points: np.ndarray,
    labels: np.ndarray,
    cfg: DescriptorConfig,
    frame_id: int,
    dtype=np.float64,
) -> List[OracleSTD]:
    """Transliteration of BuildSingleScanSTD (STDesc.cpp:174-315)."""
    pts = np.asarray(points).astype(dtype)
    lab = np.asarray(labels).astype(np.int64)
    n = pts.shape[0]
    near_num = min(cfg.near_num, n)  # PCL returns at most cloud-size points
    scale = dtype(1.0) / dtype(cfg.side_resolution)  # STDesc.cpp:178
    max_len = cfg.max_len
    min_len = cfg.min_len
    feat_map = set()  # STDesc.cpp:182 feat_map
    out: List[OracleSTD] = []

    for i in range(n):
        # kd-tree kNN, self first; FLANN ranks by SQUARED distance
        # (STDesc.cpp:189-191), so no sqrt before the argsort.
        diff = (pts - pts[i]).astype(dtype)
        d2 = np.array(
            [dtype((diff[j] * diff[j]).sum(dtype=dtype)) for j in range(n)]
        )
        order = np.argsort(d2, kind="stable")[:near_num]
        for m in range(1, near_num - 1):  # STDesc.cpp:193
            for nn in range(m + 1, near_num):  # STDesc.cpp:194
                p1, p2, p3 = pts[i], pts[order[m]], pts[order[nn]]
                a = _norm(p1 - p2, dtype)  # STDesc.cpp:198
                b = _norm(p1 - p3, dtype)
                c = _norm(p3 - p2, dtype)
                if (
                    a > max_len or b > max_len or c > max_len
                    or a < min_len or b < min_len or c < min_len
                ):  # STDesc.cpp:204-208
                    continue
                # Literal vertex re-ranging bubble (STDesc.cpp:210-241).
                l1, l2, l3 = (1, 2, 0), (1, 0, 3), (0, 2, 3)
                if a > b:
                    a, b = b, a
                    l1, l2 = l2, l1
                if b > c:
                    b, c = c, b
                    l2, l3 = l3, l2
                if a > b:
                    a, b = b, a
                    l1, l2 = l2, l1
                # Dedup key: sides * 1000 squeezed through a float32 PCL
                # point field, then int64-truncated (STDesc.cpp:244-249).
                key = (
                    int(np.float32(a * dtype(1000.0))),
                    int(np.float32(b * dtype(1000.0))),
                    int(np.float32(c * dtype(1000.0))),
                )
                if key in feat_map:
                    continue
                feat_map.add(key)
                # Literal vertex selection (STDesc.cpp:252-291).
                pl = [(p1, int(lab[i])), (p2, int(lab[order[m]])),
                      (p3, int(lab[order[nn]]))]
                if l1[0] == l2[0]:
                    A, la = pl[0]
                elif l1[1] == l2[1]:
                    A, la = pl[1]
                else:
                    A, la = pl[2]
                if l1[0] == l3[0]:
                    B, lb = pl[0]
                elif l1[1] == l3[1]:
                    B, lb = pl[1]
                else:
                    B, lb = pl[2]
                if l2[0] == l3[0]:
                    C, lc = pl[0]
                elif l2[1] == l3[1]:
                    C, lc = pl[1]
                else:
                    C, lc = pl[2]
                side = np.array(
                    [dtype(scale * a), dtype(scale * b), dtype(scale * c)],
                    dtype=dtype,
                )  # STDesc.cpp:298
                angle = np.array(
                    [
                        abs((b * b + c * c - a * a) / (2 * b * c)),
                        abs((a * a + c * c - b * b) / (2 * a * c)),
                        abs((a * a + b * b - c * c) / (2 * a * b)),
                    ],
                    dtype=dtype,
                )  # STDesc.cpp:299-301
                out.append(
                    OracleSTD(
                        side_length=side,
                        angle=angle,
                        A=A.copy(),
                        B=B.copy(),
                        C=C.copy(),
                        center=(A + B + C) / dtype(3.0),  # STDesc.cpp:296
                        vertex_attached=(la, lb, lc),
                        frame_id=frame_id,
                        node_id=(i, m, nn),  # STDesc.cpp:302 stores loop idx
                    )
                )
    return out


class OracleManager:
    """Reference STDescManager: hash DB + search (STDesc.h:340-443)."""

    def __init__(self, cfg: DescriptorConfig, search: SearchConfig,
                 dtype=np.float64, fixed_point_filter: bool = False):
        self.cfg = cfg
        self.search = search
        self.dtype = dtype
        self.fixed_point_filter = fixed_point_filter
        self.current_frame_id = 0  # STDesc.h:349
        # data_base_: (x, y, z, cbe) -> list[OracleSTD] (STDesc.h:370)
        self.db: Dict[Tuple[int, int, int, int], List[OracleSTD]] = {}

    def build(self, points, labels) -> List[OracleSTD]:
        return build_single_scan_std(
            points, labels, self.cfg, self.current_frame_id, self.dtype
        )

    def add_stds(self, stds: List[OracleSTD]) -> None:
        """AddSTDescs (STDesc.cpp:149-172)."""
        self.current_frame_id += 1
        for s in stds:
            x = int(s.side_length[0] + 0.5)  # round-half-up, STDesc.cpp:155
            y = int(s.side_length[1] + 0.5)
            z = int(s.side_length[2] + 0.5)
            code = combinatorial_binary_encoding(*s.vertex_attached)
            self.db.setdefault((x, y, z, code), []).append(s)

    # ---- candidate selector ----

    def _rough_match(self, q: OracleSTD, e: OracleSTD) -> bool:
        """Side-length rough filter (STDesc.cpp:356-357, 375-378).

        fixed_point_filter=True mirrors the production pipeline's 1/256
        fixed-point comparison (match/search.py:209-223, db packing at
        db/database.py:260-264) instead of the reference's float compare.
        """
        if self.fixed_point_filter:
            qq = np.clip(
                np.round(q.side_length.astype(np.float32) * np.float32(256.0)),
                0, 32767,
            ).astype(np.int64)
            ee = np.clip(
                np.round(e.side_length.astype(np.float32) * np.float32(256.0)),
                0, 65535,
            ).astype(np.int64)
            d = ee - qq
            dis2 = np.float32(int(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]))
            qs2 = np.float32(int(qq[0] ** 2 + qq[1] ** 2 + qq[2] ** 2))
            thr2 = qs2 * np.float32(self.search.rough_dis_threshold) ** 2
            return bool(dis2 < thr2)
        dt = self.dtype
        dis = _norm(q.side_length - e.side_length, dt)
        thr = _norm(q.side_length, dt) * dt(self.search.rough_dis_threshold)
        return bool(dis < thr)

    def candidate_selector(self, stds: List[OracleSTD]):
        """candidate_selector (STDesc.cpp:318-460).

        Returns (votes, candidates) where votes maps frame_id -> vote count
        and candidates is the ordered STDMatchList analog:
        [(frame_id, vote, [(query_idx, db_entry), ...]), ...].
        """
        voxel_round = [
            (x, y, z)
            for x in (-1, 0, 1)
            for y in (-1, 0, 1)
            for z in (-1, 0, 1)
        ]  # STDesc.cpp:327-334
        useful: List[List[Tuple[Tuple[int, int, int, int], int]]] = [
            [] for _ in stds
        ]
        for i, s in enumerate(stds):
            for inc in voxel_round:
                # C-truncation quantisation (STDesc.cpp:359-361).
                x = int(s.side_length[0] + inc[0])
                y = int(s.side_length[1] + inc[1])
                z = int(s.side_length[2] + inc[2])
                code = combinatorial_binary_encoding(*s.vertex_attached)
                center = np.array(
                    [x + 0.5, y + 0.5, z + 0.5], dtype=self.dtype
                )  # STDesc.cpp:366-368
                if not (
                    _norm(s.side_length.astype(self.dtype) - center, self.dtype)
                    < self.dtype(1.5)
                ):  # STDesc.cpp:369
                    continue
                bucket = self.db.get((x, y, z, code))
                if bucket is None:
                    continue
                for j, e in enumerate(bucket):
                    # Loop-closure frame guard (STDesc.cpp:373); vacuous in
                    # one-shot localization (query frame id > all map ids).
                    if not (s.frame_id - e.frame_id > 0):
                        continue
                    if self._rough_match(s, e):  # STDesc.cpp:375-378
                        useful[i].append(((x, y, z, code), j))

        # Vote accumulation (STDesc.cpp:407-420).
        match_array: Dict[int, int] = {}
        recorder: List[Tuple[int, Tuple, int]] = []  # (i, position, j)
        frame_of: List[int] = []
        for i in range(len(stds)):
            for pos, j in useful[i]:
                e = self.db[pos][j]
                match_array[e.frame_id] = match_array.get(e.frame_id, 0) + 1
                recorder.append((i, pos, j))
                frame_of.append(e.frame_id)

        # Top-candidate extraction (STDesc.cpp:423-453): candidate_num rounds
        # of argmax (lowest frame id wins ties via strict >), vote >= 5 gate.
        votes_work = dict(match_array)
        candidates = []
        for _ in range(self.search.candidate_num):
            max_vote, max_idx = 1, -1
            for fid in sorted(votes_work):
                if votes_work[fid] > max_vote:
                    max_vote, max_idx = votes_work[fid], fid
            if max_idx >= 0 and max_vote >= self.search.min_votes:
                votes_work[max_idx] = 0
                match_list = [
                    (recorder[k][0], self.db[recorder[k][1]][recorder[k][2]])
                    for k in range(len(recorder))
                    if frame_of[k] == max_idx
                ]
                candidates.append((max_idx, max_vote, match_list))
            else:
                break
        return match_array, candidates

    # ---- verification ----

    def triangle_solver(self, q: OracleSTD, e: OracleSTD):
        """SVD rigid solve with reflection fix (STDesc.cpp:549-571)."""
        src = np.stack(
            [q.A - q.center, q.B - q.center, q.C - q.center], axis=1
        ).astype(np.float64)
        ref = np.stack(
            [e.A - e.center, e.B - e.center, e.C - e.center], axis=1
        ).astype(np.float64)
        cov = src @ ref.T
        u, _, vt = np.linalg.svd(cov)
        v = vt.T
        rot = v @ u.T
        if np.linalg.det(rot) < 0:
            k = np.diag([1.0, 1.0, -1.0])
            rot = v @ k @ u.T
        t = -rot @ q.center.astype(np.float64) + e.center.astype(np.float64)
        return rot, t

    def verify_pairs(self, pairs: List[Tuple[OracleSTD, OracleSTD]]):
        """candidate_verify on explicit (query STD, db STD) pairs."""
        n = len(pairs)
        # Reference hard-codes 50 / 3.0 / 4 (STDesc.cpp:467,469,515); the
        # config knobs default to exactly those values.
        skip_len = n // self.search.max_hypotheses + 1  # STDesc.cpp:467
        use_size = n // skip_len
        dis_threshold = self.search.verify_dis_threshold
        vote_list = []
        transforms = []
        for i in range(use_size):
            q, e = pairs[i * skip_len]  # STDesc.cpp:482
            rot, t = self.triangle_solver(q, e)
            transforms.append((rot, t))
            vote = 0
            for (vq, ve) in pairs:  # STDesc.cpp:485-502
                ok = True
                for va, vb in ((vq.A, ve.A), (vq.B, ve.B), (vq.C, ve.C)):
                    moved = rot @ va.astype(np.float64) + t
                    if not (
                        np.linalg.norm(moved - vb.astype(np.float64))
                        < dis_threshold
                    ):
                        ok = False
                        break
                if ok:
                    vote += 1
            vote_list.append(vote)
        max_vote, max_idx = 0, 0  # STDesc.cpp:507-515 (first strict max)
        for i, v in enumerate(vote_list):
            if max_vote < v:
                max_vote, max_idx = v, i
        if max_vote >= self.search.min_hypothesis_votes:  # STDesc.cpp:516
            rot, t = transforms[max_idx]
            inliers = []
            for (vq, ve) in pairs:  # STDesc.cpp:522-540 re-collect
                ok = all(
                    np.linalg.norm(rot @ va.astype(np.float64) + t - vb)
                    < dis_threshold
                    for va, vb in ((vq.A, ve.A), (vq.B, ve.B), (vq.C, ve.C))
                )
                inliers.append(ok)
            return float(sum(inliers)), rot, t, inliers
        return -1.0, np.eye(3), np.zeros(3), [False] * n

    def search_loop(self, stds: List[OracleSTD]):
        """SearchLoop (STDesc.cpp:84-147): verify every candidate, keep the
        strict-best score; accept when best > icp_threshold.

        Returns (best_frame, best_score, results) with results =
        [(frame_id, vote, score, rot, t, inliers), ...] in candidate order.
        """
        _, candidates = self.candidate_selector(stds)
        best_score, best_frame = 0.0, -1
        best_rt = (np.eye(3), np.zeros(3))
        results = []
        for frame_id, vote, match_list in candidates:
            pairs = [(stds[qi], e) for qi, e in match_list]
            score, rot, t, inl = self.verify_pairs(pairs)
            results.append((frame_id, vote, score, rot, t, inl))
            if score > best_score:  # STDesc.cpp:124-130
                best_score, best_frame = score, frame_id
                best_rt = (rot, t)
        if best_score > self.search.icp_threshold:  # STDesc.cpp:138
            return best_frame, best_score, best_rt, results
        return -1, 0.0, best_rt, results
