"""Step-by-step NumPy models of the B2 ``expand_jobs`` and B3
``hypothesis_votes`` kernels (sgtd_tpu_torch/csrc/expand.cu, verify.cu).

The CUDA kernels run only on a card, where chip_smoke.py holds them against
their plain versions. Here the algorithms they implement (B2: two searches a
tile, marks of the non-empty jobs' heads, a max-scan, the copy; B3: several
pairs a thread, as few as cover a tile's valid pairs, warps that split the
hypotheses, tiles without a valid pair skipped, a warp sum a hypothesis) are written out lane by lane in NumPy at
every launch shape the kernels can take, and held against the plain PyTorch
versions and the JAX package's Pallas kernels (interpret mode). The launch
plans are written out in Python from the constants of the sources.
"""

import re
from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.ops.pallas_expand import expand_jobs as jax_expand_jobs
from sgtd_tpu.ops.pallas_verify import hypothesis_votes as jax_hypothesis_votes
from sgtd_tpu_torch.ops import _build, expand, verify

torch.set_num_threads(1)

def _constants(source):
    text = (_build.CSRC / source).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


K_EXPAND, K_VERIFY = _constants("expand.cu"), _constants("verify.cu")
SLOTS = K_EXPAND["kSlots"]
# Every block size csrc/expand.cu's expand_plan can choose.
EXPAND_THREADS = [64, 128, 256]


def _expand_plan(b, l_max):
    """csrc/expand.cu expand_plan with the source's constants: (threads a
    block, tiles a query). A block owns a tile of threads * kSlots
    consecutive slots; the largest tile that still gives the card
    kBlocksWanted blocks is taken, the smallest where none does."""
    threads = K_EXPAND["kMaxThreads"]
    while threads > K_EXPAND["kMinThreads"] and b * -(-l_max // (threads * SLOTS)) < K_EXPAND["kBlocksWanted"]:
        threads //= 2
    return threads, -(-l_max // (threads * SLOTS))


def _votes_plan(n, h):
    """csrc/verify.cu votes_plan with the source's constants: blocks a
    candidate. kSplitFew where that many still leave the card room, else
    kSplit; never more than there are groups of kWarps hypotheses."""
    few = n * K_VERIFY["kSplitFew"] <= K_VERIFY["kBlocksWanted"]
    return min(K_VERIFY["kSplitFew"] if few else K_VERIFY["kSplit"], -(-h // K_VERIFY["kWarps"]))


# --------------------------------------------------------------------- B2


def _warp_search(off, nj, s):
    """csrc/expand.cu warp_search: the largest j in [0, nj) with off[j] <= s,
    32 probes a step. Returns (j, steps)."""
    lo, n, steps = 0, nj, 0
    while n > 1:
        step = (n + 31) >> 5
        probes = lo + np.arange(32) * step
        holds = (probes < lo + n) & (off[np.minimum(probes, nj - 1)] <= s)
        assert holds[0] and not (~holds[:-1] & holds[1:]).any()  # a prefix of the lanes
        k = int(np.flatnonzero(holds)[-1])
        end = lo + n
        lo += k * step
        n = min(step, end - lo)
        steps += 1
    return lo, steps


def _expand_model(length, payload, l_max, threads):
    """One query through the kernel's tile algorithm: (C, l_max) int32, each
    slot's job, and how often the walks read each job's offset."""
    nj, c = payload.shape
    off = np.concatenate([[0], np.cumsum(length)]).astype(np.int64)
    tile = threads * SLOTS
    out = np.full((c, l_max), np.iinfo(np.int32).min, np.int32)
    walked = np.zeros(nj, np.int32)
    jobs = np.zeros(l_max, np.int64)
    for s0 in range(0, l_max, tile):
        s1 = min(s0 + tile, l_max) - 1
        (j_first, steps), (j_last, _) = _warp_search(off, nj, s0), _warp_search(off, nj, s1)
        assert steps <= 4 or nj > 32 ** 4
        assert j_first == np.searchsorted(off[:nj], s0, side="right") - 1
        assert j_last == np.searchsorted(off[:nj], s1, side="right") - 1
        # The walk: plain stores of the non-empty jobs at their heads.
        mark = np.full(tile, -1, np.int64)
        for j in range(j_first + 1, j_last + 1):
            walked[j] += 1
            if off[j] != off[j + 1]:
                assert s0 < off[j] <= s1 and mark[off[j] - s0] == -1  # in the tile, no second writer
                mark[off[j] - s0] = j
        # The scan: in the thread, over the warp's lanes (shuffles up by 1,
        # 2, 4, 8, 16), then over the warps' totals, seeded with j_first.
        per_thread = np.maximum.accumulate(mark.reshape(threads, SLOTS), axis=1)
        incl = per_thread[:, -1].reshape(-1, 32).copy()
        d = 1
        while d < 32:
            up = np.concatenate([np.full((incl.shape[0], d), -1), incl[:, :-d]], axis=1)
            incl = np.maximum(incl, up)
            d <<= 1
        before = np.concatenate([np.full((incl.shape[0], 1), -1), incl[:, :-1]], axis=1)
        warp_max = incl[:, -1]
        for w in range(incl.shape[0]):
            before[w] = np.maximum(before[w], max([j_first] + list(warp_max[:w])))
        job = np.maximum(per_thread, before.reshape(threads, 1)).reshape(tile)
        assert (np.diff(job) >= 0).all() and job[0] == j_first and job.min() >= 0
        n = s1 - s0 + 1
        # Trailing empty jobs are found by the search and never marked.
        assert job[n - 1] == j_last or (s1 >= off[nj] and job[n - 1] < j_last)
        jobs[s0 : s1 + 1] = job[:n]
        out[:, s0 : s1 + 1] = payload[job[:n]].T
    return out, jobs, walked


def _lengths(*runs):
    return np.concatenate([np.full(n, v, np.int64) for n, v in runs])


def _expand_case(name):
    """(length (NJ,), payload (NJ, C), l_max): the shapes chip_smoke.py
    drives on the card, at small size."""
    rng = np.random.default_rng(sum(map(ord, name)))
    l_max, c, lo, hi = 8192, 5, 0, 1 << 24
    if name == "skewed":  # the bench shape's mix: most jobs empty, short runs
        length = np.where(rng.uniform(size=6000) < 0.7, 0, rng.geometric(0.3, 6000))
    elif name == "deep_buckets":  # the large map's: runs of tens of slots, over the cap
        length, l_max = np.where(rng.uniform(size=1500) < 0.5, 0, rng.geometric(1 / 24, 1500)), 16384
    elif name == "ragged_l_max":  # no multiple of 4 or of any tile
        length, l_max = np.where(rng.uniform(size=900) < 0.6, 0, rng.geometric(0.2, 900)), 1003
    elif name == "l_max_3":
        length, l_max = np.full(9, 1), 3
    elif name == "empty_run":  # more empty jobs in a row than any tile has slots
        length = _lengths((40, 3), (1500, 0), (300, 7), (1200, 0), (50, 40))
    elif name == "giant_job":  # one job over many tiles
        length = _lengths((10, 5), (1, 5000), (20, 0), (100, 6))
    elif name == "tile_heads":  # heads on the boundaries of every tile size
        length = rng.choice([0, 0, 256, 512, 1024], 40)
    elif name == "all_empty":
        length, l_max = np.zeros(700, np.int64), 2048
    elif name == "over_cap":  # a total far above l_max
        length, l_max = np.full(3000, 50), 4096
    else:  # "any_sign": the port's row-base channel is negative at times
        length = np.where(rng.uniform(size=2000) < 0.5, 0, rng.integers(1, 9, 2000))
        lo, hi = -(1 << 30), 1 << 30
    payload = rng.integers(lo, hi, (len(length), c), dtype=np.int32)
    return np.asarray(length, np.int32), payload, l_max


EXPAND_CASES = ["skewed", "deep_buckets", "ragged_l_max", "l_max_3", "empty_run", "giant_job",
                "tile_heads", "all_empty", "over_cap", "any_sign"]


@pytest.mark.parametrize("threads", EXPAND_THREADS)
@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_tile_model_equals_plain_and_pallas(case, threads):
    length, payload, l_max = _expand_case(case)
    got, jobs, walked = _expand_model(length, payload, l_max, threads)
    want = expand.expand_jobs_plain(torch.from_numpy(length)[None], torch.from_numpy(payload)[None], l_max)[0].numpy()
    total = min(int(length.sum()), l_max)
    np.testing.assert_array_equal(got[:, :total], want[:, :total])
    np.testing.assert_array_equal(jobs[:total], np.repeat(np.arange(len(length)), length)[:total])
    # Slots at or past the total carry the payload of the last non-empty
    # job or of an empty one after it, never an address out of bounds.
    last = np.flatnonzero(length)[-1] if length.any() else 0
    assert ((jobs[total:] >= last) & (jobs[total:] < len(length))).all()
    # Each offset is read by at most one tile's walk.
    assert walked.max() <= 1
    if l_max % 8192 == 0 and payload.min() >= 0:  # what the Pallas kernel takes
        ref = np.asarray(jax_expand_jobs(jnp.asarray(length), jnp.asarray(payload), l_max))
        np.testing.assert_array_equal(got[:, :total], ref[:, :total])


def test_expand_plan_mirrors_the_source():
    """The kernel's launch plan from the source's constants: the paths'
    shapes get the tiles the kernel was measured at, and every plan covers
    the slots with blocks of whole warps, two at least (one search each)."""
    k = K_EXPAND
    lo, hi = k["kMinThreads"], k["kMaxThreads"]
    assert EXPAND_THREADS == [t for t in (32 << i for i in range(8)) if lo <= t <= hi] and lo >= 64
    assert _expand_plan(16, 98304) == (256, 96)  # a bench chunk
    assert _expand_plan(8, 1802240) == (256, 1760)  # a 5,000-keyframe chunk
    assert _expand_plan(1, 98304) == (64, 384)  # one query
    assert sorted({_expand_plan(b, l)[0] for b in (1, 2, 4, 64) for l in (3, 8192, 98304)}) == EXPAND_THREADS
    for b, l_max in [(1, 1), (1, 3), (3, 1003), (2, 8192), (5, 98304), (6, 98304), (16, 7053312), (70000, 8)]:
        threads, tiles = _expand_plan(b, l_max)
        tile = threads * SLOTS
        assert threads in EXPAND_THREADS and (tiles - 1) * tile < l_max <= tiles * tile
        assert b * tiles >= k["kBlocksWanted"] or threads == lo
        assert threads == hi or b * -(-l_max // (2 * tile)) < k["kBlocksWanted"]


def test_job_offsets_and_offsets_argument():
    rng = np.random.default_rng(5)
    length = torch.from_numpy(rng.integers(0, 9, (3, 50), dtype=np.int32))
    payload = torch.from_numpy(rng.integers(-99, 99, (3, 50, 2), dtype=np.int32))
    offsets = expand.job_offsets(length)
    assert offsets.dtype == torch.int32 and offsets.shape == (3, 51)
    want = np.concatenate([np.zeros((3, 1), np.int64), np.cumsum(length.numpy(), 1)], 1)
    np.testing.assert_array_equal(offsets.numpy(), want)
    got = expand.expand_jobs(length, payload, 128, offsets=offsets)
    assert torch.equal(got, expand.expand_jobs(length, payload, 128))
    # The kernel's side checks what it is handed before it launches.
    meta = lambda x: x.to("meta")
    with pytest.raises(ValueError, match="CUDA tensors required"):
        expand.expand_jobs(meta(length), meta(payload), 128, offsets=meta(offsets))
    with mock.patch.object(torch.Tensor, "device", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match=r"offsets must be \(B, NJ \+ 1\) int32"):
            expand._expand_jobs_cuda(length, payload, 128, offsets[:, :-1])
        with pytest.raises(ValueError, match=r"offsets must be \(B, NJ \+ 1\) int32"):
            expand._expand_jobs_cuda(length, payload, 128, offsets.long())


def test_probe_and_hits_hands_its_offsets_to_expand_jobs():
    """The search stage computes the offsets once a chunk."""
    from sgtd_tpu_torch.match import search

    seen = {}

    def spy(length, payload, l_max, offsets=None):
        seen["offsets"], seen["length"] = offsets, length
        raise RuntimeError("stop after the expansion")

    with mock.patch.object(search.expand, "expand_jobs", spy), mock.patch.object(
            search, "_bucket_lookup", lambda db, cells, code, ok: (
                torch.zeros(cells.shape, dtype=torch.int32), torch.ones(cells.shape, dtype=torch.int32), ok)):
        from sgtd_tpu_torch.config import SGTDConfig

        cfg = SGTDConfig()
        rng = np.random.default_rng(3)
        d = 8
        query = mock.Mock(
            mask=torch.ones((2, d), dtype=torch.bool),
            sides=torch.from_numpy(rng.uniform(2, 30, (2, d, 3)).astype(np.float32)),
            labels=torch.zeros((2, d, 3), dtype=torch.int32),
        )
        db = mock.Mock(frame_poses=torch.zeros((4, 4, 4)), keys=torch.zeros(10))
        with pytest.raises(RuntimeError, match="stop after the expansion"):
            search.probe_and_hits(db, query, cfg.desc, cfg.search, cfg.caps)
    assert seen["offsets"] is not None
    assert torch.equal(seen["offsets"], expand.job_offsets(seen["length"]))


# --------------------------------------------------------------------- B3


def _rand_rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(n, 3, 3)


def _votes_model(rot, t, vq, vdb, valid, thr2, warps, pairs):
    """csrc/verify.cu, lane by lane: the ``warps`` warps of a candidate's
    blocks share out its hypotheses (warp w takes w, w + warps, ...); every
    warp walks the pairs in tiles of 32 * pairs; a tile without
    a valid pair is skipped; in a tile a lane holds as many consecutive
    pairs (1 to ``pairs``) as cover it up to its last valid pair; a lane
    counts its own inliers, the warp adds the lanes' counts and adds the
    sum to the hypothesis' counter. Returns (votes (N, H) int32, tiles
    walked, tiles skipped, lane slots taken)."""
    n, h = rot.shape[:2]
    p = vq.shape[1]
    tile = 32 * pairs
    votes = np.zeros((n, h), np.int32)
    walked = skipped = slots = 0
    f32 = np.float32
    for c in range(n):
        if not valid[c].any():
            continue  # zeros, before a rotation is read
        cnt = np.zeros(h, np.int64)
        for w in range(warps):
            for base in range(0, p, tile):
                walked += 1
                in_tile = valid[c, base : base + tile]
                if not in_tile.any():
                    skipped += 1
                    continue
                extent = int(np.flatnonzero(in_tile)[-1]) + 1  # the warp's max over the lanes' last valid pair
                kk = -(-extent // 32)  # pairs a lane
                assert 1 <= kk <= pairs
                slots += 32 * kk
                idx = base + np.arange(32)[:, None] * kk + np.arange(kk)  # (32, kk)
                inside = idx < p
                safe = np.minimum(idx, p - 1)
                bits = inside & valid[c][safe]
                assert bits.sum() == in_tile.sum()  # every valid pair of the tile has a lane
                q = np.where(inside[..., None, None], vq[c][safe], f32(0))  # (32, kk, 3 vertices, 3)
                d = np.where(inside[..., None, None], vdb[c][safe], f32(0))
                for hh in range(w, h, warps):
                    r, tt = rot[c, hh], t[c, hh]
                    inlier = bits.copy()
                    for v in range(3):
                        x, y, z = q[:, :, v, 0], q[:, :, v, 1], q[:, :, v, 2]
                        s = None
                        for i in range(3):
                            m = (r[i, 0] * x + r[i, 1] * y) + r[i, 2] * z
                            diff = (m + tt[i]) - d[:, :, v, i]
                            assert m.dtype == np.float32 and diff.dtype == np.float32
                            s = diff * diff if s is None else s + diff * diff
                        inlier &= s < thr2
                    count = inlier.sum(1)  # a lane's own pairs
                    cnt[hh] += int(count.sum())  # the warp's sum, by the hypothesis' one writer
        votes[c] = cnt
    return votes, walked, skipped, slots


def _votes_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    c, h, p = 5, 50, 512
    if name in ("P_700", "P_513", "P_130", "P_3", "P_1"):
        p = int(name[2:])
    if name == "H_1":
        h = 1
    if name == "H_many":
        c, h, p = 2, 97, 192
    rot = _rand_rot(rng, c * h).reshape(c, h, 3, 3).astype(np.float32)
    t = rng.normal(0, 5, (c, h, 3)).astype(np.float32)
    vq = rng.normal(0, 10, (c, p, 3, 3)).astype(np.float32)
    vdb = rng.normal(0, 10, (c, p, 3, 3)).astype(np.float32)
    for ci in range(c):  # half the pairs near hypothesis 0
        moved = vq[ci, : p // 2] @ rot[ci, 0].T + t[ci, 0]
        vdb[ci, : p // 2] = moved + rng.normal(0, 1.5, moved.shape)
    if name == "prefix":
        valid = np.arange(p)[None] < np.array([0, 5, 129, 300, 512])[:, None]
    elif name == "all_invalid":
        valid = np.zeros((c, p), bool)
    elif name == "one_pair":
        valid = np.zeros((c, p), bool)
        valid[np.arange(c), [0, 127, 128, 300, 511]] = True
    else:
        valid = rng.uniform(size=(c, p)) < 0.5  # holes
    return rot, t, vq, vdb, valid


VOTES_CASES = ["holes", "prefix", "P_700", "P_513", "P_130", "P_3", "P_1", "H_1", "H_many", "all_invalid", "one_pair"]
# (Warps that split a candidate's hypotheses, most pairs a thread): the
# shipped launch shapes (kWarps warps in each of kSplit or kSplitFew blocks)
# and others the source can be built with.
VOTES_SHAPES = [(K_VERIFY["kWarps"] * K_VERIFY["kSplit"], K_VERIFY["kPairs"]),
                (K_VERIFY["kWarps"] * K_VERIFY["kSplitFew"], K_VERIFY["kPairs"]), (4, 2), (4, 4)]


@pytest.mark.parametrize("case", VOTES_CASES)
def test_votes_model_equals_plain_and_pallas(case):
    args = _votes_case(case)
    thr = 3.0
    want = verify.hypothesis_votes_plain(*(torch.from_numpy(a) for a in args), thr).numpy()
    ref = np.asarray(jax_hypothesis_votes(*(jnp.asarray(a) for a in args), thr))
    np.testing.assert_array_equal(want, ref)
    thr2 = np.float32(verify._thr2(thr))
    for warps, pairs in VOTES_SHAPES:
        got, walked, skipped, slots = _votes_model(*args, thr2, warps, pairs)
        np.testing.assert_array_equal(got, want, err_msg=f"{warps} warps, {pairs} pairs a thread")
        if case == "all_invalid":
            assert walked == 0 and not got.any()
        if case == "prefix" and pairs == 4:
            # 0, 5, 129, 300, 512 valid pairs: 0, 1, 2, 3, 4 of 4 tiles busy, and
            # the ragged ends of 5, 1 and 44 pairs take 32, 32 and 64 lane slots.
            assert (walked, skipped) == (4 * 4 * warps, 6 * warps)
            assert slots == warps * (32 + (128 + 32) + (256 + 64) + 512)
        if case == "one_pair" and pairs == 4:  # pairs 0, 127, 128, 300, 511: 1, 4, 1, 2, 4 pairs a lane
            assert slots == warps * 32 * (1 + 4 + 1 + 2 + 4)
    if case in ("holes", "prefix"):
        assert (want[:, 0] > 0).any()  # the planted hypothesis collects votes


def test_votes_plan_mirrors_the_source_and_shares_out_every_hypothesis():
    assert _votes_plan(800, 50) == 2 and _votes_plan(400, 50) == 2  # a chunk, a large map's chunk
    assert _votes_plan(50, 50) == 4 and _votes_plan(132, 50) == 4 and _votes_plan(133, 50) == 2
    assert _votes_plan(800, 1) == 1 and _votes_plan(50, 5) == 2 and _votes_plan(1, 512) == 4
    w = K_VERIFY["kWarps"]
    for n, h in [(800, 50), (50, 50), (7, 1), (7, 5), (20, 512), (3, 97)]:
        split = _votes_plan(n, h)
        assert 1 <= split <= -(-h // w)
        # A warp of block y takes h = y * w + warp, then every (w * split)-th:
        # each hypothesis once, and the block that counted it writes it.
        owners = {}
        for y in range(split):
            for warp in range(w):
                for hh in range(y * w + warp, h, w * split):
                    assert hh not in owners and (hh // w) % split == y
                    owners[hh] = (y, warp)
        assert sorted(owners) == list(range(h))


def test_votes_constants_mirror_the_source_and_thr2_rounds_once():
    assert K_VERIFY["kPairs"] == verify.PAIRS_PER_THREAD
    # R, t (12 floats) and a counter a hypothesis, within the 48 KB a block
    # gets without asking.
    assert verify.MAX_H * (12 * 4 + 4) <= 48 * 1024
    for thr in (3.0, 0.1, 2.5, 1e-3, 7.77, 1 / 3):
        assert verify._thr2(thr) == float(torch.tensor(float(thr) ** 2, dtype=torch.float32))
        assert isinstance(verify._thr2(thr), float)


def test_warp_tiles_a_mask_leaves_idle():
    """What the kernel's tile skip meets: with P 512 and 4 pairs a thread a
    candidate has 4 tiles of 128 pairs; a prefix of v valid pairs keeps
    ceil(v / 128) of them busy, a mask with holes all of them."""
    tile = 32 * verify.PAIRS_PER_THREAD
    for v, busy in [(0, 0), (1, 1), (128, 1), (129, 2), (512, 4)]:
        valid = np.arange(512) < v
        assert valid.reshape(-1, tile).any(1).sum() == busy == -(-v // tile)
