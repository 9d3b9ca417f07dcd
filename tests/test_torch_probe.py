"""A step-by-step NumPy model of the B1 ``frame_votes`` kernel
(sgtd_tpu_torch/csrc/probe.cu), and the contract of its wrapper.

The CUDA kernel runs only on a card, where chip_smoke.py holds it against
its plain version at these shapes. Here its algorithm is written out in
NumPy with the launch shape read from the source's constants: a cluster of
blocks a query, each counting a stretch of 16-slot groups into its own
histogram, with a scalar head and tail set by the row's byte alignment; a
warp reading coalesced 4-slot pieces, whose frame loads are skipped where
no slot is a hit; each block staging the slices of its histogram at their
owners, and each owner summing its slice. The model is held against the
plain PyTorch version and the JAX package's Pallas kernel (interpret
mode).
"""

import contextlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.ops.pallas_probe import frame_votes as jax_frame_votes
from sgtd_tpu_torch.ops import _build, launch_counts, probe

torch.set_num_threads(1)

K = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", (_build.CSRC / "probe.cu").read_text())}
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _row_model(hit, frame, f_pad, hit_addr, frame_addr, c, threads, group):
    """One query's cluster through the kernel's steps: (float32 counts,
    atomics issued, 4-slot pieces whose frame loads were skipped).
    ``hit_addr`` and ``frame_addr`` are the row's byte addresses."""
    n = hit.shape[0]
    counted = (hit != 0) & (frame >= 0) & (frame < f_pad)
    head = min((16 - hit_addr % 16) % 16, n)
    groups = (n - head) // group
    if (frame_addr + 4 * head) % 16:
        head = groups = 0  # the whole row one by one
    vec_end = head + groups * group
    hists = np.zeros((c, f_pad), np.int64)
    reads = np.zeros(n, np.int64)
    atomics = skipped = 0

    # Scalar slots over all of the cluster's threads: i = rank * T + t + k * C * T.
    i = np.arange(head + n - vec_end)
    s = np.where(i < head, i, vec_end + i - head)
    rank = (i // threads) % c
    reads[s] += 1
    for r in range(c):
        mine = s[(rank == r) & counted[s]]
        np.add.at(hists[r], frame[mine], 1)
        atomics += mine.size

    # Groups in contiguous stretches a block. A warp takes 32 groups a trip
    # (the block T groups): lane t reads pieces 32 k + t (k = 0..3) of the
    # warp's 128 pieces of 4 slots, one 4-byte hit load and one 16-byte
    # frame load each; a piece without a hit skips its frame load.
    per_block = -(-groups // c)
    for r in range(c):
        g_begin = min(groups, r * per_block)
        g = np.repeat(np.arange(g_begin, min(groups, g_begin + per_block)), 4)
        q = np.tile(np.arange(4), g.size // 4)
        j = g - g_begin
        g0 = g_begin + j // threads * threads + (j % threads) // 32 * 32  # the warp's first group this trip
        piece = 4 * (g - g0) + q
        assert (piece < 128).all() and (4 * g0 + piece == 4 * g + q).all()  # word 4 g + q of the row's groups
        slots = head + 16 * g[:, None] + 4 * q[:, None] + np.arange(4)  # (pieces, 4)
        assert ((hit_addr + slots[:, 0]) % 4 == 0).all() and ((frame_addr + 4 * slots[:, 0]) % 16 == 0).all()
        reads[slots] += 1
        loaded = (hit[slots] != 0).any(1)
        skipped += int((~loaded).sum())
        assert not counted[slots[~loaded]].any()  # a skipped piece counts nothing
        votes = counted[slots]
        np.add.at(hists[r], frame[slots[votes]], 1)
        atomics += int(votes.sum())
    assert (reads == 1).all()  # every slot read by exactly one thread

    # Rank q writes slice o of its histogram into row q of owner o's staging
    # array; after cluster.sync() owner o sums its C rows.
    width = -(-f_pad // c)
    stage = np.full((c, c, width), -1, np.int64)  # (owner, row, bin of the slice)
    for q in range(c):
        for f in range(f_pad):
            assert stage[f // width, q, f % width] == -1  # each entry written once
            stage[f // width, q, f % width] = hists[q, f]
    out = np.full(f_pad, np.nan, np.float32)
    written = np.zeros(f_pad, np.int64)
    for o in range(c):
        f = np.arange(o * width, min(f_pad, (o + 1) * width))
        assert (stage[o][:, f - o * width] >= 0).all()  # every row it reads was written
        out[f] = stage[o][:, f - o * width].sum(0).astype(np.float32)
        written[f] += 1
    assert (written == 1).all()  # every bin written exactly once: no zeroing needed
    return out, atomics, skipped


def _model(hit, frame, f_pad, hit_base=0, frame_base=0, **shape):
    """(B, f_pad) counts of the kernel's model, rows at byte b * L of hit
    and 4 b * L of frame past the two bases; the launch shape is the
    source's unless ``shape`` overrides it."""
    v = dict(c=K["kClusterBlocks"], threads=K["kVotesThreads"], group=K["kGroupSlots"])
    v.update(shape)
    b, n = hit.shape
    rows = [_row_model(hit[i], frame[i], f_pad, hit_base + i * n, frame_base + 4 * i * n, **v) for i in range(b)]
    return np.stack([r[0] for r in rows]), sum(r[1] for r in rows), sum(r[2] for r in rows)


def _inputs(rng, b, n, f_pad, kind="mixed"):
    """30% hits on ids in [0, f_pad), a fifth of the ids replaced by ones
    that count nothing (-1, f_pad, f_pad + 1, int32 min and max); or all
    hits, no hits, every slot a hit on one frame."""
    hit = rng.uniform(size=(b, n)) < 0.3
    frame = rng.integers(0, f_pad, (b, n), dtype=np.int64)
    bad = rng.uniform(size=(b, n)) < 0.2
    frame[bad] = rng.choice([-1, f_pad, f_pad + 1, INT32_MIN, INT32_MAX], int(bad.sum()))
    if kind == "all hits":
        hit[:] = True
    elif kind == "no hits":
        hit[:] = False
    elif kind == "one frame":
        hit[:], frame[:] = True, f_pad // 2
    return hit, frame.astype(np.int32)


def _reference(hit, frame, f_pad):
    """The plain version (the CPU wrapper) and the Pallas kernel, row by row."""
    got = probe.frame_votes(torch.from_numpy(hit), torch.from_numpy(frame), f_pad)
    assert got.dtype == torch.float32
    pallas = np.stack([np.asarray(jax_frame_votes(jnp.asarray(h), jnp.asarray(f), f_pad)) for h, f in zip(hit, frame)])
    np.testing.assert_array_equal(got.numpy(), pallas)
    return pallas


@pytest.mark.parametrize("f_pad", [1, 7, 200, 2048])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4099, 98304])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_cluster_model_matches_plain_and_pallas(b, n, f_pad):
    rng = np.random.default_rng(b * 100003 + n * 11 + f_pad)
    hit, frame = _inputs(rng, b, n, f_pad)
    want = _reference(hit, frame, f_pad)
    got, _, _ = _model(hit.view(np.uint8), frame.astype(np.int64), f_pad)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["all hits", "no hits", "one frame"])
@pytest.mark.parametrize("shape", [(1, 17, 7), (3, 4099, 200), (2, 98304, 2048)])
def test_cluster_model_on_edge_contents(kind, shape):
    b, n, f_pad = shape
    hit, frame = _inputs(np.random.default_rng(n), b, n, f_pad, kind)
    want = _reference(hit, frame, f_pad)
    got, atomics, skipped = _model(hit.view(np.uint8), frame.astype(np.int64), f_pad)
    np.testing.assert_array_equal(got, want)
    if kind == "no hits":
        assert atomics == 0 and (got == 0).all()
        assert skipped > 0  # row 0 starts aligned: it has a group
    if kind == "one frame":
        assert (got[:, f_pad // 2] == n).all() and got.sum() == b * n


@pytest.mark.parametrize("hit_off, frame_off", [(1, 1), (1, 0), (6, 2), (15, 3), (8, 8), (0, 1)])
def test_cluster_model_with_rows_off_their_boundaries(hit_off, frame_off):
    """Inputs that start past an aligned buffer (a view's offset): where hit
    and frame reach a 16-byte boundary at the same slot the groups take
    16-byte loads after a scalar head, else the whole row goes one by one."""
    b, n, f_pad = 3, 4099, 200
    hit, frame = _inputs(np.random.default_rng(hit_off * 16 + frame_off), b, n, f_pad)
    want = _reference(hit, frame, f_pad)
    got, _, _ = _model(hit.view(np.uint8), frame.astype(np.int64), f_pad, hit_base=hit_off, frame_base=4 * frame_off)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [4, 8, 12, 16])
@pytest.mark.parametrize("threads", [256, 512, 1024])
def test_cluster_model_at_every_launch_shape(c, threads):
    """The launch shapes the source's constants can take (C 4, 8, 12, 16;
    256 to 1,024 threads) all give the plain version's counts, with one
    atomic a counted hit and the frame loads of hit-free pieces skipped."""
    rng = np.random.default_rng(c + threads)
    hit, frame = _inputs(rng, 3, 20000, 7)
    hit[1, 5000:] = False  # a run of hit-free groups
    want = _reference(hit, frame, 7)
    got, atomics, skipped = _model(hit.view(np.uint8), frame.astype(np.int64), 7, hit_base=5, frame_base=4 * 1,
                                   c=c, threads=threads)
    np.testing.assert_array_equal(got, want)
    assert atomics == int(want.sum()) and skipped >= (15000 - 16) // 4


def test_launch_constants_of_the_source():
    assert probe.MAX_F_PAD == K["kMaxFPad"]
    assert K["kGroupSlots"] == 16  # one 16-byte load of hit bytes
    c = K["kClusterBlocks"]
    assert 1 <= c <= 16  # above 8 with the non-portable opt-in
    assert K["kVotesThreads"] % 32 == 0 and K["kVotesThreads"] <= 1024
    # The widest histogram and its staging array need no shared-memory opt-in.
    assert (K["kMaxFPad"] + c * -(-K["kMaxFPad"] // c)) * 4 <= 48 * 1024


def test_wrapper_on_the_cpu_is_float32_exact_and_launches_nothing():
    rng = np.random.default_rng(3)
    hit, frame = _inputs(rng, 2, 5000, 9)
    before = launch_counts()
    got = probe.frame_votes(torch.from_numpy(hit), torch.from_numpy(frame), 9)
    assert got.dtype == torch.float32 and launch_counts() == before
    want = np.zeros((2, 9))
    for i in range(2):
        keep = hit[i] & (frame[i] >= 0) & (frame[i] < 9)
        want[i] = np.bincount(frame[i][keep], minlength=9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("f_pad", [0, K["kMaxFPad"] + 1])
def test_wrapper_refuses_a_frame_axis_the_kernel_cannot_hold(f_pad):
    hit = torch.ones(1, 16, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="f_pad"):
        probe.frame_votes(hit, torch.zeros(1, 16, dtype=torch.int32, device="meta"), f_pad)


@pytest.mark.parametrize("current, index", [(0, 0), (0, 1), (1, 0), (2, 2)])
def test_launch_runs_on_the_tensors_device(monkeypatch, current, index):
    """``_build.launch`` makes the tensor's card current
    (``torch.cuda.device(index)``) only where it is not the current one,
    and reads that card's stream."""
    entered, streams, calls = [], [], []
    state = {"device": current}

    @contextlib.contextmanager
    def device(i):
        entered.append(i)
        before, state["device"] = state["device"], i
        yield
        state["device"] = before

    monkeypatch.setattr(_build, "entry_points", lambda: {"sgtd_ok": lambda *a: calls.append(a) or 0})
    monkeypatch.setitem(_build.COUNTS, "sgtd_ok", 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: streams.append(i) or 7, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: state["device"], raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    _build.launch("sgtd_ok", torch.device("cuda", index), 3)
    assert entered == ([] if current == index else [index])
    assert streams == [index] and calls == [(3, 7)] and state["device"] == current


@pytest.mark.parametrize("kind", ["mixed", "all hits", "no hits"])
@pytest.mark.parametrize("b, n", [(1, 17), (3, 4099), (2, 98304)])
def test_bound_counts_the_frame_bytes_the_kernel_loads(b, n, kind):
    """chip_smoke.py's bound for B1 (``frame_votes_nbytes``): every hit
    byte, the frame ids of each 4-slot piece from a row's start that holds
    a hit (a row's short last piece counts its own slots), the float32
    counts. Where the rows sit on their 16-byte boundaries the kernel's
    model loads the frame ids of just those pieces."""
    import chip_smoke as cs

    f_pad = 200
    hit, frame = _inputs(np.random.default_rng(b * 7 + n), b, n, f_pad, kind)
    frame_bytes = sum(4 * p.size for row in hit for p in np.split(row, range(4, n, 4)) if p.any())
    assert cs.frame_votes_nbytes(torch.from_numpy(hit), f_pad) == b * n + frame_bytes + 4 * b * f_pad
    if n % 16 == 0:
        _, _, skipped = _model(hit.view(np.uint8), frame.astype(np.int64), f_pad)
        assert frame_bytes == 16 * (b * n // 4 - skipped)
