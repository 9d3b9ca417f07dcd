"""Levenberg-Marquardt / Gauss-Newton stepping on SE(3) (port of
sgtd_tpu.refine.lsq), batched over the leading axes of ``T0``.

The reference's ``LsqRegistration`` optimizer
(lsq_registration_impl.hpp:53-163): GN solves (H + damping I) d = -g per
iteration; LM keeps a lambda trust region (initialised to
``init_factor * max|diag H|``), tries the deterministic lambda ladder
``lambda * 2^(k(k+1)/2)`` of up to ``lm_inner`` rejections as one batch and
takes the first event (an accepted step, rho >= 0, or a converged
rejection). Convergence: ``max(|dR - I|/rot_eps, |dt|/trans_eps) < 1`` on
the step (:82-93). State convention: T <- se3_exp(d) @ T, d = [v, w].

The engine supplies two callbacks, over the batch B = T0.shape[:-2]:

  linearize(T (B, 4, 4)) -> (H (B, 6, 6), g (B, 6), y0 (B), aux)
  error(T (B, L, 4, 4), aux) -> y (B, L)
      cost of L trial transforms, reusing the correspondences and
      Mahalanobis weights of the last linearization (``aux``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.ops import _build
from sgtd_tpu_torch.ops.linalg3 import chol_solve6
from sgtd_tpu_torch.utils import profiling


class LsqResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4)
    converged: torch.Tensor  # (B,) bool
    final_cost: torch.Tensor  # (B,) y at the last executed linearization


def _is_converged(delta_T: torch.Tensor, rot_eps: float, trans_eps: float) -> torch.Tensor:
    """lsq_registration_impl.hpp:82-93, over leading axes."""
    eye = torch.eye(3, dtype=delta_T.dtype, device=delta_T.device)
    r = (delta_T[..., :3, :3] - eye).abs().amax(dim=(-2, -1))
    t = delta_T[..., :3, 3].abs().amax(-1)
    return torch.maximum(r / rot_eps, t / trans_eps) < 1.0


# Both solvers stop when every problem of the batch is done or after
# max_iterations trips, like the reference's vmapped while_loop: a done
# problem keeps its state, so the extra trips of the others cannot change
# it. The check costs one host sync per trip (``done.all()``), which is
# cheap while the device idles behind the host (the path is host-bound),
# and it saves whole linearizations when a batch converges early. A
# rerank chunk of 64 problems mostly runs all trips: one unconverged
# problem keeps the loop going.
#
# With tracing on, each trip is a span ``refine.lm.trip``; a solve counts
# its trips (``lm.trips``) and problems (``lm.problems``), and each trip
# holds its entry ``done`` mask for ``lm.live`` (the problems still live
# on entry), folded at ``profiling.flush``. An LM solve handed an
# ``LmGraph`` keeps this loop and its one host sync a trip, and replays
# the trip in one launch in place of its few hundred; it counts
# ``lm.graph_captures`` (one a capture) and ``lm.graph_replays`` (one a
# trip).


def _count_solve(trips: int, batch: torch.Size) -> None:
    profiling.count("lm.trips", trips)
    profiling.count("lm.problems", batch.numel())


def gn_solve(
    linearize: Callable,
    T0: torch.Tensor,
    *,
    max_iterations: int,
    rot_eps: float = 2e-3,
    trans_eps: float = 5e-4,
    damping: float = 1e-6,
) -> LsqResult:
    """Gauss-Newton (step_gn, lsq_registration_impl.hpp:106-120)."""
    batch = T0.shape[:-2]
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    T = T0
    done = torch.zeros(batch, dtype=torch.bool, device=T0.device)
    y = torch.full(batch, float("inf"), dtype=T0.dtype, device=T0.device)
    trips = 0
    for _ in range(max_iterations):
        if bool(done.all()):
            break
        with profiling.span("refine.lm.trip"):
            trips += 1
            profiling.count_mask("lm.live", done, False)
            H, g, y0, _ = linearize(T)
            d = chol_solve6(H + damping * eye6, -g)
            delta_T = se3.se3_exp(d)
            conv = _is_converged(delta_T, rot_eps, trans_eps)
            T = torch.where(done[..., None, None], T, delta_T @ T)
            y = torch.where(done, y, y0)
            done = done | conv
    _count_solve(trips, batch)
    return LsqResult(transform=T, converged=done, final_cost=y)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x (B, L, *rest)[b, i[b]] -> (B, *rest)."""
    idx = i.reshape(i.shape + (1,) * (x.dim() - i.dim()))
    return torch.gather(x, i.dim(), idx.expand(i.shape + (1,) + x.shape[i.dim() + 1:])).squeeze(i.dim())


class LmState(NamedTuple):
    """An LM solve between two trips, over the batch B."""

    T: torch.Tensor  # (B, 4, 4) the current transforms
    lam: torch.Tensor  # (B,) the trust region's lambda, -1 before the first trip
    done: torch.Tensor  # (B,) bool: converged or stopped
    y: torch.Tensor  # (B,) the cost at the last executed linearization


class LmConstants(NamedTuple):
    """What every trip reads besides the state: the 6x6 identity, the
    lambda ladder 2^(k(k+1)/2), k < lm_inner, and 1/3 (:159), on the
    state's device."""

    eye6: torch.Tensor
    ladder: torch.Tensor
    third: torch.Tensor


def lm_start(T0: torch.Tensor) -> LmState:
    """The state before the first trip, from T0 (B, 4, 4)."""
    batch, dt, dev = T0.shape[:-2], T0.dtype, T0.device
    return LmState(
        T=T0,
        lam=torch.full(batch, -1.0, dtype=dt, device=dev),
        done=torch.zeros(batch, dtype=torch.bool, device=dev),
        y=torch.full(batch, float("inf"), dtype=dt, device=dev),
    )


def lm_constants(lm_inner: int, dtype: torch.dtype, device: torch.device) -> LmConstants:
    return LmConstants(
        eye6=torch.eye(6, dtype=dtype, device=device),
        ladder=torch.tensor([2.0 ** (k * (k + 1) / 2.0) for k in range(lm_inner)], dtype=dtype, device=device),
        third=torch.tensor(1.0 / 3.0, dtype=dtype, device=device),
    )


def lm_trip(
    linearize: Callable,
    error: Callable,
    s: LmState,
    c: LmConstants,
    *,
    rot_eps: float,
    trans_eps: float,
    init_lambda_factor: float,
    out: LmState | None = None,
) -> LmState:
    """One trip of ``lm_solve`` from state ``s``: a linearization, the
    ``lm_inner`` ladder steps at once, the first event and the update. A
    done problem keeps its state. Reads nothing back to the host, so a
    CUDA graph can hold it (:class:`LmGraph`). ``out``: the state to write
    the next one into (``s`` itself, in place), or None for new tensors.
    """
    T, lam, done, y = s
    H, g, y0, aux = linearize(T)
    # Lazy lambda init (lsq_registration_impl.hpp:128-130).
    diag_max = H.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
    lam = torch.where(lam < 0.0, init_lambda_factor * diag_max, lam)

    lam_k = lam[..., None] * c.ladder  # (B, L)
    Hk = H[..., None, :, :] + lam_k[..., None, None] * c.eye6
    g_k = g[..., None, :].expand(Hk.shape[:-1])
    d_k = chol_solve6(Hk, -g_k)  # (B, L, 6)
    delta_k = se3.se3_exp(d_k)  # (B, L, 4, 4)
    T_k = delta_k @ T[..., None, :, :]
    y_k = error(T_k, aux)  # (B, L)
    rho_k = (y0[..., None] - y_k) / (d_k * (lam_k[..., None] * d_k - g_k)).sum(-1)  # :142
    accept_k = rho_k >= 0.0
    stepconv_k = _is_converged(delta_k, rot_eps, trans_eps)
    # Sequential events: at ladder step k, accept (rho >= 0, :156-161)
    # or stop on a converged rejection (:147-151); first event wins.
    event_k = accept_k | stepconv_k
    first = event_k.to(torch.uint8).argmax(-1)  # first True
    has_event = event_k.any(-1)
    acc_first = _take(accept_k, first)
    acc = has_event & acc_first
    conv_stop = has_event & ~acc_first
    rho_f = _take(rho_k, first)
    lam_acc = _take(lam_k, first) * torch.maximum(c.third, 1.0 - (2.0 * rho_f - 1.0) ** 3)  # :159
    conv = (acc & _take(stepconv_k, first)) | conv_stop
    T_new = torch.where(acc[..., None, None], _take(T_k, first), T)
    lam_new = torch.where(acc, lam_acc, lam)
    # Inner exhaustion without an event ends the problem unconverged
    # (computeTransformation :70-73). The entry mask is written last.
    o = out if out is not None else LmState(None, None, None, None)
    T = torch.where(done[..., None, None], T, T_new, out=o.T)
    lam = torch.where(done, lam, lam_new, out=o.lam)
    y = torch.where(done, y, y0, out=o.y)
    done = torch.bitwise_or(done | conv | ~has_event, conv_stop, out=o.done)
    return LmState(T, lam, done, y)


class LmGraph:
    """One LM trip captured as a CUDA graph (``torch.cuda.CUDAGraph``), with
    the state it reads and writes in place.

    Its owner keeps every tensor that ``linearize`` and ``error`` read at
    one address (buffers it refills before each solve) and hands the same
    graph to ``lm_solve`` for each solve over them: the first solve
    captures :func:`lm_trip` over them, and every trip of every solve is
    one replay. A replay runs the captured kernels in their order on the
    same buffers, so its bits are the eager trip's.

    ``settings``: (lm_inner, rot_eps, trans_eps, init_lambda_factor) of the
    capture. ``launches``: the hand-written kernels' launches the capture
    recorded, by entry point; the capture runs none, and each replay adds
    them to ``ops._build.COUNTS``.
    """

    def __init__(self):
        self._graph = None
        self.state: LmState | None = None
        self.consts: LmConstants | None = None
        self.settings: tuple | None = None
        self.launches: dict = {}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def capture(self, linearize: Callable, error: Callable, T0: torch.Tensor, settings: tuple) -> None:
        """Capture one trip over a state of T0's shape (``_record``);
        counts ``lm.graph_captures``."""
        lm_inner, rot_eps, trans_eps, init_lambda_factor = settings
        self.consts = lm_constants(lm_inner, T0.dtype, T0.device)
        self.state = lm_start(T0.clone())

        def trip(in_place: bool = False) -> LmState:
            s = self.state
            return lm_trip(linearize, error, s, self.consts, rot_eps=rot_eps, trans_eps=trans_eps,
                           init_lambda_factor=init_lambda_factor, out=s if in_place else None)

        self._graph, self.launches = self._record(trip, T0.device)
        self.settings = settings
        profiling.count("lm.graph_captures", 1)

    @staticmethod
    def _record(trip: Callable, dev: torch.device):
        """(the CUDA graph of ``trip(in_place=True)``, the hand-written
        kernels' launches its capture recorded), after one eager trip on the
        capture's stream: the kernels' first use, which a capture may not
        hold. That trip runs and counts; the capture runs nothing, so its
        launches are taken off the counts again."""
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            trip()
        before = dict(_build.COUNTS)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            trip(in_place=True)
        torch.cuda.current_stream(dev).wait_stream(side)
        launches = {k: n - before[k] for k, n in _build.COUNTS.items() if n != before[k]}
        _build.COUNTS.update(before)
        return graph, launches

    def start(self, T0: torch.Tensor) -> LmState:
        """The state buffers set to ``lm_start(T0)``'s values."""
        s = self.state
        s.T.copy_(T0)
        s.lam.fill_(-1.0)
        s.done.fill_(False)
        s.y.fill_(float("inf"))
        return s

    def replay(self, s: LmState) -> LmState:
        """One trip from the state buffers ``s`` into themselves."""
        self._graph.replay()
        for name, n in self.launches.items():
            _build.COUNTS[name] += n
        profiling.count("lm.graph_replays", 1)
        return s


def lm_solve(
    linearize: Callable,
    error: Callable,
    T0: torch.Tensor,
    *,
    max_iterations: int,
    lm_inner: int = 8,
    rot_eps: float = 2e-3,
    trans_eps: float = 5e-4,
    init_lambda_factor: float = 1e-9,
    graph: LmGraph | None = None,
) -> LsqResult:
    """Levenberg-Marquardt (step_lm, lsq_registration_impl.hpp:123-163).

    All ``lm_inner`` ladder steps are solved and evaluated at once, and the
    reference's sequential first-accept recovered by the first True of the
    event mask. ``final_cost`` is the linearization cost on entry to the
    last executed iteration, one accepted step stale, as in the reference.

    ``graph`` (CUDA): each trip is one replay of ``graph``, which the first
    solve captures over ``linearize`` and ``error`` (:class:`LmGraph` says
    what they may read); a solve with other settings than the capture's
    raises ValueError. Without it each trip runs :func:`lm_trip` eagerly.
    """
    batch = T0.shape[:-2]
    settings = (lm_inner, rot_eps, trans_eps, init_lambda_factor)
    if graph is None:
        consts = lm_constants(lm_inner, T0.dtype, T0.device)
        s = lm_start(T0)

        def trip(s):
            return lm_trip(linearize, error, s, consts, rot_eps=rot_eps, trans_eps=trans_eps,
                           init_lambda_factor=init_lambda_factor)
    else:
        if not graph.captured:
            graph.capture(linearize, error, T0, settings)
        elif graph.settings != settings:
            raise ValueError(f"lm_solve: settings {settings}, the graph was captured with {graph.settings}")
        s, trip = graph.start(T0), graph.replay
    trips = 0
    for _ in range(max_iterations):
        if bool(s.done.all()):
            break
        with profiling.span("refine.lm.trip"):
            trips += 1
            if profiling.active() is not None:
                # A graph's own mask is overwritten by its next replay.
                profiling.count_mask("lm.live", s.done if graph is None else s.done.clone(), False)
            s = trip(s)
    _count_solve(trips, batch)
    if graph is not None:  # the next solve overwrites the buffers
        s = LmState(s.T.clone(), s.lam, s.done.clone(), s.y.clone())
    return LsqResult(transform=s.T, converged=s.done, final_cost=s.y)
