"""Dynamic Curved-Voxel Clustering (DCVC) on tensors (port of
sgtd_tpu.cluster.dcvc).

The reference's ``clusterManager`` (cluster_manager.hpp:137-421) as one
pass over a whole scan: points become (range, pitch, azimuth) curved-voxel
coordinates (radial bins of shrinking width, pitch and azimuth bins of
``delta_p`` / ``delta_a`` degrees, the point's group packed into the voxel
id so clusters never span classes), occupied voxels are found by
sort/unique, their 26-connected components by min-label propagation with
pointer jumping (``cluster.components``, shared with FEC), and components
become cluster slots, largest first, with centroids, densities and the
``min_seg`` filter. Azimuth neighbours wrap around 360 degrees; the
reference C++'s asymmetric ``ax > 300`` clamp is not reproduced (neither
does the JAX package).

Voxel coordinates decide clusters, so they follow the JAX reference's
float32 arithmetic as XLA:CPU compiles it, on any device:

* ``|p|^2`` as the FMA chain ``fma(z, z, fma(y, y, x * x))`` and a
  correctly rounded root;
* ``arcsin`` as XLA lowers it, ``2 atan2(s, 1 + sqrt((1 - s)(1 + s)))``,
  with ``atan2`` the float32 libm routine XLA:CPU calls (glibc's
  fdlibm ``atan2f`` / ``atanf``), written out in float32 operations;
* divisions by ``delta_p`` and ``delta_a`` as multiplications by their
  float32 reciprocals (XLA's rewrite of a division by a constant), the
  pitch offset as ``fma(asin, 180/pi, -min_pitch)`` and the radial bounds
  as ``fma(k, start_r, min_polar) - delta_r k (k + 1) / 2`` (the pairs
  XLA:CPU contracts).

Cluster sums run over each cluster's points in point order (the
reference's scatter order), with no atomics on the card: K3
``ops.grouped.grouped_sums``, which never reads an unclustered point.

Under the tracer (``utils.profiling``), a call is the span
``cluster.dcvc`` holding ``dcvc.voxels`` (coordinates, occupied voxels,
neighbour slots), ``dcvc.components`` (the propagation) and
``dcvc.stats`` (cluster slots and their sums), with the counters
``dcvc.sweeps`` (propagation sweeps, known on the host) and
``dcvc.voxels`` (occupied voxels).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sgtd_tpu_torch.cluster import components
from sgtd_tpu_torch.config import DcvcConfig
from sgtd_tpu_torch.ops import grouped
from sgtd_tpu_torch.utils import fma_f32, profiling, segment_max, sorted_unique_head, sq_norm_fma, sqrt_rn

I32_MAX = 2**31 - 1

# Packing strides for voxel ids: pitch < 128, polar < 512, azimuth < 512,
# group (semantic class) < 32: 7+9+9+5 = 30 bits.
_PITCH_MAX = 128
_POLAR_MAX = 512
_POLAR_STRIDE = _PITCH_MAX
_AZ_STRIDE = _POLAR_MAX * _PITCH_MAX
_GROUP_STRIDE = 512 * _AZ_STRIDE
_GROUP_MAX = 32


class ClusterResult(NamedTuple):
    """Padded clustering output.

    point_cluster: (N,) int32 — cluster slot per point (-1 = unclustered).
    centroids:     (C, 3) float32.
    counts:        (C,) int32 — points per cluster.
    density:       (C,) float32 — mean squared distance to centroid.
    group:         (C,) int32 — the group (semantic class) of the cluster;
                   int32 min for an empty slot, as the reference's
                   ``segment_max`` leaves it.
    valid:         (C,) bool — count >= the cluster's min_seg.
    """

    point_cluster: torch.Tensor
    centroids: torch.Tensor
    counts: torch.Tensor
    density: torch.Tensor
    group: torch.Tensor
    valid: torch.Tensor


# 26-neighbourhood offsets (excluding self) over (azimuth, polar, pitch).
_NEIGH = np.array(
    [(a, p, t) for a in (-1, 0, 1) for p in (-1, 0, 1) for t in (-1, 0, 1) if (a, p, t) != (0, 0, 0)],
    dtype=np.int32,
)


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# glibc's fdlibm atanf (sysdeps/ieee754/flt-32/s_atanf.c): the float32
# constants as the library holds them.
_ATANHI = (_f32(0x3EED6338), _f32(0x3F490FDA), _f32(0x3F7B985E), _f32(0x3FC90FDA))
_ATANLO = (_f32(0x31AC3769), _f32(0x33222168), _f32(0x33140FB4), _f32(0x33A22168))
_AT = tuple(_f32(b) for b in (
    0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
    0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7,
))
_PI, _PI_O_2, _PI_LO = _f32(0x40490FDB), _f32(0x3FC90FDB), _f32(0xB3BBBD2E)
_RAD2DEG = float(np.float32(180.0 / np.pi))


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full_like(x, v)


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``atanf``, operation by operation (each a float32
    rounding, so any device gives the library's bits)."""
    ix = x.view(torch.int32) & 0x7FFFFFFF
    ax = x.abs()
    one = _const(x, 1.0)
    # Argument reduction (each branch computed everywhere, then selected).
    r0 = (ax + ax - one) / (ax + 2.0)
    r1 = (ax - one) / (ax + one)
    r2 = (ax - 1.5) / (ax * 1.5 + one)
    r3 = _const(x, -1.0) / ax
    small = ix < 0x3EE00000  # |x| < 7/16: no reduction, sign kept
    idx = torch.where(ix < 0x3F300000, 0, torch.where(ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3)))
    xr = torch.where(small, x, torch.where(idx == 0, r0, torch.where(idx == 1, r1, torch.where(idx == 2, r2, r3))))
    z = xr * xr
    w = z * z
    a = _AT
    s1 = z * (((((w * a[10] + a[8]) * w + a[6]) * w + a[4]) * w + a[2]) * w + a[0])
    s2 = ((((w * a[9] + a[7]) * w + a[5]) * w + a[3]) * w + a[1]) * w
    t = xr * (s1 + s2)
    hi = torch.tensor(_ATANHI, dtype=x.dtype, device=x.device)[idx]
    lo = torch.tensor(_ATANLO, dtype=x.dtype, device=x.device)[idx]
    big = hi - ((t - lo) - xr)
    big = torch.where(x < 0, -big, big)
    huge = _const(x, _ATANHI[3]) + _ATANLO[3]  # |x| >= 2^25
    huge = torch.where(x < 0, -huge, huge)
    out = torch.where(small, torch.where(ix < 0x31000000, x, xr - t), big)
    return torch.where(ix >= 0x4C000000, huge, out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``atan2f`` (e_atan2f.c) for finite inputs: the
    routine XLA:CPU calls for the reference's ``atan2``."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 * sign(x) + sign(y)
    k = (iy - ix) >> 23
    z = _atanf((y / x).abs())
    z = torch.where(k > 60, _const(x, _PI_O_2) + 0.5 * _PI_LO, z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    out = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(
        m == 2, _PI - (z - _PI_LO), (z - _PI_LO) - _PI)))
    on_axis = torch.where(m == 0, y, torch.where(m == 1, y, torch.where(m == 2, _const(y, _PI), _const(y, -_PI))))
    out = torch.where(iy == 0, on_axis, out)
    return torch.where((ix == 0) & (iy != 0), torch.where(hy < 0, _const(y, -_PI_O_2), _const(y, _PI_O_2)), out)


def asinf(s: torch.Tensor) -> torch.Tensor:
    """``arcsin(s)`` for s in [-1, 1] as XLA lowers it:
    ``2 atan2f(s, 1 + sqrt((1 - s)(1 + s)))``."""
    one = torch.ones_like(s)
    return 2.0 * atan2f(s, sqrt_rn((one - s) * (one + s)) + one)


def _voxel_coords(points: torch.Tensor, mask: torch.Tensor, cfg: DcvcConfig):
    """Point -> (azimuth, polar, pitch) integer voxel coordinates, the
    range-gate mask and the azimuth width."""
    x, y, z = points.unbind(-1)
    r = sqrt_rn(sq_norm_fma(points))
    r_safe = torch.maximum(r, _const(r, 1e-6))
    s = (z / r_safe).clamp(-1.0, 1.0)
    asin = asinf(s)
    pitch = asin * _RAD2DEG
    az = atan2f(y, x) * _RAD2DEG
    az = torch.where(az < 0, az + 360.0, az)

    ok = mask & (r > cfg.min_range) & (r < cfg.max_range)
    big = _const(r, 1e9)
    min_pitch = torch.where(ok, pitch, big).min()
    min_polar = torch.where(ok, r, big).min()

    # Radial bin: searchsorted over the closed-form shrinking bin bounds
    # bound_k = min_polar + k*startR - deltaR*k(k+1)/2, k = 1..512.
    ks = torch.arange(1, _POLAR_MAX + 1, dtype=torch.float32, device=points.device)
    start_r, delta_r = float(np.float32(cfg.start_r)), float(np.float32(cfg.delta_r))
    bounds = fma_f32(ks, _const(ks, start_r), min_polar.expand_as(ks)) - ks * delta_r * (ks + 1.0) * 0.5
    polar_idx = torch.searchsorted(bounds, r.contiguous(), right=True).clamp(0, _POLAR_MAX - 1).to(torch.int32)

    inv_p = float(np.float32(1.0) / np.float32(cfg.delta_p))
    inv_a = float(np.float32(1.0) / np.float32(cfg.delta_a))
    off = fma_f32(asin, _const(asin, _RAD2DEG), -min_pitch.expand_as(asin))
    pitch_idx = torch.round(off * inv_p).to(torch.int32).clamp(0, _PITCH_MAX - 1)
    width = round(360.0 / cfg.delta_a) + 1
    az_idx = torch.round(az * inv_a).to(torch.int32).clamp(0, width - 1)
    return az_idx, polar_idx, pitch_idx, ok, width


def _pack(az, polar, pitch):
    return az * _AZ_STRIDE + polar * _POLAR_STRIDE + pitch


@profiling.traced("cluster.dcvc")
def dcvc_cluster(
    points: torch.Tensor,
    mask: torch.Tensor,
    min_seg: torch.Tensor | int,
    cfg: DcvcConfig = DcvcConfig(),
    group: torch.Tensor | None = None,
) -> ClusterResult:
    """Cluster the masked points of one scan.

    points: (N, 3) float32 (padded); mask: (N,) bool; min_seg: minimum
    cluster size, a scalar or per-point values (per-class thresholds);
    group: optional (N,) int32 in [0, 32): points of different groups never
    join one cluster. Runs on the points' device.
    """
    dev = points.device
    n = points.shape[0]
    v_max = min(cfg.max_voxels, n)
    c_max = cfg.max_clusters
    i32 = dict(dtype=torch.int32, device=dev)

    with profiling.span("dcvc.voxels"):
        az, polar, pitch, ok, width = _voxel_coords(points, mask, cfg)
        g = torch.zeros(n, **i32) if group is None else group.to(torch.int32).clamp(0, _GROUP_MAX - 1)
        vid = torch.where(ok, g * _GROUP_STRIDE + _pack(az, polar, pitch), I32_MAX).to(torch.int32)

        # Occupied voxels: the first v_max distinct ids, ascending.
        uvid = sorted_unique_head(vid, v_max, I32_MAX)
        v_valid = uvid != I32_MAX
        profiling.count_mask("dcvc.voxels", v_valid, True)
        pslot = torch.searchsorted(uvid, vid).to(torch.int32)
        pslot = torch.where(ok, pslot.clamp(max=v_max - 1), v_max - 1)

        # Neighbour slots per occupied voxel (26-connectivity, same group).
        ug = uvid // _GROUP_STRIDE
        urest = uvid % _GROUP_STRIDE
        ua, up, ut = urest // _AZ_STRIDE, (urest % _AZ_STRIDE) // _POLAR_STRIDE, urest % _POLAR_STRIDE
        offs = torch.from_numpy(_NEIGH).to(dev)
        na = ua[:, None] + offs[None, :, 0]
        na = torch.where(na < 0, width - 1, na)  # azimuth wrap (ref :375-376)
        na = torch.where(na >= width, 0, na)
        np_ = up[:, None] + offs[None, :, 1]
        nt = ut[:, None] + offs[None, :, 2]
        coord_ok = (np_ >= 0) & (np_ < _POLAR_MAX) & (nt >= 0) & (nt < _PITCH_MAX)
        nvid = (ug[:, None] * _GROUP_STRIDE
                + _pack(na, np_.clamp(0, _POLAR_MAX - 1), nt.clamp(0, _PITCH_MAX - 1))).to(torch.int32)
        nslot = torch.searchsorted(uvid, nvid).to(torch.int32).clamp(max=v_max - 1)
        n_ok = coord_ok & v_valid[:, None] & (uvid[nslot.long()] == nvid)
        init = torch.arange(v_max, **i32)
        nslot = torch.where(n_ok, nslot, init[:, None]).long()

    # Connected components: each voxel labelled by its component's
    # smallest slot.
    with profiling.span("dcvc.components"):
        label, sweeps = components.min_labels(init, nslot)
        profiling.count("dcvc.sweeps", sweeps)

    with profiling.span("dcvc.stats"):
        # Compact component roots into cluster slots, largest first.
        ok_f = ok.to(torch.float32)
        pcount_v = torch.zeros(v_max, dtype=torch.float32, device=dev).index_add_(0, pslot.long(), ok_f)
        root_pts = torch.zeros(v_max, dtype=torch.float32, device=dev).index_add_(0, label.long(), pcount_v)
        is_root = (label == init) & v_valid
        slot_of_root = components.root_slots(torch.where(is_root, root_pts, -1.0), c_max)
        vox_cluster = torch.where(v_valid, slot_of_root[label.long()], -1)
        pc = torch.where(ok, vox_cluster[pslot.long()], -1)

        # Per-cluster stats (K3 leaves the unclustered points out); for the
        # maxima, slot c_max gathers them.
        counts, sums, sq = grouped.grouped_sums(points, pc, c_max)
        denom = counts.clamp(min=1.0)[:, None]
        centroids = sums / denom
        density = sq / denom[:, 0] - sq_norm_fma(centroids)
        seg = torch.where(pc >= 0, pc, c_max)
        cgroup = segment_max(torch.where(pc >= 0, g, 0), seg, c_max + 1)[:c_max]
        min_seg_arr = torch.as_tensor(min_seg, dtype=torch.float32, device=dev).expand(n)
        c_min_seg = segment_max(torch.where(pc >= 0, min_seg_arr, 0.0), seg, c_max + 1)[:c_max]
        valid = (counts >= c_min_seg.clamp(min=1.0)) & (counts > 0)

        keep = torch.where(pc >= 0, valid[pc.clamp(min=0).long()], False)
        pc = torch.where(keep, pc, -1)
    return ClusterResult(
        point_cluster=pc.to(torch.int32),
        centroids=centroids,
        counts=counts.to(torch.int32),
        density=density.clamp(min=0.0),
        group=cgroup,
        valid=valid,
    )
