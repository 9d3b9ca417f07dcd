"""The plain reference front end: one labeled scan to its semantic graph,
as the upstream per-scan builder makes it (get_json.cpp:41-343, its DCVC
in cluster_manager.hpp:139-421 at the parameters of get_json.cpp:205-209),
in float64 PyTorch on any device.

The steps, each written plainly:

- routing (MulRan / SemanticKITTI train ids): class 10 is kept whole, as
  one node; classes 11-13 and 15-18 are clustered, with a minimum segment
  of 300 points (5 for classes 15, 17 and 18); other classes are dropped;
- DCVC over the clustered classes' points: the range gate (0.5 m < r <
  120 m); polar coordinates (range, pitch and azimuth in degrees, the
  azimuth in [0, 360)); radial bins of shrinking width, bin k (k = 1..512)
  ending ``start_r k - delta_r k (k + 1) / 2`` past the scan's least
  range; pitch bins of ``delta_p`` degrees from the scan's least pitch and
  azimuth bins of ``delta_a`` degrees, both by rounding; the class packed
  into the voxel id, so no cluster spans two classes;
- the occupied voxels and their 26-connected components, the azimuth
  wrapping around (bin -1 is the last bin, one past the last is bin 0),
  found by a plain fixed-point propagation of the least voxel id;
- clusters ranked by their points, largest first, ties to the component
  of the lesser voxel id, the first ``max_clusters`` kept; a cluster is a
  node where it holds at least its class's minimum segment;
- a node's centroid (the mean of its points) and density (the mean squared
  distance to the centroid); node labels through the node map (class c ->
  c - 7), kept in [3, 12];
- nodes in the order whole classes, then clusters by rank, the first
  ``max_nodes`` kept.

Departures from the C++, each also the port's (``cluster/dcvc.py``):

- the azimuth neighbours wrap symmetrically; the C++ clamps an azimuth
  index above 300 on one side only (``ax > 300``);
- all clustered classes go through one pass, the class in the voxel id,
  where the C++ runs one clusterManager a class: the same components;
- a ``.5`` bin rounds to even (``torch.round``) where C++'s ``round``
  rounds away from zero (a float64 tie does not occur in these scans).

Departures of this file alone:

- instance ids are not read: the scans carry none (a semantic-only
  network labels them), so the C++'s ground-truth instance grouping never
  runs;
- the occupied voxels are not capped (the port keeps the first 65,536);
- every quantity is float64 up to the graph, whose centroids and densities
  are rounded to the configuration's float32 once, at the end.

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.gen.world import Graph

# The MulRan / SemanticKITTI routing of get_json.cpp: classes kept whole,
# clustered classes with their minimum segment, the node map, the labels kept.
WHOLE_CLASSES = (10,)
MIN_SEG = {11: 300, 12: 300, 13: 300, 15: 5, 16: 300, 17: 5, 18: 5}
NODE_MAP = {10: 3, 11: 4, 12: 5, 13: 6, 14: 7, 15: 8, 16: 9, 17: 10, 18: 11}
KEEP = (3, 12)


@dataclasses.dataclass(frozen=True)
class Dcvc:
    """DCVC's parameters (get_json.cpp:205-209, cluster_manager.hpp:198)
    and the bins and clusters it keeps."""

    start_r: float = 0.35
    delta_r: float = 0.0004
    delta_p: float = 1.2
    delta_a: float = 1.2
    min_range: float = 0.5
    max_range: float = 120.0
    polar_bins: int = 512
    pitch_bins: int = 128
    max_clusters: int = 256


# The 26 neighbours of a voxel: (azimuth, polar, pitch) offsets.
NEIGHBOURS = [(a, p, t) for a in (-1, 0, 1) for p in (-1, 0, 1) for t in (-1, 0, 1) if (a, p, t) != (0, 0, 0)]


def _voxels(x: torch.Tensor, cls: torch.Tensor, d: Dcvc):
    """Each point's voxel as (class, azimuth, polar, pitch) bins, and the
    number of azimuth bins."""
    r = torch.linalg.vector_norm(x, dim=1)
    pitch = torch.rad2deg(torch.asin((x[:, 2] / r).clamp(-1.0, 1.0)))
    az = torch.rad2deg(torch.atan2(x[:, 1], x[:, 0]))
    az = torch.where(az < 0, az + 360.0, az)
    k = torch.arange(1, d.polar_bins + 1, dtype=x.dtype, device=x.device)
    ends = r.min() + torch.cumsum(d.start_r - d.delta_r * k, 0)
    polar = torch.searchsorted(ends, r, right=True).clamp(max=d.polar_bins - 1)
    pit = torch.round((pitch - pitch.min()) / d.delta_p).long().clamp(0, d.pitch_bins - 1)
    width = round(360.0 / d.delta_a) + 1
    azi = torch.round(az / d.delta_a).long().clamp(0, width - 1)
    return torch.stack([cls, azi, polar, pit], 1), width


def _key(v: torch.Tensor, width: int, d: Dcvc) -> torch.Tensor:
    """One int64 id a voxel, ordered as (class, azimuth, polar, pitch)."""
    return ((v[..., 0] * width + v[..., 1]) * d.polar_bins + v[..., 2]) * d.pitch_bins + v[..., 3]


def _components(vox: torch.Tensor, width: int, d: Dcvc):
    """The occupied voxels' ids (ascending), each point's voxel and each
    voxel's component: the index of the component's least voxel id."""
    key = _key(vox, width, d)
    ids, point_voxel = torch.unique(key, sorted=True, return_inverse=True)
    occ = torch.stack([ids // (width * d.polar_bins * d.pitch_bins), (ids // (d.polar_bins * d.pitch_bins)) % width,
                       (ids // d.pitch_bins) % d.polar_bins, ids % d.pitch_bins], 1)
    src, dst = [], []
    for da, dp, dt in NEIGHBOURS:
        n = occ + torch.tensor([0, da, dp, dt], device=occ.device)
        n[:, 1] = torch.where(n[:, 1] < 0, width - 1, torch.where(n[:, 1] >= width, 0, n[:, 1]))
        inside = (n[:, 2] >= 0) & (n[:, 2] < d.polar_bins) & (n[:, 3] >= 0) & (n[:, 3] < d.pitch_bins)
        nk = _key(n, width, d)
        at = torch.searchsorted(ids, nk).clamp(max=ids.numel() - 1)
        hit = inside & (ids[at] == nk)
        src.append(torch.nonzero(hit)[:, 0])
        dst.append(at[hit])
    src, dst = torch.cat(src), torch.cat(dst)
    label = torch.arange(ids.numel(), device=ids.device)
    while True:
        new = label.scatter_reduce(0, src, label[dst], reduce="amin")
        if torch.equal(new, label):
            return ids, point_voxel, label
        label = new


def build_graph(points, sem, mask, pose, max_nodes: int, device, d: Dcvc = Dcvc(), bf16: bool = False) -> Graph:
    """One scan's padded graph. points (N, 3) float32, sem (N,) int32, mask
    (N,) bool, host or device; ``bf16``: the points rounded to bfloat16
    first (the control)."""
    x = torch.as_tensor(points, device=device)
    if bf16:
        x = x.to(torch.bfloat16)
    x = x.to(torch.float64)
    sem = torch.as_tensor(sem, device=device).long()
    mask = torch.as_tensor(mask, device=device)
    labels, centers, density = [], [], []  # the nodes, in graph order
    for c in WHOLE_CLASSES:
        xc = x[mask & (sem == c)]
        if xc.shape[0]:
            labels.append(NODE_MAP[c])
            centers.append(xc.mean(0))
            density.append(((xc - centers[-1]) ** 2).sum(1).mean())

    pick = mask & torch.isin(sem, torch.tensor(sorted(MIN_SEG), device=sem.device))
    xs, cs = x[pick], sem[pick]
    r = torch.linalg.vector_norm(xs, dim=1)
    gate = (r > d.min_range) & (r < d.max_range)
    xs, cs = xs[gate], cs[gate]
    if xs.shape[0]:
        vox, width = _voxels(xs, cs, d)
        ids, point_voxel, comp = _components(vox, width, d)
        comp = comp[point_voxel]  # each point's component
        size = torch.bincount(comp, minlength=ids.numel())
        roots = torch.nonzero(size)[:, 0]  # ascending: ties go to the lesser voxel id
        ranked = roots[torch.sort(-size[roots], stable=True).indices][: d.max_clusters]
        rank = torch.full_like(size, -1)
        rank[ranked] = torch.arange(ranked.numel(), device=rank.device)
        pc = rank[comp]
        kept = pc >= 0
        pc, xk = pc[kept], xs[kept]
        k = ranked.numel()
        count = torch.bincount(pc, minlength=k)
        cent = torch.zeros((k, 3), dtype=x.dtype, device=x.device).index_add_(0, pc, xk) / count[:, None]
        dens = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(0, pc, ((xk - cent[pc]) ** 2).sum(1)) / count
        cls = torch.zeros_like(count).scatter_(0, pc, cs[kept]).tolist()
        ok = (count >= torch.tensor([MIN_SEG[c] for c in cls], device=count.device)).cpu().numpy()
        cent, dens = cent.cpu(), dens.cpu()
        for j in np.nonzero(ok)[0]:
            labels.append(NODE_MAP[cls[j]])
            centers.append(cent[j])
            density.append(dens[j])

    keep = [i for i, lab in enumerate(labels) if KEEP[0] <= lab <= KEEP[1]][:max_nodes]
    g = Graph(np.zeros((max_nodes, 3), np.float32), np.zeros(max_nodes, np.int32), np.zeros(max_nodes, np.float32),
              np.zeros(max_nodes, bool), np.asarray(pose, np.float32).reshape(4, 4))
    for row, i in enumerate(keep):
        g.centers[row] = centers[i].cpu().numpy()
        g.labels[row] = labels[i]
        g.density[row] = float(density[i])
        g.mask[row] = True
    return g
