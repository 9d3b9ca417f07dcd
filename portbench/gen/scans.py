"""The scan kind's inputs: labeled LiDAR scans of the synthetic world as a
semantic-only segmentation network labels an HDL-64E scan.

A frozen copy of ``chip_smoke.py``'s ``render_labeled_scan`` (the front
end's phase-9 renderer, itself ``tests/test_cli.py``'s at a scan's size):
every instance within the view radius a Gaussian blob of at least
``min_blob_points`` points, class ``min(label, 11) + 7``, instance id 0; a
class-10 sidewalk sheet with Gaussian height noise; about
``target_points`` points in all, padded to ``max_points``. Queries see the
world as the site cells' do: each visible instance dropped at the
configuration's rate, and a share of the points relabeled to class 20 (the
rule of ``io.readers.corrupt_labels``, out of every routing's range).

Host NumPy from the seed; nothing here imports the program, so a later
change to the program's renderers cannot move the yardstick (a CPU test
holds this equal to ``render_labeled_scan`` where their settings meet).
"""

from __future__ import annotations

import numpy as np

from portbench.gen import world

RELABEL_CLASS = 20


def render(wd: world.World, pose, seed, s: dict, dropout: float = 0.0, relabel: float = 0.0):
    """One labeled scan in the sensor frame: (points (P, 3) float32, sem
    (P,) int32), unpadded. ``s`` is the configuration's ``scans`` block;
    ``seed`` seeds the scan's own generator."""
    rng = np.random.default_rng(seed)
    tinv = np.linalg.inv(pose)
    local = wd.instance_xyz @ tinv[:3, :3].T + tinv[:3, 3]
    view = s["view_radius_m"]
    vis = np.nonzero(np.linalg.norm(local[:, :2], axis=1) < view)[0]
    if dropout > 0:
        vis = vis[rng.uniform(size=vis.size) > dropout]
    ground = s["ground_points"]
    ppi = max(s["min_blob_points"], (s["target_points"] - ground) // max(len(vis), 1))
    pts = [local[j] + rng.normal(0, s["blob_sigma_m"], (ppi, 3)) for j in vis]
    sem = [np.full(ppi, min(int(wd.instance_label[j]), 11) + 7) for j in vis]
    pts.append(np.column_stack([rng.uniform(-view, view, (ground, 2)), rng.normal(0, s["ground_noise_m"], ground)]))
    sem.append(np.full(ground, 10))
    pts = np.concatenate(pts).astype(np.float32)
    sem = np.concatenate(sem).astype(np.int32)
    if relabel > 0:
        sem[rng.uniform(size=sem.shape) <= relabel] = RELABEL_CLASS
    if len(pts) > s["max_points"]:
        raise ValueError(f"a scan of {len(pts)} points exceeds max_points {s['max_points']}")
    return pts, sem


def _stack(rendered, n: int) -> dict:
    """Scans padded to ``n`` points and stacked: points (F, n, 3) float32,
    sem (F, n) int32, mask (F, n) bool."""
    f = len(rendered)
    out = {"points": np.zeros((f, n, 3), np.float32), "sem": np.zeros((f, n), np.int32),
           "mask": np.zeros((f, n), bool)}
    for i, (p, s) in enumerate(rendered):
        out["points"][i, : len(p)] = p
        out["sem"][i, : len(p)] = s
        out["mask"][i, : len(p)] = True
    return out


def make_inputs(seed: int, config: dict, num_queries: int) -> dict:
    """The world, and the map's and the queries' scans as stacked host
    arrays (``_stack``), from the seed and the configuration's ``world``,
    ``scans`` and ``query_obs`` blocks. Instance ids are all 0 and are not
    stored."""
    w, s, q = config["world"], config["scans"], config["query_obs"]
    rng = np.random.default_rng(world.seed_of(seed))
    wd = world.make_world(rng, extent_m=w["extent_m"], num_map_frames=config["map_frames"], num_queries=num_queries)
    base = [abs(seed), int(seed < 0)]
    maps = [render(wd, p, base + [0, i], s) for i, p in enumerate(wd.map_poses)]
    queries = [render(wd, p, base + [1, i], s, q["dropout"], q["label_corrupt_rate"])
               for i, p in enumerate(wd.query_poses)]
    return {"world": wd, "maps": _stack(maps, s["max_points"]), "queries": _stack(queries, s["max_points"])}
