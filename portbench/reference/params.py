"""The configuration's settings, as the plain reference reads them: the
upstream SGTD values of ``src/sgtd/config/SG_localization.yaml`` (the
program's ``SGTDConfig`` defaults; a CPU test holds the two equal) and the
static capacities that define the program's pair lists. A configuration
file's ``overrides`` replace fields by name.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Params:
    # Triangle descriptors (STDesc.cpp:174-315).
    near_num: int = 10
    min_len: float = 0.5
    max_len: float = 50.0
    side_resolution: float = 1.0
    # Search and verification (STDesc.cpp:318-547).
    candidate_num: int = 50
    rough_dis_threshold: float = 0.03
    min_votes: float = 5.0
    icp_threshold: float = 0.4
    verify_dis_threshold: float = 3.0
    min_hypothesis_votes: int = 4
    max_hypotheses: int = 50
    # Capacities that decide which pairs a candidate's list holds.
    max_nodes: int = 128
    max_descriptors: int = 2048
    max_scan_slots: int = 262144
    hits_per_descriptor: int = 16
    probes_per_key: int = 8
    pairs_per_candidate: int = 512
    sel_max_scan_slots: int = 4 << 20
    calibrate_queries: int = 16
    calibrate_margin: float = 1.5
    # GICP and its LM optimizer (fast_gicp, lsq_registration_impl.hpp).
    num_neighbors: int = 20
    max_iterations: int = 10
    leaf_size: float = 3.0
    fitness_radius_m: float = 0.0
    rot_eps: float = 2e-3
    trans_eps: float = 5e-4
    plane_eps: float = 1e-3
    lm_max_inner: int = 8
    lm_init_lambda_factor: float = 1e-9
    max_corr_dist_m: float = math.inf
    max_refine_shift_m: float = 3.0
    max_refine_rot_deg: float = 10.0

    @property
    def fitness_radius(self) -> float:
        return self.fitness_radius_m if self.fitness_radius_m > 0 else max(1.0, self.leaf_size)

    @property
    def extent(self) -> int:
        """Quantised side cells an axis."""
        return int(math.floor(self.max_len / self.side_resolution)) + 2


def params_of(config: dict) -> Params:
    """The reference's settings of a configuration file: its ``overrides``
    ({group: {field: value}}) applied field by field."""
    flat = {k: v for group in config.get("overrides", {}).values() for k, v in group.items()}
    flat["max_nodes"] = config["world"]["max_nodes"]
    flat["calibrate_queries"] = config["calibrate_queries"]
    return dataclasses.replace(Params(), **flat)
