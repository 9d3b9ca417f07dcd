"""Configuration of the PyTorch port: frozen dataclasses, field for field
the reference's ``sgtd_tpu.config`` with the same defaults.

Parameter names mirror the reference ROS/YAML knobs so results are comparable:
reference ``ConfigSetting`` (src/sgtd/include/desc/STDesc.h:38-72, read at
src/sgtd/src/STDesc.cpp:18-70) and node-level params
(src/sgtd/src/semantic_graph_localization.cpp:216-241). Canonical values from
src/sgtd/config/SG_localization.yaml.

The port keeps its own copy so that it runs where the JAX package is
absent; ``sgtd_tpu_torch.interop.config_from_reference`` turns a reference
config into this one. Like the reference's fixed-shape programs, the port's
batched stages take static capacity knobs (padding sizes) in place of the
reference node's unbounded containers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    """Triangle-descriptor construction (ref STDesc.cpp:174-315)."""

    # kNN neighbourhood used to enumerate triangles (descriptor_near_num).
    near_num: int = 10
    # Side-length gates in metres (descriptor_min_len / descriptor_max_len).
    min_len: float = 0.5
    max_len: float = 50.0
    # Side lengths are stored as ``scale * len`` with scale = 1/std_side_resolution
    # (ref STDesc.cpp:178,298). yaml: std_side_resolution: 1
    side_resolution: float = 1.0

    @property
    def scale(self) -> float:
        return 1.0 / self.side_resolution


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Candidate search + verification (ref STDesc.cpp:318-547)."""

    # Number of candidate frames kept after voting (candidate_num).
    candidate_num: int = 50
    # Rough side-length match threshold: dis < ||sides|| * rough_dis_threshold
    # (ref STDesc.cpp:356-357,378).
    rough_dis_threshold: float = 0.03
    # Minimum votes for a frame to become a candidate (ref STDesc.cpp:433).
    min_votes: float = 5.0
    # Loop acceptance: best verify score must exceed this (icp_threshold,
    # ref STDesc.cpp:138).
    icp_threshold: float = 0.4
    # Vertex inlier distance for geometric verification in metres
    # (ref STDesc.cpp:469 ``dis_threshold = 3.0`` hard-coded).
    verify_dis_threshold: float = 3.0
    # Minimum hypothesis votes to accept a candidate (ref STDesc.cpp:515).
    min_hypothesis_votes: int = 4
    # Max rigid-transform hypotheses sampled per candidate (ref STDesc.cpp:467:
    # skip_len sampling targets <= 50 hypotheses).
    max_hypotheses: int = 50


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Static paddings replacing the reference's dynamic containers."""

    # Max semantic-graph nodes per keyframe (ref maximum_corner_num = 100).
    max_nodes: int = 128
    # Max deduplicated descriptors kept per scan.
    max_descriptors: int = 2048
    # Max DB bucket entries scanned per key probe (reference scans full
    # buckets, ref STDesc.cpp:372; we cap for static shapes — the DB build
    # reports how many rows exceed this).
    bucket_cap: int = 256
    # Static cap on the TOTAL ragged bucket-scan length per query (sum of
    # probed bucket sizes). The scan is exact up to this cap; beyond it the
    # tail probes are dropped.
    max_scan_slots: int = 262144
    # Max matches kept per query descriptor for pair extraction (the vote
    # tally itself is exact; this only bounds the verification pair lists).
    hits_per_descriptor: int = 16
    # Max query probes sharing one exact probe key scanned per DB row during
    # candidate-major pair extraction (distinct descriptors rarely share a
    # quantised key after dedup).
    probes_per_key: int = 8
    # Max match pairs per candidate frame fed to verification.
    pairs_per_candidate: int = 512
    # Max keyframes in the descriptor database (ref MAX_FRAME_N = 20000,
    # STDesc.h:33 — a hard limit there; here just the vote-array padding and
    # liftable per instance).
    max_frames: int = 20000
    # Slots in the direct-addressed (cell, code) bucket table (64 MB at the
    # default: two int32 words a slot). Probes become O(1) parallel gathers
    # instead of a sequential in-cell binary search; DBs whose
    # used_cells x used_codes product
    # exceeds this fall back to bisection automatically.
    bucket_table_slots: int = 1 << 23
    # Pair-extraction strategy switch: up to this many calibrated scan
    # slots, hits are compacted per descriptor during the probe scan (the
    # sel path, one L-sized scatter); beyond it, pair lists are built
    # CANDIDATE-MAJOR from the frame-major row index instead
    # (match.search.extract_pairs_by_frame: cost independent of L, and
    # the per-descriptor strided subsample is replaced by exact per-frame
    # pair lists). The value is the reference's.
    sel_max_scan_slots: int = 4 << 20


@dataclasses.dataclass(frozen=True)
class GicpConfig:
    """Batched GICP refinement (ref fast_gicp, config fast_gicp block)."""

    enable: bool = False
    num_neighbors: int = 20  # k for covariance estimation
    max_iterations: int = 10
    # Voxel downsample leaf size for query/map clouds (SG_data/leaf_size).
    leaf_size: float = 3.0
    # Early-accept fitness (SG_data/best_fitness) on the RAW (ungated)
    # mean squared NN distance — PCL getFitnessScore semantics, kept for
    # reference parity.
    best_fitness: float = 15.0
    # Radius for the GATED alignment measures (fitness_gated /
    # inlier_frac, refine.gicp.GicpResult): 0.0 = auto, max(1.0,
    # leaf_size). Raw fitness is dominated by view-overlap geometry when
    # query and keyframe fields of view differ (measured: the CORRECT
    # candidate's raw fitness can be 2x a wrong aliased candidate's purely
    # from disc overlap) — the rerank pick therefore uses the gated
    # measures; see match.pipeline.rerank_pick.
    fitness_radius_m: float = 0.0

    @property
    def fitness_radius(self) -> float:
        """Effective gated-fitness radius (auto tracks the leaf size: two
        independently downsampled clouds cannot have NN distances below
        the voxel quantisation floor)."""
        if self.fitness_radius_m > 0:
            return self.fitness_radius_m
        return max(1.0, self.leaf_size)
    # Max points after downsampling (static shape).
    max_points: int = 8192
    # GN/LM convergence thresholds (ref lsq_registration_impl.hpp:82).
    rot_eps: float = 2e-3
    trans_eps: float = 5e-4
    # Plane regularization eigenvalues (ref fast_gicp_impl.hpp:284).
    plane_eps: float = 1e-3
    # Registration engine: "gicp" (point-to-point NN, ref fast_gicp) or
    # "vgicp" (Gaussian voxel map, ref fast_vgicp).
    engine: str = "gicp"
    # SE(3) stepping: "lm" (the reference's default optimizer,
    # lsq_registration_impl.hpp:15, trust region :123-163) or "gn" (plain
    # Gauss-Newton). Both solve their 6x6 systems with the unrolled
    # Cholesky of ops.linalg3.chol_solve6.
    optimizer: str = "lm"
    # LM knobs (ref LsqRegistration ctor, lsq_registration_impl.hpp:9-21).
    lm_max_inner: int = 8  # ref lm_max_iterations_ = 10
    lm_init_lambda_factor: float = 1e-9
    # GN step damping. The reference's step_gn solves the UNDAMPED normal
    # equations (lsq_registration_impl.hpp:106-113) and explodes on
    # rank-deficient H (degenerate geometry) — which is why LM is its
    # default optimizer. The small fixed damping here keeps the fast GN
    # path safe on such scenes; set 0.0 for reference-exact GN.
    gn_damping: float = 1e-6
    # VGICP voxel map (ref FastVGICP ctor, fast_vgicp_impl.hpp:19-25).
    voxel_resolution: float = 1.0
    neighbor_search: str = "direct1"  # direct1 | direct7 | direct27
    voxel_mode: str = "additive"  # additive | multiplicative
    # Max NN correspondence distance in metres; pairs beyond it are dropped
    # from the linearization entirely (ref fast_gicp corr_dist_threshold_,
    # fast_gicp_impl.hpp:18,139 — infinite by default there and here; the
    # node's tuning surface exposes it as setMaxCorrespondenceDistance,
    # semantic_graph_localization.cpp:668). Finite values remove the
    # partial-overlap drag when query and keyframe view fields differ.
    max_corr_dist_m: float = float("inf")
    # Reject a refinement that moves the pose further than this from ITS
    # OWN candidate's geometrically-verified descriptor estimate (a
    # diverged ICP on repetitive structure; guard absent in the reference).
    # Per-candidate (not top-1-relative) since round 5 — that is what lets
    # the rerank rescue a wrong top-1 frame. Both a
    # translation and a rotation gate: wrong-basin refinements on
    # low-structure clouds can rotate grossly while translating little.
    max_refine_shift_m: float = 3.0
    max_refine_rot_deg: float = 10.0


@dataclasses.dataclass(frozen=True)
class DcvcConfig:
    """Dynamic Curved-Voxel Clustering (ref cluster_manager.hpp:137-385,
    parameter values from get_json.cpp:205-209)."""

    start_r: float = 0.35
    delta_r: float = 0.0004
    delta_p: float = 1.2
    delta_a: float = 1.2
    min_seg: int = 300
    # Polar range gates (ref cluster_manager.hpp:198).
    min_range: float = 0.5
    max_range: float = 120.0
    # Static caps.
    max_points: int = 131072
    max_voxels: int = 65536
    max_clusters: int = 256


@dataclasses.dataclass(frozen=True)
class SGTDConfig:
    desc: DescriptorConfig = DescriptorConfig()
    search: SearchConfig = SearchConfig()
    caps: CapacityConfig = CapacityConfig()
    gicp: GicpConfig = GicpConfig()
    dcvc: DcvcConfig = DcvcConfig()
    # Success gates (ref semantic_graph_localization.cpp:750): T<5m, R<10deg.
    success_trans_m: float = 5.0
    success_rot_deg: float = 10.0
    # Recall@K gate (ref semantic_graph_localization.cpp:639): T<10m.
    recall_trans_m: float = 10.0

    def replace(self, **kw) -> "SGTDConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SGTDConfig()
