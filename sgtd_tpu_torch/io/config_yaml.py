"""Reference-YAML config loading (port of sgtd_tpu.io.config_yaml).

Maps the reference's parameter names (src/sgtd/config/SG_localization.yaml,
read by read_parameters at src/sgtd/src/STDesc.cpp:18-70 and the node at
semantic_graph_localization.cpp:216-241) onto the port's SGTDConfig.
PyYAML is imported inside the function: a machine without it can still
import this module.
"""

from __future__ import annotations

import dataclasses

from sgtd_tpu_torch.config import SGTDConfig


def config_from_yaml(path: str, base: SGTDConfig | None = None) -> SGTDConfig:
    import yaml

    with open(path) as f:
        y = yaml.safe_load(f) or {}
    cfg = base or SGTDConfig()

    desc = dataclasses.replace(
        cfg.desc,
        near_num=int(y.get("descriptor_near_num", cfg.desc.near_num)),
        min_len=float(y.get("descriptor_min_len", cfg.desc.min_len)),
        max_len=float(y.get("descriptor_max_len", cfg.desc.max_len)),
        side_resolution=float(y.get("std_side_resolution", cfg.desc.side_resolution)),
    )
    search = dataclasses.replace(
        cfg.search,
        candidate_num=int(y.get("candidate_num", cfg.search.candidate_num)),
        rough_dis_threshold=float(y.get("rough_dis_threshold", cfg.search.rough_dis_threshold)),
        icp_threshold=float(y.get("icp_threshold", cfg.search.icp_threshold)),
    )
    g = y.get("fast_gicp", {}) or {}
    sg = y.get("SG_data", {}) or {}
    gicp = dataclasses.replace(
        cfg.gicp,
        enable=bool(g.get("enable_gicp", cfg.gicp.enable)),
        num_neighbors=int(g.get("num_neighbors", cfg.gicp.num_neighbors)),
        max_iterations=int(g.get("max_iterations", cfg.gicp.max_iterations)),
        leaf_size=float(sg.get("leaf_size", cfg.gicp.leaf_size)),
        best_fitness=float(sg.get("best_fitness", cfg.gicp.best_fitness)),
    )
    return cfg.replace(desc=desc, search=search, gicp=gicp)
