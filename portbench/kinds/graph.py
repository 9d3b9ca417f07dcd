"""The graph kind, a configuration without a ``kind`` key: graph
localization of query scans against a map index built from host graphs and
keyframe clouds (``gen.world``'s synthetic world), served by
``program.Service`` and judged against ``reference.pipeline`` by
``check.numbers``.

The program is imported when a service is made, not with this module, so
that loading a cell imports nothing of it.
"""

from __future__ import annotations

import numpy as np

from portbench.check import far, gaps, numbers
from portbench.gen import world
from portbench.reference.pipeline import answers as reference  # noqa: F401 - the kind's reference

# Thresholds, in metres, at which ``readings`` counts far answers: the
# ladder the cells' ``_far_n`` thresholds were chosen from.
LADDER = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0)


def check(config: dict, traffic: dict) -> None:
    if (traffic["entry"] == "localize_refined") != (traffic["rerank_k"] > 0):
        raise ValueError("localize_refined, and only it, re-ranks candidates")


def make_inputs(seed: int, config: dict, traffic: dict) -> dict:
    return world.make_inputs(seed, config, traffic["queries"], traffic.get("rerank_k", 0) > 0)


def Service(inputs: dict, config: dict, traffic: dict, device):  # noqa: N802 - the kind's constructor
    from portbench.program import Service

    return Service(inputs, config, traffic, device)


def control_answers(ref_ctl: dict) -> list:
    """The control's answers as the check reads the program's."""
    keys = ("num_desc", "frames", "votes", "found", "best_frame", "pose", "refined", "final_pose")
    return [(np.arange(len(ref_ctl["found"])), {k: ref_ctl[k] for k in keys if k in ref_ctl})]


def readings(answers, ref: dict) -> dict:
    """The compared numbers, the queries the reference answered through
    TRUNC_SCAN, and the far counts at each threshold of ``LADDER``."""
    g = gaps(answers, ref)
    kinds = ("top", "fin") if "fin" in g else ("top",)
    return dict(numbers(answers, ref), trunc=int(ref["trunc"].sum()),
                far={k: {str(t): far(g, k, t) for t in LADDER} for k in kinds})
