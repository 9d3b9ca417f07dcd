"""Readings behind a cell's limits (not run by the benchmark's own runs).

    python3 portbench/readings.py --workload <cell> --seeds <n> [<n> ...] [--control]

For each seed: the cell's set-up, two passes of whole requests over every
query of the cell (``replay_off``: answers of the second pass that differ
in any bit from the first's), and the check's numbers against the
reference (the sound runs' readings), with the ``_far_n`` counts at a
ladder of thresholds (``far``). With ``--control``, also the numbers of the control:
the reference itself in the program's place, computed in the precision
below the configuration's (float32 with TF32 matrix products). One JSON
line a seed on standard output.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0)


def control_answers(ref_ctl: dict) -> list:
    """The control's answers as the check reads the program's."""
    keys = ("num_desc", "frames", "votes", "found", "best_frame", "pose", "refined", "final_pose")
    return [(np.arange(len(ref_ctl["found"])), {k: ref_ctl[k] for k in keys if k in ref_ctl})]


def readings(name: str, seed: int, control: bool, device: str = "cuda", root: str = ROOT, base=None) -> dict:
    from portbench import harness
    from portbench.reference.pipeline import answers as reference

    spec = harness.load_cell(root, name, base or harness.HERE)
    r = harness.Run(spec, seed, device)
    r.svc.build()
    t0 = time.perf_counter()
    answers = [(ids, r.svc.serve(i)) for i, (ids, _) in enumerate(r.svc.batches)]
    serve_s = time.perf_counter() - t0
    again = [r.svc.serve(i) for i in range(len(r.svc.batches))]
    replay_off = sum(int(sum(not np.array_equal(a[k][j], b[k][j]) for k in a) > 0)
                     for (_, a), b in zip(answers, again) for j in range(len(a["found"])))
    r.svc.free()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference(r.inputs, spec["config"], spec["traffic"], device)
    out = {"seed": seed, "rows": r.svc.report.num_rows, "serve_s": serve_s, "reference_s": time.perf_counter() - t0,
           "trunc": int(ref["trunc"].sum()), "replay_off": replay_off, "sound": _read(answers, ref)}
    if control:
        ctl = reference(r.inputs, spec["config"], spec["traffic"], device, control=True)
        out["control"] = _read(control_answers(ctl), ref)
    return out


def _read(answers, ref) -> dict:
    from portbench import check

    g = check.gaps(answers, ref)
    kinds = ("top", "fin") if "fin" in g else ("top",)
    return dict(check.numbers(answers, ref), far={k: {str(t): check.far(g, k, t) for t in LADDER} for k in kinds})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
