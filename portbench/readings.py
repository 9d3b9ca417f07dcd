"""Readings behind a cell's limits (not run by the benchmark's own runs).

    python3 portbench/readings.py --workload <cell> --seeds <n> [<n> ...] [--control]

For each seed: the cell's set-up, two passes of whole requests over every
query of the cell (``replay_off``: queries whose answer in the second pass
differs in any bit from the first's), and the kind's readings of the
answers against the reference (the sound runs' readings: the check's
numbers and what else the kind reads beside them, such as the graph
kind's ``_far_n`` counts at a ladder of thresholds). With ``--control``,
also the readings of the control: the reference itself in the program's
place, computed in the precision below the configuration's (for the graph
kind, float32 with TF32 matrix products). One JSON line a seed on standard
output.

Everything that belongs to the cell's kind comes from its module (the
harness's docstring lists what a kind brings).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name: str, seed: int, control: bool, device: str = "cuda", root: str = ROOT, base=None) -> dict:
    from portbench import harness

    spec = harness.load_cell(root, name, base or harness.HERE)
    kind = spec["kind"]
    r = harness.Run(spec, seed, device)
    r.svc.build()
    t0 = time.perf_counter()
    answers = [(ids, r.svc.serve(i)) for i, (ids, _) in enumerate(r.svc.batches)]
    serve_s = time.perf_counter() - t0
    again = [r.svc.serve(i) for i in range(len(r.svc.batches))]
    replay_off = sum(int(sum(not np.array_equal(a[k][j], b[k][j]) for k in a) > 0)
                     for (ids, a), b in zip(answers, again) for j in range(len(ids)))
    index = r.svc.describe()
    r.svc.free()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = kind.reference(r.inputs, spec["config"], spec["traffic"], device)
    out = {"seed": seed, "index": index, "serve_s": serve_s, "reference_s": time.perf_counter() - t0,
           "replay_off": replay_off, "sound": kind.readings(answers, ref)}
    if control:
        ctl = kind.reference(r.inputs, spec["config"], spec["traffic"], device, control=True)
        out["control"] = kind.readings(kind.control_answers(ctl), ref)
    return out


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
