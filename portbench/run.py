"""The benchmark of sgtd_tpu_torch on one NVIDIA H100, one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's inputs from the seed, builds the map index, warms every
request shape, answers requests for ``--seconds``, checks every answer
against the plain reference, and prints the result as one JSON line, last
on standard output (each compared number beside its limit last on
standard error). ``--trace 1`` gives the per-layer metrics in place of
the end-to-end ones. Runs from the root of a checkout; needs a card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    # One process, one compute thread: the load is the client's alone.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = next(w["chips"] for w in json.load(f)["workloads"] if w["name"] == args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[portbench] the cell needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2

    from portbench import harness

    out = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"[portbench] the process holds modules of JAX or the JAX package: {bad[:10]}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
