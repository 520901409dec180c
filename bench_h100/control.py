"""The readings that the limits of ``correct`` are set from, at a cell's own
size on the card: for each seed, one run's checked numbers of the program
against the plain reference and, for the first ``--control`` seeds, the
same numbers of the control (the reference computed in fp8 in the
program's place, ``reference/precision.py``), in one process.

    python3 bench_h100/control.py --workload t2v_camera.b2 --seeds 11 12 13 --control 3

Prints one JSON line per seed ({"seed", "program", "control"}) and, last,
each number's largest program reading and smallest control reading.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds also read the control")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
    sys.path.insert(0, ROOT)
    import torch

    from bench_h100 import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    lower, upper = {}, {}
    for n, seed in enumerate(args.seeds):
        t = time.perf_counter()
        out = harness.run(cell, seed, 0.0, False, "cuda:0", t, control=n < args.control)
        program = {k: v["value"] for k, v in out["checks"].items()}
        line = {"seed": seed, "program": program, "control": out.get("control"),
                "correct": out["correct"], "reference_s": out["reference_s"],
                "diagnostics": out["diagnostics"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        for k, v in program.items():
            lower[k] = max(lower.get(k, v), v) if v is not None else float("inf")
        for k, v in (out.get("control") or {}).items():
            upper[k] = min(upper.get(k, v), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
