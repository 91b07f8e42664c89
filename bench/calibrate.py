#!/usr/bin/env python3
"""Readings the limits of a cell's correctness check are set from, on the
card at the cell's own size, in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control 3] [--faults state_unchanged,half_batch,token_altered] \\
        [--fault-seeds 1]

For each seed, a run of the cell's driver with the shortest window (one
cycle of its traffic: as many requests as the check samples) and its
check against the float32 reference.  The first ``--control`` seeds run
as the control: the tokens the float8 reference puts first stand in for
the served ones and are judged by the cell's limits, so ``correct`` has
to come out false; the served tokens' own reading comes beside it.  Then
each of ``--faults`` (``bench/faults.py``) is planted under the timed
path on the first ``--fault-seeds`` seeds, and has to come out not
correct.  One JSON line a run; the benchmark's own runs do not run
this."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=1)
    args = ap.parse_args(argv)
    from bench import cell as cell_mod
    from bench import faults
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    c = cell_mod.load(args.workload, ROOT)
    driver = cell_mod.module("drivers", c.traffic["driver"])
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [(s, k < args.control, None) for k, s in enumerate(seeds)]
    runs += [(s, False, f) for f in filter(None, args.faults.split(","))
             for s in seeds[:args.fault_seeds]]
    for seed, control, fault in runs:
        t = time.perf_counter()
        ctx = cell_mod.Context(c, seed, 0.0, False, "cuda", t,
                               fault=faults.FAULTS[fault] if fault else None,
                               control=control)
        run = driver.run(ctx)
        print(json.dumps({
            "workload": c.name, "seed": seed,
            "mode": fault or ("control" if control else "program"),
            "correct": run.correct,
            "checks": {k: v["value"] for k, v in run.checks.items()},
            "failed": run.failed, "batches": len(run.batches),
            "memory_peak_bytes": run.memory_peak_bytes,
            "setup_s": run.setup_s,
            "seconds": time.perf_counter() - t}), flush=True)
        del run
    print(f"[total] {time.perf_counter() - T_START:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
