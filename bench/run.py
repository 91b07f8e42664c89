#!/usr/bin/env python3
"""Run one cell of the benchmark once on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: loads the cell of ``BENCHMARK.json`` and the
files it names (``bench/cell.py``), refuses to run without as many CUDA
devices as the cell asks for, runs the traffic's driver
(``bench/drivers/<driver>.py``: set-up, the measured window, the
correctness check), reads each of the cell's metrics with its reader
(``bench/metrics/<metric>.py``: the end-to-end metrics with ``--trace
0``, the per-layer metrics with ``--trace 1``) and prints, last on
standard output, one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` ``breakdown``, and last ``checks``,
each number compared beside its limit (also the last lines on standard
error).  Exits non-zero, printing no result, without the card or if a
module of JAX or of the JAX package ``repro`` was loaded."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every build and kernel cache of the program inside the checkout, at
# fixed paths (the port's nvcc builds go to build/repro_torch_kernels/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import cell as cell_mod
    from bench import record
    from bench.costs import peaks
    import torch

    cell = cell_mod.load(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _say(f"{args.workload} needs {cell.chips} CUDA device(s); "
             f"torch sees {torch.cuda.device_count()}: no result")
        return 2
    if cell.limits is None:
        _say(f"bench/limits/{args.workload}.json is missing: no result")
        return 2
    torch.set_num_threads(1)
    name = torch.cuda.get_device_name(0)
    ctx = cell_mod.Context(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    run = cell_mod.module("drivers", cell.traffic["driver"]).run(ctx)
    run.rates = peaks.rates(name)
    if args.trace and run.trace is None:
        _say("the profiler saw no device operation: no result")
        return 3
    summary, line = report(cell, run, bool(args.trace), name)
    bad = record.forbidden_modules()
    if bad:
        _say(f"modules of JAX or the JAX package were loaded: {bad}: "
             f"no result")
        return 4
    print("\n".join(summary))
    for k, v in run.checks.items():
        _say(f"check {k}: {v['value']} (limit {v['limit']})")
    print(line, flush=True)
    return 0


def report(cell, run, trace: bool, device_name: str):
    """(summary lines, the result line) of a finished run: each of the
    cell's metrics for this kind of run read by its reader, left out where
    the reader finds nothing; the summary is the driver's own."""
    from bench import cell as cell_mod
    from bench import record
    metrics = {}
    for m in cell.metrics(trace):
        v = cell_mod.module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    breakdown = None
    if trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        breakdown = run.trace.breakdown()
    return run.summary(), record.result_line(run, metrics, device,
                                             breakdown)


if __name__ == "__main__":
    sys.exit(main())
