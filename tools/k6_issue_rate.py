#!/usr/bin/env python3
"""What K6's per-head kernel costs at zamba2-1.2b's prefill (B 4, S 512,
D 4096, N 64) without its memory: the arithmetic of its steps
(``tools/k6_issue_rate.cu``) from registers, at the kernel's thread shape
(256 blocks of 128 threads, K 4 channels x M 8 states a thread, 512
steps), against the same state-steps' bound on the f32 pipes and as
instructions issued per scheduler and clock.  Needs one CUDA device; run
from the repository's root with ``python3 tools/k6_issue_rate.py``."""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_suffix(".cu")
BLOCKS, THREADS, STATES, STEPS = 256, 128, 32, 512


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k6_issue_rate: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs._smi("name,power.limit,clocks.max.sm"), flush=True)
    path, _ = _build.build_many([(SOURCE, _build.BASE_FLAGS)])[0]
    lib = ctypes.CDLL(str(path))
    lib.issue_rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.issue_rate_launch.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    mhz = float(cs._smi("clocks.max.sm").split()[0])
    out = torch.empty(BLOCKS * THREADS, device=dev)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    state_steps = BLOCKS * THREADS * STATES * STEPS
    rates = cs.card_rates(torch.cuda.get_device_name(0))
    for mode, what, per_state in ((0, "the step (update, y's product, "
                                      "tree, partial store)", 5),
                                  (1, "the state updates alone", 3)):
        def fn():
            rc = lib.issue_rate_launch(
                mode, out.data_ptr(), BLOCKS, STEPS,
                torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"issue_rate_launch: cudaError {rc}")
        ms = cs.time_ms(fn, flush)
        ops = per_state * state_steps
        # instructions per scheduler and clock: a warp issues one a clock,
        # four schedulers an SM, at the maximum SM clock
        ipc = ops / 32 / (props.multi_processor_count * 4) / (
            ms * 1e-3 * mhz * 1e6)
        print(f"{what}: {ms * 1e3:.1f} us for {state_steps:.3g} "
              f"state-steps x {per_state} f32 instructions; bound on the f32 "
              f"pipes {ops / rates[1] * 1e6:.2f} us; {ipc:.2f} instructions "
              f"per scheduler and clock at {mhz:.0f} MHz", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
