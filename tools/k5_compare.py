#!/usr/bin/env python3
"""K5 on two trees in one card: phases 0, 1, 10, 11 and 15 of one tree's
``chip_smoke.py`` (its own ``src``), so that a tree and its parent can be
run in turns in one call (``tools/k5_compare.sh``).  Phase 10 times K5
at the prefill shapes beside its bound, its plain version and SDPA;
phases 11 and 15 serve granite-3-2b, falcon-mamba-7b, moonshot,
zamba2 and qwen2-vl (16 layers) through the captured steps and print
the captured prefill.  Needs one CUDA device:
``python3 tools/k5_compare.py TREE``."""
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
os.chdir(tree)
sys.path.insert(0, os.path.join(tree, "src"))
sys.path.insert(0, tree)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

t0 = time.perf_counter()
dev = torch.device("cuda", 0)
name, sfu = cs.phase_card()
rates = cs.card_rates(name)
cs.phase_build()
flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
t1 = time.perf_counter()
cs.phase_model_kernels(dev, rates, sfu, flush)
cs.say(f"[cmp] phase 10 took {time.perf_counter() - t1:.1f} s")
del flush
record = {}
t1 = time.perf_counter()
cs.phase_serving(dev, record)
cs.say(f"[cmp] phase 11 took {time.perf_counter() - t1:.1f} s")
cs.phase_families(dev, record)
cs.say(f"[cmp] {tree}: {time.perf_counter() - t0:.1f} s")
