#!/usr/bin/env python3
"""How far the JAX reference's own train step drifts from itself over 8
AdamW steps when only its rounding changes: the jitted step against the
same step run op by op (``jax.disable_jit``), from one state on the same
batches.  The setting is ``tests/test_torch_train_families.py``'s 8-step
case (reduced zamba2-1.2b through the chunked scan, f32 parameters with a
seeded head, the copy task at batch 4 x 28, seed 5); per step it prints
the loss's relative gap and the largest per-leaf gap of the parameters
relative to the leaf's L2 norm, the measure that test bars at 1e-4.  CPU
only, about three minutes; run from the repository's root with
``JAX_PLATFORMS=cpu python3 tools/ref_step_jitter.py``."""
from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import ARCHS
    from repro.data.pipeline import DataConfig, PipelineState, host_batch
    from repro.models.model import ModelFlags, build_model
    from repro.train.optimizer import AdamWConfig
    from repro.train.train_step import TrainState, make_train_step
    cfg = ARCHS["zamba2-1.2b"].reduced()
    model = build_model(cfg, ModelFlags(attn_chunk=16, ssm_chunk=8,
                                        ssm_algo="scan"))
    params = model.init(jax.random.key(0))
    head = np.random.default_rng(1).standard_normal(
        (cfg.d_model, cfg.vocab)) / math.sqrt(cfg.d_model)
    # the test's head: drawn in float64, stored in the init's bf16, then
    # every leaf cast to f32
    params["lm_head"] = jnp.asarray(head, params["lm_head"].dtype)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    step = make_train_step(model, AdamWConfig(lr_peak=3e-3, warmup_steps=2,
                                              total_steps=8))
    jitted = jax.jit(step)
    a = b = TrainState.create(params)
    data, ps = DataConfig(cfg, 4, 28, seed=5), PipelineState(5, 0)
    for i in range(8):
        ps, batch = host_batch(data, ps)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        a, ma = jitted(a, batch)
        with jax.disable_jit():
            b, mb = step(b, batch)
        gap = max(float(np.linalg.norm(np.asarray(x) - np.asarray(y))
                        / np.linalg.norm(np.asarray(x)))
                  for x, y in zip(jax.tree.leaves(a.params),
                                  jax.tree.leaves(b.params))
                  if np.linalg.norm(np.asarray(x)) > 0)
        print(f"step {i}: loss rel gap "
              f"{abs(float(ma['loss']) / float(mb['loss']) - 1):.3g}, "
              f"parameters' largest gap {gap:.4g} x the leaf's L2 norm",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
