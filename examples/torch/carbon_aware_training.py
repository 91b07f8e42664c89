"""Carbon-aware training with live migration on the PyTorch port — paper
Scenario C applied to a training job (``examples/carbon_aware_training.py``
on ``repro_torch``).

Simulates a 2-pod fleet (Netherlands vs Germany) over several "hours" of
training:
- MAIZX ranks both pods from current + forecast CI (Eq. 1) and places the
  job;
- each hour the ranking is refreshed; when the advantage exceeds the
  migration-cost hysteresis, the job CHECKPOINTS, RESTORES on the other
  pod and CONTINUES with identical data order;
- emissions are accounted with Eq. 2 (CF = EC × PUE × CI) and compared to
  a static carbon-blind placement of the same job.

Run:  PYTHONPATH=src python examples/torch/carbon_aware_training.py
[--device cpu] (the card unless ``--device`` names another device).
Parameters are drawn with ``torch.Generator``, so the losses differ from
the JAX example's; the rankings, migrations and emissions do not depend on
them.
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import telemetry
from repro_torch.core.carbon import carbon_footprint
from repro_torch.core.forecast import fit_forecast
from repro_torch.core.ranking import RankWeights, maiz_ranking
from repro_torch.launch.train import train_loop
from repro_torch.train.fault_tolerance import MigrationPolicy

HOURS = 12
STEPS_PER_HOUR = 10
JOB_POWER_KW = 4.0      # reduced-model job stand-in (kW while training)


def main(device=None):
    dev = resolve_device(device)
    regions = ["NL", "DE"]   # close CI profiles -> rankings actually flip
    ci = {r: telemetry.hourly_ci(telemetry.REGIONS[r], hours=200, seed=13)
          for r in regions}
    pue = {r: telemetry.REGIONS[r].pue for r in regions}

    policy = MigrationPolicy(min_rank_advantage=0.05, migration_cost_steps=1,
                             cooldown_steps=1)
    ckpt_dir = tempfile.mkdtemp(prefix="maizx_migrate_")

    current = None
    migrations = 0
    emissions_aware = 0.0
    emissions_static = 0.0
    static_pod = None             # carbon-blind: stays on initial placement
    losses = []

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    try:
        for hour in range(HOURS):
            # --- MAIZX ranking from current + forecasted CI (Eq. 1) ---
            cfp, fcfp = [], []
            for r in regions:
                fc, _ = fit_forecast(f32(ci[r][:100 + hour]), 3)
                ec = JOB_POWER_KW * 1.0  # kWh over the next hour
                cfp.append(float(carbon_footprint(ec, pue[r],
                                                  ci[r][100 + hour])))
                fcfp.append(float(carbon_footprint(ec, pue[r],
                                                   float(fc.mean()))))
            scores = maiz_ranking(
                f32(cfp), f32(fcfp), torch.ones(2, device=dev),
                torch.zeros(2, device=dev),
                RankWeights(w1=0.7, w2=0.1, w3=0.1, w4=0.1)).cpu().numpy()

            if current is None:
                current = int(scores.argmin())
                static_pod = current  # the carbon-blind twin never moves
                print(f"[h{hour}] initial placement -> {regions[current]} "
                      f"(scores {np.round(scores, 3)})")
            else:
                d = policy.decide(hour, current, scores, HOURS - hour)
                if d.migrate:
                    migrations += 1
                    print(f"[h{hour}] MIGRATE {regions[current]} -> "
                          f"{regions[d.target]}: {d.reason} "
                          f"(checkpoint/restore, data order preserved)")
                    current = d.target

            # --- one 'hour' of training, resumable from the checkpoint ---
            run = train_loop("granite-3-2b",
                             steps=(hour + 1) * STEPS_PER_HOUR, batch=8,
                             seq=64, reduced=True, task="copy",
                             ckpt_dir=ckpt_dir, ckpt_every=STEPS_PER_HOUR,
                             log_every=10_000, device=dev)
            losses.extend(run.losses)

            # --- Eq. 2 accounting for this hour ---
            emissions_aware += carbon_footprint(
                JOB_POWER_KW, pue[regions[current]],
                ci[regions[current]][100 + hour])
            emissions_static += carbon_footprint(
                JOB_POWER_KW, pue[regions[static_pod]],
                ci[regions[static_pod]][100 + hour])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    red = 100 * (1 - emissions_aware / emissions_static)
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over {HOURS} hours, "
          f"{migrations} migrations")
    print(f"emissions: carbon-aware {emissions_aware / 1000:.2f} kg vs "
          f"static {emissions_static / 1000:.2f} kg  (-{red:.1f}%)")
    # 120 steps is the pre-induction plateau for the copy task: assert
    # stability, not convergence (migrations must not corrupt the state)
    if not np.mean(losses[-10:]) < np.mean(losses[:10]) + 0.15:
        raise SystemExit("training must remain stable across migrations")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
