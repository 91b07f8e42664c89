"""Green-window planning + SLO deferral, demonstrated end to end.

Two scenes exercise the carbon policy subsystem (``repro_torch.core.policy``)
through the scan-compiled simulator (seconds per run, shared compilation
via ``pad_plan``):

1. **Proactive migration** (multi-region fleet, one simulated year): the
   forecast-driven green-window planner vs the reactive migration policy
   on the same arrival stream and per-epoch budget — the planner reads
   the precomputed forecast tensor, skips moves into transient dips, and
   batches the survivors into forecast-green windows: an order of
   magnitude fewer migrations for equal-or-lower CO2.

2. **SLO deferral** (single-region fleet, one week): deferrable batch
   jobs ride the deadline/value priority queue into forecast-green hours.
   Single-region is the setting where temporal flexibility is the only
   carbon lever — in multi-region fleets the placement engine's *spatial*
   arbitrage dominates (see EXPERIMENTS.md §Policy).  An hour-of-day
   histogram shows starts piling into the early-morning CI dip the
   business-hours arrival process never favors on its own, and the
   carbon/latency totals trace the Pareto tradeoff.

This is ``examples/green_window_planner.py`` on the PyTorch port: the
same scenes through its scanned driver, whose epoch loop runs in Python
over device tensors, so scene 1 takes minutes where the JAX example's
compiled scan takes ~15 s.

Run:  PYTHONPATH=src python examples/torch/green_window_planner.py
[--device cpu] (the card unless ``--device`` names another device).
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.core import policy as P
from repro_torch.core.simulator import (SimConfig, generate_jobs,
                                        simulate_fleet_scan,
                                        synthetic_lifecycle_fleet)

DEVICE = None       # set from --device


def run(cfg, n, region=None, chips_per_node=128):
    fleet, traces, ridx = synthetic_lifecycle_fleet(
        n, cfg, chips_per_node=chips_per_node, region=region,
        device=DEVICE)
    jobs = generate_jobs(cfg)
    return simulate_fleet_scan(fleet, traces, ridx, cfg, jobs=jobs,
                               pad_plan=True), jobs, traces


def scene_migration(epochs: int = 8760) -> None:
    """Scene 1 over ``epochs`` hourly epochs (the script runs the year;
    its CPU test a month)."""
    span = ("one simulated year" if epochs == 8760
            else f"{epochs} simulated hours")
    print("== scene 1: proactive migration, N=4096 multi-region fleet, "
          f"{span} (the scanned core) ==\n")
    base = SimConfig(epochs=epochs, seed=1, arrival_rate=12.0,
                     mean_duration_h=12.0, migration_budget=2,
                     deferrable_frac=0.1, shortlist=64)
    rows = {}
    for name, pcfg in (("reactive", P.REACTIVE),
                       ("green_window", P.green_window())):
        r, _, _ = run(dataclasses.replace(base, policy=pcfg), 4096,
                      chips_per_node=256)
        rows[name] = r
        print(f"  {name:13s} CO2={r.emissions_g / 1e3:11.1f} kg   "
              f"migrations={r.migrations:4d}   "
              f"checkpoint overhead={r.migration_cost_g:8.1f} g")
    re, gw = rows["reactive"], rows["green_window"]
    print(f"\n  planner: {100 * (1 - gw.emissions_g / re.emissions_g):+.3f}% "
          f"CO2 at {gw.migrations} vs {re.migrations} migrations — moves "
          f"wait for forecast-green windows instead of chasing ci_now.\n")


def scene_deferral() -> None:
    print("== scene 2: SLO deferral, N=64 single-region fleet, one week, "
          "60% deferrable batch ==\n")
    base = SimConfig(epochs=168, seed=7, arrival_rate=16.0,
                     mean_duration_h=3.0, deferrable_frac=0.6,
                     defer_max_h=24, shortlist=32)
    grid = (("no_deferral", P.slo_deferral(0.0, deadline_hi=24)),
            ("slo value_w=2", P.slo_deferral(0.95, value_weight=2.0,
                                             deadline_hi=24)),
            ("slo value_w=0", P.slo_deferral(0.95, value_weight=0.0,
                                             deadline_hi=24)))
    results = {}
    for name, pcfg in grid:
        r, jobs, traces = run(dataclasses.replace(base, policy=pcfg), 64,
                              region=0)
        results[name] = (r, jobs, traces)
    base_e = results["no_deferral"][0].emissions_g
    print(f"  {'policy':14s} {'CO2 (kg)':>9s} {'saving':>8s} "
          f"{'avg delay':>9s} {'misses':>6s}")
    for name, (r, jobs, _) in results.items():
        started = int((r.start_epoch >= 0).sum())
        print(f"  {name:14s} {r.emissions_g / 1e3:9.1f} "
              f"{100 * (1 - r.emissions_g / base_e):+7.2f}% "
              f"{r.defer_delay_h / max(started, 1):8.2f}h "
              f"{r.deadline_misses:6d}")

    r, jobs, traces = results["slo value_w=0"]
    r0, jobs0, _ = results["no_deferral"]
    cfg_hist = base.history_h
    ci_by_hour = traces[0, cfg_hist:cfg_hist + 168].reshape(-1, 24).mean(0)

    def hour_hist(res, js):
        m = (res.start_epoch >= 0) & np.asarray(js.deferrable)
        return np.bincount((res.start_epoch[m] % 24).astype(int),
                           minlength=24).astype(float)

    h_no, h_slo = hour_hist(r0, jobs0), hour_hist(r, jobs)
    top = max(h_no.max(), h_slo.max())
    print("\n  hour  mean CI | batch starts: no deferral | SLO deferral")
    for h in range(24):
        tag = "  <- green window" if ci_by_hour[h] <= np.percentile(
            ci_by_hour, 25) else ""
        print(f"  {h:02d}:00 {ci_by_hour[h]:7.0f} | "
              f"{'·' * int(round(16 * h_no[h] / top)):<16s} | "
              f"{'#' * int(round(16 * h_slo[h] / top)):<16s}{tag}")
    moved = (r.start_epoch - np.asarray(jobs.arrive))[r.start_epoch >= 0]
    print(f"\n  {int((moved > 0).sum())} batch jobs shifted by up to "
          f"{int(moved.max(initial=0))}h into forecast-green hours.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    DEVICE = ap.parse_args().device
    scene_migration()
    scene_deferral()
