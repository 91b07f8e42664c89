"""Multi-cloud carbon-aware serving: MAIZX routes request load to the
greenest region's replicas (paper §2: 'interconnect with hybrid approaches
such as multicloud').

Three serving replicas (ES/NL/DE) share the fleet QPS; each hour

* the *lifecycle* placement engine (``scheduler.place_events``) moves the
  primary batch replica to the greenest region — the same release-aware
  O(N + J·K) path that schedules million-node fleets — and the
  ``ServeEngine`` actually decodes a batch there;
* the *QPS router* (``core.router``) splits the hour's request count —
  a seeded diurnal stream from ``core.traffic`` — across all three
  replicas by marginal carbon (pue·CI) under an analytic M/M/c p99
  constraint, and is compared against the carbon-blind even split
  (``greenness=0``, the round-robin analog).

Serving energy is not a stand-in constant: the ``EnergyModel`` is
calibrated to the decode workload's roofline (``for_workload``), and the
per-batch / per-request kWh follow from the modeled step time.

Each batch belongs to a tenant; the example closes with a per-tenant gCO2
attribution report (the serving-side miniature of the fleet simulator's
``SimConfig.n_tenants`` accounting) — attributed emissions sum exactly to
the fleet total.

This is ``examples/multicloud_serve.py`` on the PyTorch port
(``repro_torch``).  The energy model is calibrated on the reference's TPU
v5e roofline (``hw="tpu-v5e"``, the default), so the modeled energy, the
placements, the router's split and the tenant report equal the JAX
example's; the model's parameters are drawn with ``torch.Generator``, so
the decoded tokens differ from it.

Run:  PYTHONPATH=src python examples/torch/multicloud_serve.py
[--device cpu] (the card unless ``--device`` names another device).
"""
import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS
from repro_torch.configs.base import SHAPES
from repro_torch.core import router, telemetry
from repro_torch.core.carbon import carbon_footprint
from repro_torch.core.energy import DEFAULT_ENERGY, workload_roofline
from repro_torch.core.fleet import Fleet
from repro_torch.core.scheduler import place_events
from repro_torch.core.traffic import TrafficConfig, plan_traffic
from repro_torch.models.model import ModelFlags, build_model
from repro_torch.serve.engine import ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None)
DEV = resolve_device(ap.parse_args().device)

REGIONS = ["ES", "NL", "DE"]
N_BATCHES = 12
BATCH_SLOTS = 4
MAX_NEW = 4

ci = {r: telemetry.hourly_ci(telemetry.REGIONS[r], hours=N_BATCHES + 1,
                             seed=5) for r in REGIONS}
pue = {r: telemetry.REGIONS[r].pue for r in REGIONS}

cfg = ARCHS["musicgen-medium"].reduced()
model = build_model(cfg, ModelFlags(attn_chunk=32))
params = model.init(0, device=DEV)
engines = {r: ServeEngine(model, params, max_seq=64, batch_slots=BATCH_SLOTS,
                          device=DEV)
           for r in REGIONS}

# serving energy from the calibrated workload model, not a constant:
# chip watts scale with the decode roofline's compute fraction, and the
# modeled step time prices one batch (BATCH_SLOTS slots x MAX_NEW steps)
em = DEFAULT_ENERGY.for_workload(cfg, SHAPES["decode_32k"],
                                 chips=BATCH_SLOTS)
rf = workload_roofline(cfg, SHAPES["decode_32k"], chips=BATCH_SLOTS)
SERVICE_S = rf.step_s * MAX_NEW                 # one request's busy time
ENERGY_PER_BATCH_KWH = em.job_energy_kwh(SERVICE_S, 1, BATCH_SLOTS)
REQ_KWH = em.req_kwh(SERVICE_S)

# the hour's request count: seeded diurnal stream (traced data, same
# generator the fleet simulator scans over)
MU = 1.0 / SERVICE_S                            # per-chip service rate
tplan = plan_traffic(TrafficConfig(req_rate=4e4, diurnal_amp=0.4,
                                   mu_per_chip=MU), N_BATCHES, 5)
# per-replica admissible rate from the M/M/c inversion at a 2x-service
# p99 SLO (each replica is a BATCH_SLOTS-server queue)
lam_cap = router.lambda_caps(BATCH_SLOTS, MU, 2.0 * SERVICE_S)
CAP = np.full(3, lam_cap[BATCH_SLOTS], np.int32)
SVC = np.zeros(3, np.int32)
JID = np.arange(3, dtype=np.int32)
W = np.ones(3, np.int32)


def f32(values) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32), device=DEV)


def region_fleet(hour: int, capacity: torch.Tensor) -> Fleet:
    """The 3 serving replicas as a schedulable Fleet at ``hour``, with the
    free slots carried over from the previous routing decisions."""
    ones = torch.ones((3,), dtype=torch.float32, device=DEV)
    return Fleet(
        ci_now=f32([ci[r][hour] for r in REGIONS]),
        ci_forecast=f32([ci[r][hour + 1] for r in REGIONS]),
        pue=f32([pue[r] for r in REGIONS]),
        power_kw=ones, capacity=capacity,
        healthy=torch.ones((3,), dtype=torch.bool, device=DEV),
        straggler_score=torch.zeros_like(ones), flops_per_j=ones,
        chips_total=torch.full((3,), BATCH_SLOTS, dtype=torch.int32,
                               device=DEV))


TENANTS = ["acme", "globex", "initech"]

rng = np.random.default_rng(0)
g_aware = g_rr = 0.0
rq_green = rq_even = 0.0
rq_n = 0
tenant_g = {t: 0.0 for t in TENANTS}
tenant_req = {t: 0 for t in TENANTS}
total_sweeps = 0
capacity = torch.full((3,), BATCH_SLOTS, dtype=torch.int32, device=DEV)
prev_node = -1
for b in range(N_BATCHES):
    # one lifecycle event stream per hour: the finished batch releases its
    # slots, then the new batch arrives — the simulator's epoch in miniature
    demands = torch.tensor([-BATCH_SLOTS if prev_node >= 0 else 0,
                            BATCH_SLOTS], dtype=torch.int32, device=DEV)
    targets = torch.tensor([prev_node, -1], dtype=torch.int32, device=DEV)
    pl = place_events(region_fleet(b, capacity), demands, targets,
                      engine="shortlist", shortlist=2)
    prev_node = int(pl.node[1])
    if prev_node < 0:   # -1 would wrap the capacity index + region label
        raise SystemExit(f"batch {b} unplaceable: no region has "
                         f"{BATCH_SLOTS} free slots")
    capacity = capacity.clone()
    if int(targets[0]) >= 0:
        capacity[int(targets[0])] += BATCH_SLOTS
    capacity[prev_node] -= BATCH_SLOTS
    aware = REGIONS[prev_node]
    total_sweeps += int(pl.n_sweeps)
    rr = REGIONS[b % 3]

    prompts = rng.integers(2, cfg.vocab, (BATCH_SLOTS, 8)).astype(np.int32)
    results = engines[aware].generate(prompts, max_new=MAX_NEW)
    if len(results) != BATCH_SLOTS:
        raise SystemExit(f"batch {b}: {len(results)} results")

    # the hour's request stream, split across ALL replicas by the QPS
    # router: marginal carbon (pue·ci) water-fill under the M/M/c p99
    # caps vs the carbon-blind even split (round-robin analog)
    carbon = np.asarray([pue[r] * ci[r][b] for r in REGIONS], np.float32)
    k = np.array([REQ_KWH * pue[r] * ci[r][b] for r in REGIONS])
    for gname, gval in (("green", 1.0), ("even", 0.0)):
        routed, _ = router.route_epoch(
            np, req_t=np.int32(tplan.req[b]), svc=SVC, jid=JID, weight=W,
            cap=CAP, carbon=carbon, n_svc=1, greenness=np.float32(gval))
        g = float((routed * k).sum())
        if gname == "green":
            rq_green += g
        else:
            rq_even += g
    rq_n += int(tplan.req[b])

    g_batch = float(carbon_footprint(ENERGY_PER_BATCH_KWH, pue[aware],
                                     ci[aware][b]))
    g_aware += g_batch
    tenant = TENANTS[int(rng.integers(len(TENANTS)))]
    tenant_g[tenant] += g_batch
    tenant_req[tenant] += BATCH_SLOTS
    g_rr += float(carbon_footprint(ENERGY_PER_BATCH_KWH, pue[rr],
                                   ci[rr][b]))
    print(f"batch {b:2d}: routed->{aware} (rr would use {rr}); "
          f"tenant {tenant}; qps {int(tplan.req[b])}; "
          f"tokens {results[0].tokens}")

n_req = N_BATCHES * BATCH_SLOTS
print(f"\nworkload-calibrated energy: {ENERGY_PER_BATCH_KWH * 1e3:.4f} "
      f"Wh/batch ({em.chip_power_w:.1f} W/chip at the decode roofline)")
print(f"carbon-aware: {g_aware / n_req:.2f} gCO2/request | "
      f"round-robin: {g_rr / n_req:.2f} gCO2/request | "
      f"saving {100 * (1 - g_aware / g_rr):.1f}% | "
      f"{total_sweeps} rank sweeps for {N_BATCHES} routing decisions")
print(f"QPS router ({rq_n} requests): carbon water-fill "
      f"{1e3 * rq_green / rq_n:.4f} mgCO2/request | even split "
      f"{1e3 * rq_even / rq_n:.4f} | "
      f"saving {100 * (1 - rq_green / rq_even):.1f}%")

# per-tenant attribution report: emissions are split by who ran on the
# routed replica, so the per-tenant column sums exactly to the fleet total
print("\ntenant      requests   gCO2     gCO2/req   share")
for t in TENANTS:
    share = 100.0 * tenant_g[t] / g_aware if g_aware else 0.0
    per = tenant_g[t] / tenant_req[t] if tenant_req[t] else 0.0
    print(f"{t:<11s} {tenant_req[t]:8d}   {tenant_g[t]:7.2f}  "
          f"{per:8.2f}   {share:5.1f}%")
print(f"{'total':<11s} {n_req:8d}   {g_aware:7.2f}")
if abs(sum(tenant_g.values()) - g_aware) >= 1e-9 * max(g_aware, 1.0):
    raise SystemExit("the tenant attribution does not sum to the total")
