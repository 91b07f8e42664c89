#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path at fleet scale through the entry points a user
calls, holds each CUDA kernel against its plain torch twin, and checks the
outputs against the port's CPU path and the paper headline:

  0. card: name and power limit (nvidia-smi), library versions
  1. build: the rank kernels from ``src/repro_torch/kernels/csrc``
  2. K1 ``maiz_lohi`` / K2 ``maiz_topk`` vs their plain twins, bitwise, at
     N = 1,048,576 and a ragged N = 1,000,003; times (CUDA events, median
     of 25 after warm-up, L2 flushed) beside the byte/operation bound
  3. fleet ranking: ``ops.maiz_ranking_fused`` on a 1,048,576-node fleet
  4. placement: ``scheduler.place_jobs`` (256 jobs of 64 chips, shortlist
     64) on 65,536 and 1,048,576 nodes, kernel path == CPU path
  5. simulator: ``simulate_fleet`` on a 65,536-node lifecycle fleet, 24
     epochs, kernel / plain / full engines
  6. Scenario C of the paper experiment on the card: -85.68 % +- 0.05 pp

Launch counts are set to 0 just before each of phases 3-5 and read just
after.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero before that line.  Needs one CUDA device; run from
anywhere with ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
N_BIG, N_RAGGED = 1_048_576, 1_000_003
PLACE_NS = (65_536, N_BIG)      # placement fleets; the first also runs full
SIM_N = 65_536                  # simulator fleet
# device-memory rate (TB/s) and f32 peak outside the tensor cores
# (TFLOP/s) by card name, from NVIDIA's data sheets; first match wins
CARDS = (("H100 NVL", 3.9, 60.0), ("H100 PCIe", 2.0, 51.0),
         ("H100", 3.35, 67.0), ("H200", 4.8, 67.0))
REPLACES = {
    "maiz_lohi": ("src/repro/kernels/maizx_rank.py:175",
                  "src/repro_torch/kernels/csrc/maizx_rank.cu"),
    "maiz_topk": ("src/repro/kernels/maizx_rank.py:187",
                  "src/repro_torch/kernels/csrc/maizx_rank.cu"),
}


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def ulp_diff(a, b) -> int:
    """Max distance in f32 units in the last place (0 = bitwise equal)."""
    import torch
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype != torch.float32:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    ai = a.view(torch.int32).to(torch.int64)
    bi = b.view(torch.int32).to(torch.int64)
    # map sign-magnitude to a monotone integer line
    ai = torch.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = torch.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return int((ai - bi).abs().max()) if ai.numel() else 0


def abs_err(a, b) -> float:
    import torch
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def time_ms(fn, flush, reps=25, warm=3) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs, each after
    an L2 flush that also keeps the stream busy while the host enqueues."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.fill_(1.0)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def card_rates(name: str):
    for key, tbps, tflops in CARDS:
        if key in name:
            return tbps * 1e12, tflops * 1e12
    say(f"[0] no rate table entry for {name!r}: using H100 SXM's")
    return 3.35e12, 67e12


def device_busy(fn):
    """``fn()`` under ``torch.profiler``: (result, ms of device activity,
    ms of wall time of that same profiled run, the profiler's own cost
    included, so the busy share it gives is a lower bound).  The device ms
    is None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    except RuntimeError as e:          # no CUPTI in this sandbox
        say(f"profiler unavailable: {e}")
        return None, None, float("nan")
    wall = (time.perf_counter() - t0) * 1e3
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return out, (us / 1e3 if us > 0 else None), wall


def busy_note(dev_ms, wall_ms):
    if dev_ms is None:
        return "device busy: not measured (profiler saw no device time)"
    return (f"device busy {dev_ms:.2f} ms of {wall_ms:.1f} ms wall "
            f"({100 * dev_ms / wall_ms:.1f} %)")


def bound_ms(nbytes: float, ops: float, rates):
    bw, peak = rates
    tb, to = nbytes / bw * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card():
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    say(out.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    say(f"[0] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    return name


def phase_build():
    """Build the kernels; nvcc's -Xptxas -v report (registers, shared
    memory, spills per kernel) is printed before the timing line."""
    from repro_torch.kernels import maizx_rank as mr
    path, secs = mr.build(verbose=True)
    mr._lib()
    say(f"[1] built {path.name} in {secs:.2f} s")


def _streams(n, seed, dev, marginal, w_m):
    import torch
    g = np.random.default_rng(seed)
    s = [g.random(n) * 100, 1 + g.random(n), g.random(n) * 500,
         g.random(n) * 500, g.random(n), g.random(n)]
    s = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in s]
    kw = {}
    if marginal:
        ct = g.choice([64.0, 128.0, 256.0], n).astype(np.float32)
        cap = np.where(g.random(n) < 0.3, ct, np.floor(g.random(n) * ct))
        kw = dict(pk=torch.from_numpy((g.random(n) * 64).astype(
                      np.float32)).to(dev),
                  cap=torch.from_numpy(cap.astype(np.float32)).to(dev),
                  ct=torch.from_numpy(ct).to(dev),
                  en=torch.tensor([0.35, 0.65, 120.0, w_m], device=dev))
    return s, kw


def _pad(x, n_pad):
    import torch.nn.functional as F
    return F.pad(x, (0, n_pad - x.shape[0])).contiguous()


def phase_kernels(dev, rates, flush):
    """K1/K2 vs plain twins, bitwise, and their times."""
    import torch
    from repro_torch.kernels import maizx_rank as mr
    from repro_torch.kernels import ops

    w = torch.tensor([0.35, 0.25, 0.25, 0.15], device=dev)
    err = {"maiz_lohi": [0.0, 0], "maiz_topk": [0.0, 0]}
    times = {}

    def note(name, a, b):
        err[name][0] = max(err[name][0], abs_err(a, b))
        err[name][1] = max(err[name][1], ulp_diff(a, b))

    for n in (N_BIG, N_RAGGED):
        n_pad = n + (-n) % mr.TILE
        for variant, (marginal, w_m) in (("4term", (False, 0.0)),
                                         ("5term_wm0", (True, 0.0)),
                                         ("5term_wm0.3", (True, 0.3))):
            s, kw = _streams(n, n + len(variant), dev, marginal, w_m)
            sp = [_pad(x, n_pad) for x in s]
            kwp = {k: (v if k == "en" else _pad(v, n_pad))
                   for k, v in kw.items()}
            r = 5 if marginal else 4
            lo, hi = mr.maiz_lohi_tiles(*sp, n, **kwp)
            lo_p, hi_p = mr.maiz_lohi_plain(*sp, n, **kwp)
            note("maiz_lohi", lo, lo_p)
            note("maiz_lohi", hi, hi_p)
            lohi = torch.stack([lo.amin(0), hi.amax(0)], -1)
            for k in (1, mr.MAX_TILE_K):
                got = mr.maiz_topk(*sp, n, lohi, w, k=k, **kwp)
                want = mr.maiz_topk_plain(*sp, n, lohi, w, k=k, **kwp)
                for a, b in zip(got, want):
                    note("maiz_topk", a, b)
            # merged shortlist: card (kernels) vs the port's CPU path
            okw = {("chips_total" if k == "ct" else k): v
                   for k, v in kw.items()}
            for k in (1, 65):
                got = ops.maiz_ranking_topk(*s, w, k=k, **okw)
                want = ops.maiz_ranking_topk(
                    *[x.cpu() for x in s], w.cpu(), k=k,
                    **{a: b.cpu() for a, b in okw.items()})
                for a, b in zip(got, want):
                    check(ulp_diff(a, b) == 0,
                          f"merged top-{k} differs card vs CPU ({variant})")
            torch.cuda.synchronize()
            for k in (1, mr.MAX_TILE_K):
                key = (n, variant, k)
                times[("maiz_topk",) + key] = (
                    time_ms(lambda: mr.maiz_topk(*sp, n, lohi, w, k=k,
                                                 **kwp), flush),
                    time_ms(lambda: mr.maiz_topk_plain(*sp, n, lohi, w,
                                                       k=k, **kwp), flush,
                            reps=21),
                    _k2_bound(n_pad, r, k, rates))
            times[("maiz_lohi", n, variant, 0)] = (
                time_ms(lambda: mr.maiz_lohi_tiles(*sp, n, **kwp), flush),
                time_ms(lambda: mr.maiz_lohi_plain(*sp, n, **kwp), flush),
                _k1_bound(n_pad, r, rates))
    for key, (ms, plain, (b, by)) in sorted(times.items(), key=str):
        say(f"[2] {key[0]} N={key[1]} {key[2]}"
            + (f" k={key[3]}" if key[0] == "maiz_topk" else "")
            + f": kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
              f"bound {b * 1e3:.2f} us ({by})")
    for name, (ae, ulp) in err.items():
        say(f"[2] {name} vs plain: max abs err {ae}, max ulp diff {ulp}")
        check(ulp == 0, f"{name} is not bitwise equal to its plain twin")
    return err, times


def _k1_bound(n_pad, r, rates):
    streams = 6 if r == 4 else 9
    nbytes = n_pad * 4 * streams + 2 * (n_pad // 1024) * r * 4
    ops = n_pad * ((3 if r == 4 else 12) + 2 * r)   # terms + min/max
    return bound_ms(nbytes, ops, rates)


def _k2_bound(n_pad, r, k, rates):
    streams = 6 if r == 4 else 9
    nt = n_pad // 1024
    nbytes = n_pad * 4 * (streams + 1) + nt * k * 8 + r * 8 + 16
    # terms + 4 ops per normalized term + k rounds of one compare per node
    ops = n_pad * ((3 if r == 4 else 12) + 4 * r + 1 + k)
    return bound_ms(nbytes, ops, rates)


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; returns (result, {kernel: launches})."""
    import torch
    from repro_torch.kernels import maizx_rank as mr
    torch.cuda.synchronize()
    mr.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {"maiz_lohi": mr.maiz_lohi.launches,
                 "maiz_topk": mr.maiz_topk.launches}


def phase_ranking(dev):
    import torch
    from repro_torch.core.fleet import synthetic_fleet
    from repro_torch.core.ranking import RankWeights
    from repro_torch.kernels import ops
    fleet = synthetic_fleet(N_BIG, seed=1, device=dev)
    w = RankWeights()
    args = (fleet.effective_power_kw(), fleet.pue, fleet.ci_now,
            fleet.ci_forecast, fleet.flops_per_j, fleet.sched_term,
            w.as_array(dev))
    (scores, best_s, best_n), n = counted(
        lambda: ops.maiz_ranking_fused(*args))
    want = fleet.rank(weights=w)
    check(scores.shape == (N_BIG,) and bool(torch.isfinite(scores).all()),
          "fused scores are not finite")
    check(abs_err(scores, want) <= 1e-5, "fused scores differ from Eq. 1")
    check(int(best_n) == int(torch.argmin(want)), "fused argmin differs")
    check(n["maiz_lohi"] > 0 and n["maiz_topk"] > 0,
          f"fused ranking launched no kernel: {n}")
    say(f"[3] fused ranking N={N_BIG}: best node {int(best_n)} score "
        f"{float(best_s):.6f}, ulp vs Eq. 1 {ulp_diff(scores, want)}, "
        f"launches {n}")
    return n


def phase_placement(dev):
    import torch
    from repro_torch.core.fleet import synthetic_fleet
    from repro_torch.core.scheduler import place_jobs
    J, d, K = 256, 64, 64
    demands = np.full(J, d)
    total = {"maiz_lohi": 0, "maiz_topk": 0}
    for n in PLACE_NS:
        fg = synthetic_fleet(n, seed=1, device=dev)

        def kernel_path():
            return place_jobs(fg, demands, engine="shortlist", shortlist=K,
                              use_kernel=True)

        place_jobs(fg, demands[:8], engine="shortlist", shortlist=K,
                   use_kernel=True)                     # warm-up
        t0 = time.perf_counter()
        a, cnt = counted(kernel_path)
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in cnt.items():
            total[k] += v
        _, dev_ms, prof_ms = device_busy(kernel_path)
        t0 = time.perf_counter()
        b = place_jobs(synthetic_fleet(n, seed=1, device="cpu"), demands,
                       engine="shortlist", shortlist=K, use_kernel=True)
        ms_cpu = (time.perf_counter() - t0) * 1e3
        check(torch.equal(a.node.cpu(), b.node), f"n={n}: nodes differ "
              "between the card's kernel path and the CPU path")
        check(a.n_sweeps == b.n_sweeps, f"n={n}: sweeps differ")
        check(cnt["maiz_topk"] == a.n_sweeps > 0,
              f"n={n}: K2 launches {cnt} != sweeps {a.n_sweeps}")
        check(int((a.node >= 0).sum()) == J, f"n={n}: unplaced jobs")
        line = (f"[4] place_jobs n={n}: kernel path {a.n_sweeps} sweeps "
                f"{ms:.1f} ms (K2 launches {cnt['maiz_topk']}; "
                f"{busy_note(dev_ms, prof_ms)}), CPU path {ms_cpu:.1f} ms, "
                "equal")
        if n == PLACE_NS[0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = place_jobs(fg, demands, engine="shortlist", shortlist=K)
            torch.cuda.synchronize()
            ms_c = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            f = place_jobs(fg, demands, engine="full")
            torch.cuda.synchronize()
            ms_f = (time.perf_counter() - t0) * 1e3
            check(torch.equal(c.node, f.node) and torch.equal(a.node, c.node),
                  "shortlist (plain sweep) != full re-rank on the card")
            line += (f"; plain-sweep shortlist {c.n_sweeps} sweeps "
                     f"{ms_c:.1f} ms, full {f.n_sweeps} sweeps {ms_f:.1f} ms,"
                     " equal")
        say(line)
    return total


def phase_simulator(dev):
    from repro_torch.core import simulator as S
    from repro_torch.core.ranking import RankWeights
    n = SIM_N
    cfg = S.SimConfig(epochs=24, seed=1, arrival_rate=12.0,
                      mean_duration_h=12.0, migration_budget=2,
                      deferrable_frac=0.1, shortlist=64)
    fleet, traces, ridx = S.synthetic_lifecycle_fleet(n, cfg, device=dev)
    jobs = S.generate_jobs(cfg)
    runs = {}
    variants = (("plain", cfg),
                ("kernel", dataclasses.replace(cfg, use_kernel=True)),
                ("full", dataclasses.replace(cfg, engine="full")))
    for name, c in variants:       # warm-up: first-call library set-up
        S.simulate_fleet(fleet, traces, ridx,
                         dataclasses.replace(c, epochs=2), jobs=jobs)
    for name, c in variants:
        t0 = time.perf_counter()
        r, cnt = counted(lambda: S.simulate_fleet(fleet, traces, ridx, c,
                                                  jobs=jobs))
        runs[name] = (r, cnt, (time.perf_counter() - t0) * 1e3 / cfg.epochs)
    _, dev_ms, prof_ms = device_busy(lambda: S.simulate_fleet(
        fleet, traces, ridx, dataclasses.replace(variants[1][1], epochs=4),
        jobs=jobs))
    (rk, ck, msk), (rp, _, msp), (rf, _, msf) = (runs["kernel"],
                                                 runs["plain"], runs["full"])
    check(np.array_equal(rp.node_log, rf.node_log)
          and rp.emissions_g == rf.emissions_g,
          "simulator: shortlist and full engines disagree on the card")
    spj = rk.rank_sweeps / max(rk.arrivals_placed, 1)
    check(ck["maiz_topk"] > 0 and spj < 0.2,
          f"simulator kernel run: launches {ck}, sweeps/job {spj:.3f}")
    check(math.isfinite(rk.emissions_g) and rk.emissions_series.shape ==
          (cfg.epochs,), "simulator emissions malformed")
    moved = int((rk.node_log != rp.node_log).sum())
    say(f"[5] simulate_fleet n={n} epochs={cfg.epochs} jobs={jobs.n}: "
        f"kernel {msk:.1f} ms/epoch ({rk.rank_sweeps} sweeps, "
        f"{spj:.3f} sweeps/job, K2 launches {ck['maiz_topk']}; 4 epochs "
        f"{busy_note(dev_ms, prof_ms)}), plain "
        f"{msp:.1f} ms/epoch ({rp.rank_sweeps} sweeps), full {msf:.1f} "
        f"ms/epoch ({rf.rank_sweeps} sweeps); shortlist == full; kernel vs "
        f"plain: {moved} jobs placed differently, emissions "
        f"{rk.emissions_g:.6e} vs {rp.emissions_g:.6e} g")
    # a small stream, w2 = 0: the card's trajectory == the CPU path's
    small = S.SimConfig(epochs=24, seed=11, arrival_rate=8.0,
                        mean_duration_h=8.0, shortlist=32, history_h=48,
                        horizon_h=12, migration_budget=2,
                        deferrable_frac=0.2, outage=(0, 12, 6),
                        weights=RankWeights(0.35, 0.0, 0.5, 0.15),
                        use_kernel=True)
    out = []
    for d in (dev, "cpu"):
        f, t, ri = S.synthetic_lifecycle_fleet(192, small,
                                               chips_per_node=128, device=d)
        out.append(S.simulate_fleet(f, t, ri, small))
    check(np.array_equal(out[0].node_log, out[1].node_log)
          and out[0].emissions_g == out[1].emissions_g,
          "simulator: card and CPU paths disagree on the small stream")
    say(f"[5] n=192 stream: card == CPU path ({out[0].rank_sweeps} sweeps, "
        f"{out[0].migrations} migrations, {out[0].evictions} evictions)")
    return ck


def phase_scenario_c(dev):
    from repro_torch.core.scenarios import run_paper_experiment
    t0 = time.perf_counter()
    r = run_paper_experiment(device=dev)
    secs = time.perf_counter() - t0
    c = r.reduction_pct["C"]
    check(abs(c - 85.68) <= 0.05, f"Scenario C {c:.4f} % off the headline")
    cpu = run_paper_experiment(device="cpu")
    for k, v in cpu.emissions_kg.items():
        check(abs(r.emissions_kg[k] / v - 1) <= 1e-5,
              f"scenario {k}: card {r.emissions_kg[k]} vs CPU {v} kg")
    say(f"[6] Scenario C on the card: -{c:.4f} % CO2 ({secs:.1f} s, 8760 "
        f"epochs); kg " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    r.emissions_kg.items()))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = phase_card()
    rates = card_rates(name)
    phase_build()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    err, times = phase_kernels(dev, rates, flush)
    del flush
    launches = {"maiz_lohi": 0, "maiz_topk": 0}
    n3 = phase_ranking(dev)
    n4 = phase_placement(dev)
    n5 = phase_simulator(dev)
    for part in (n3, n4, n5):
        for k, v in part.items():
            launches[k] += v
    phase_scenario_c(dev)
    for k in launches:
        check(launches[k] > 0, f"{k} never launched on the main path")
    # the main path's shapes: K1 as the fused ranking runs it, K2 as the
    # placement engine's sweep runs it (k = shortlist + 1 capped at 64)
    main_key = {"maiz_lohi": ("maiz_lohi", N_BIG, "4term", 0),
                "maiz_topk": ("maiz_topk", N_BIG, "4term", 64)}
    kernels = []
    for k, key in main_key.items():
        ms, plain, (b, by) = times[key]
        kernels.append({
            "name": k, "route": "cuda", "source": REPLACES[k][1],
            "replaces": REPLACES[k][0], "launches": launches[k],
            "max_abs_err": err[k][0], "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None})
    say(f"[7] total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
