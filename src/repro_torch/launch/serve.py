"""Serving launcher: MAIZX-placed batched inference (twin of
``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch granite-3-2b --requests 8
--max-new 16 [--full] [--device cpu]`` ranks a 64-pod fleet (Eq. 1),
places the replica on the best pod with ``place_jobs``, serves the
requests in batches of ``--slots`` with the slot engine (its prefill and
decode captured as CUDA graphs on the card, eager on the CPU) and reports
tok/s and gCO2/request (Eq. 2).  Runs on the card unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.carbon import carbon_footprint
from repro_torch.core.fleet import synthetic_fleet
from repro_torch.core.scheduler import place_jobs
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine


def serve(cfg: ArchConfig, *, requests: int = 8, prompt_len: int = 16,
          max_new: int = 16, slots: int = 4, temperature: float = 0.0,
          device: DeviceLike = None, params: Optional[Dict] = None,
          log=print) -> Dict[str, Any]:
    """Place the replica, serve ``requests`` prompts of ``prompt_len``
    random tokens (seed 0) and account their carbon.  ``params`` defaults
    to ``build_model(cfg).init(0)`` on ``device``.  Returns the pod, the
    results, tokens, wall seconds, tok/s, gCO2/request and the engine's
    ``timings`` (prefill / decode seconds and counts, its captures, their
    seconds, the warm-up prefills and the graph pool's bytes)."""
    dev = resolve_device(device)
    fleet = synthetic_fleet(64, seed=0, device=dev)
    pl = place_jobs(fleet, torch.tensor([slots], dtype=torch.int32,
                                        device=dev))
    pod = int(pl.node[0])
    ci, pue = float(fleet.ci_now[pod]), float(fleet.pue[pod])
    log(f"[maizx] serving replica placed on pod {pod} "
        f"(CI {ci:.0f} gCO2/kWh, PUE {pue:.2f})")

    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    engine = ServeEngine(model, params, max_seq=prompt_len + max_new + 8,
                         batch_slots=slots, temperature=temperature,
                         device=dev)

    rng = np.random.default_rng(0)
    done = toks = 0
    results = []
    t0 = time.perf_counter()
    while done < requests:
        n = min(slots, requests - done)
        prompts = rng.integers(2, cfg.vocab, (slots, prompt_len))
        for r in engine.generate(prompts, max_new=max_new)[:n]:
            log(f"req {done}: {r.tokens[:12]}"
                f"{'...' if len(r.tokens) > 12 else ''}")
            results.append(r)
            done += 1
            toks += len(r.tokens)
    wall = time.perf_counter() - t0

    # Eq. 2 accounting with the placed pod's telemetry
    energy_kwh = float(fleet.power_kw[pod]) * (wall / 3600.0) * 0.05
    g = float(carbon_footprint(energy_kwh, pue, ci))
    out = dict(pod=pod, results=results, requests=done, tokens=toks,
               wall_s=wall, tok_per_s=toks / wall,
               g_per_request=g / max(done, 1), **engine.timings)
    log(f"\n{done} requests, {toks} tokens in {wall:.1f}s "
        f"({toks / wall:.1f} tok/s); ~{g / max(done, 1):.3f} gCO2/request "
        f"on pod {pod}; {engine.timings['captures']} step captures "
        f"({engine.timings['capture_s']:.1f}s)")
    return out


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true",
                    help="full config; default reduced")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    return serve(cfg, requests=args.requests, prompt_len=args.prompt_len,
                 max_new=args.max_new, slots=args.slots,
                 temperature=args.temperature,
                 device=device if device is not None else args.device)


if __name__ == "__main__":
    main()
