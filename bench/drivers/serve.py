"""Offline batched serving through ``repro_torch.serve.engine.ServeEngine``:
one client in a closed loop submits batches of ``slots`` prompts back to
back, each one ``generate`` call (greedy, ``new_tokens`` a request).  A
batch shares one prompt length; the lengths come in cycles, each cycle
the traffic's ``prompt_lengths`` in an order drawn from the seed, and the
prompts are token ids drawn from the seed.

Set-up draws the weights (``bench.weights``), builds the engine with
``max_seq`` = the longest prompt + new tokens + 8, and runs one two-token
``generate`` at each prompt length, which captures that length's prefill
and decode graphs (and, on the first run in a checkout, builds the
kernels).  The window then admits batches for ``seconds`` and on to the
end of the cycle it is in, and closes when the last batch it admitted
returns (``ServeRun.t1``): it holds whole cycles of whole batches, so
every seed's window holds the same mix.  The engine instance's
``prefill`` and ``decode`` are wrapped to time each step (a decode's
entry follows the previous step's token read); the harness raises if the
engine stops calling them.  A traced run then profiles
``trace.batches`` more batches after the window, so the window itself
runs unprofiled.

The check (``bench.check``) then frees the engine and runs the family's
reference over ``check.batches_per_length`` batches of each prompt
length, ``check.row_blocks`` rows of each (one from each run of slots).
With ``ctx.control`` the tokens the float8 reference puts first at the
same positions stand in for the served ones, and are judged by the same
limits."""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import cell as cell_mod
from bench import check, weights
from bench import trace as trace_mod
from bench.record import Run

# SeedSequence streams of one seed
_ORDER, _TOKENS, _WARM, _SAMPLE = range(4)


def _seed(seed: int) -> int:
    return seed % (1 << 64)


def _ms(seconds) -> str:
    return " ".join(f"{x * 1e3:.1f}" for x in seconds)


@dataclasses.dataclass
class Batch:
    """One ``generate`` call: ``submit`` before it, ``done`` after it;
    ``decode_at`` the entries of its decode steps (entry j + 1 follows step
    j's token read), so the prefill ends at the first entry and decode
    step j at entry j + 1 (the last at ``done``)."""
    index: int
    prompt_len: int
    rows: int
    submit: float
    done: float = 0.0
    prefill_at: Optional[float] = None
    decode_at: List[float] = dataclasses.field(default_factory=list)
    tokens: Optional[List[List[int]]] = None

    @property
    def prefill_done(self) -> float:
        return self.decode_at[0] if self.decode_at else self.done

    @property
    def decode_done(self) -> List[float]:
        return self.decode_at[1:] + [self.done] if self.decode_at else []


@dataclasses.dataclass
class ServeRun(Run):
    """A serve run's window: the batches from the first submit (``t0``)
    to the last admitted batch's return (``t1``), the engine's timings
    at both ends, and the batches the traced run profiled after it."""
    costs: Optional[ModuleType] = None      # bench/costs/<family>.py
    t0: float = 0.0
    t1: float = 0.0
    batches: List[Batch] = dataclasses.field(default_factory=list)
    engine_before: Dict[str, float] = dataclasses.field(default_factory=dict)
    engine_after: Dict[str, float] = dataclasses.field(default_factory=dict)
    capture_s: float = 0.0
    traced: List[Batch] = dataclasses.field(default_factory=list)
    full_gcs: int = 0               # full collections in the window

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def engine_delta(self, key: str) -> float:
        """The engine's timing ``key`` over the window."""
        return self.engine_after[key] - self.engine_before[key]

    def work_in_window(self) -> tuple:
        """(tokens, FLOPs) of the window's batches: each prefill's prompt
        tokens and first sampled token, each decode step's tokens."""
        tokens = flops = 0
        for b in self.batches:
            steps = len(b.decode_done)
            tokens += b.rows * (b.prompt_len + 1 + steps)
            flops += self.costs.prefill_flops(self.cfg, b.rows, b.prompt_len)
            flops += sum(self.costs.decode_flops(self.cfg, b.rows,
                                                 b.prompt_len + j)
                         for j in range(steps))
        return tokens, flops

    def latencies_s(self) -> List[float]:
        """Completion minus submission of every request of the window."""
        return [b.done - b.submit for b in self.batches
                for _ in range(b.rows)]

    def summary(self) -> List[str]:
        lat = self.latencies_s()
        out = [f"window {self.window_s} s, batches {len(self.batches)}, "
               f"requests attempted {self.attempted}, completed "
               f"{self.attempted}, failed {self.failed}; tokens "
               f"{self.work_in_window()[0]}; set-up {self.setup_s} s; "
               f"full collections in the window {self.full_gcs}",
               f"latency median {statistics.median(lat) * 1e3} ms over "
               f"{len(lat)} requests"]
        # each length's batches in submit order: the whole call, its
        # prefill (call to the first decode's entry) and its decode steps
        for P in sorted({b.prompt_len for b in self.batches}):
            bs = [b for b in self.batches if b.prompt_len == P]
            out += [f"prompt {P}: {len(bs)} batches; latency ms "
                    f"{_ms(b.done - b.submit for b in bs)}",
                    f"prompt {P}: prefill ms "
                    f"{_ms(b.prefill_done - b.submit for b in bs)}",
                    f"prompt {P}: decode ms "
                    f"{_ms(b.done - b.prefill_done for b in bs)}"]
        return out


class Plan:
    """The batches of one seed: batch i's prompt length and (slots, P)
    token ids, the same whatever the speed of the run."""

    def __init__(self, seed: int, lengths: List[int], slots: int,
                 vocab: int):
        self.seed, self.lengths = _seed(seed), list(lengths)
        self.slots, self.vocab = slots, vocab
        self._prompts: Dict[int, np.ndarray] = {}

    def length(self, i: int) -> int:
        cyc, k = divmod(i, len(self.lengths))
        rng = np.random.default_rng([self.seed, _ORDER, cyc])
        return int(rng.permutation(self.lengths)[k])

    def prompts(self, i: int) -> np.ndarray:
        if i not in self._prompts:
            rng = np.random.default_rng([self.seed, _TOKENS, i])
            self._prompts[i] = rng.integers(
                0, self.vocab, (self.slots, self.length(i)), dtype=np.int64)
        return self._prompts[i]

    def warm(self, P: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, _WARM, P])
        return rng.integers(0, self.vocab, (self.slots, P), dtype=np.int64)


class _Steps:
    """The engine's ``prefill`` / ``decode``, wrapped on the instance to
    time the current batch's steps."""

    def __init__(self, engine, fault):
        self.batch: Optional[Batch] = None
        self.prefills = self.decodes = 0
        wrap = fault or (lambda kind, fn: fn)
        prefill = wrap("prefill", engine.prefill)
        decode = wrap("decode", engine.decode)

        def timed_prefill(batch):
            self.prefills += 1
            if self.batch is not None:
                self.batch.prefill_at = time.perf_counter()
            return prefill(batch)

        def timed_decode(caches, batch):
            self.decodes += 1
            if self.batch is not None:
                self.batch.decode_at.append(time.perf_counter())
            return decode(caches, batch)

        engine.prefill, engine.decode = timed_prefill, timed_decode

    def generate(self, engine, prompts: np.ndarray, new: int):
        p0, d0 = self.prefills, self.decodes
        out = engine.generate(prompts, new)
        if (self.prefills - p0, self.decodes - d0) != (1, new - 1):
            raise RuntimeError(
                f"generate made {self.prefills - p0} prefill and "
                f"{self.decodes - d0} decode calls for {new} tokens, not 1 "
                f"and {new - 1}: the engine no longer goes through its "
                f"public prefill / decode, which the harness times")
        return out

    def batch_of(self, engine, plan: Plan, i: int, new: int) -> Batch:
        """Batch ``i`` of the plan, served and timed."""
        b = Batch(i, plan.length(i), plan.slots, submit=time.perf_counter())
        self.batch = b
        out = self.generate(engine, plan.prompts(i), new)
        b.done = time.perf_counter()
        b.tokens = [r.tokens for r in out]
        self.batch = None
        return b


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(ctx: cell_mod.Context) -> ServeRun:
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine

    c, tr = ctx.cell, ctx.cell.traffic
    if (tr.get("loop", "closed"), tr.get("clients", 1)) != ("closed", 1):
        raise ValueError("the serve driver runs one client in a closed loop")
    cfg, dev = c.cfg, torch.device(ctx.device)
    arch = ctx.arch or get_config(cfg["arch"])
    cell_mod.check_arch(cfg, arch)
    model = build_model(arch)
    params = weights.draw(model.template(), ctx.seed, dev)
    if params["embed"].dtype != getattr(torch, cfg["dtype"]):
        raise ValueError(f"the port serves {params['embed'].dtype}, the "
                         f"configuration states {cfg['dtype']}")
    slots, new, lengths = tr["slots"], tr["new_tokens"], tr["prompt_lengths"]
    plan = Plan(ctx.seed, lengths, slots, cfg["vocab"])
    engine = ServeEngine(model, params, max_seq=max(lengths) + new + 8,
                         batch_slots=slots, temperature=0.0,
                         seed=_seed(ctx.seed), device=dev)
    steps = _Steps(engine, ctx.fault)
    for P in sorted(set(lengths)):
        steps.generate(engine, plan.warm(P), 2)
    if ctx.trace:
        trace_mod.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    before = dict(engine.timings)
    gc0 = gc.get_stats()[2]["collections"]

    batches: List[Batch] = []
    t0 = time.perf_counter()
    admit_until = t0 + ctx.seconds
    while (not batches or time.perf_counter() < admit_until
           or len(batches) % len(lengths)):
        batches.append(steps.batch_of(engine, plan, len(batches), new))
    after = dict(engine.timings)
    full_gcs = gc.get_stats()[2]["collections"] - gc0
    memory_peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        memory_peak = torch.cuda.max_memory_allocated(dev)

    run = ServeRun(c.name, cfg, t0 - ctx.t_start,
                   attempted=sum(b.rows for b in batches),
                   memory_peak_bytes=memory_peak,
                   costs=cell_mod.module("costs", c.family), t0=t0,
                   t1=batches[-1].done, batches=batches,
                   engine_before=before, engine_after=after,
                   capture_s=after["capture_s"], full_gcs=full_gcs)
    if ctx.trace:
        run.trace = _traced(run, steps, engine, plan, tr["trace"], new)
    run.failed = sum(check.malformed(b.tokens, new, cfg["vocab"])
                     for b in batches)

    del engine, steps
    _free(dev)
    served, control = _gap_max(c, params, plan, batches, ctx.seed, dev,
                               ctx.control)
    limits = dict(c.limits["max"]) if c.limits else {}
    limits.setdefault("failed_requests", 0)
    run.correct, run.checks = check.limit_checks(
        {"gap_max": control if ctx.control else served,
         "failed_requests": run.failed},
        {k: limits.get(k, float("nan")) for k in
         ("gap_max", "failed_requests")})
    if ctx.control:
        run.checks["served_gap_max"] = {"value": served,
                                        "limit": limits.get("gap_max")}
    return run


def _traced(run: ServeRun, steps: _Steps, engine, plan: Plan, spec: Dict,
            new: int):
    """The reduced trace of ``spec['batches']`` batches after the window,
    recorded in ``run.traced``."""
    profile = trace_mod.Profile()
    profile.start()
    i = len(run.batches)
    for k in range(spec["batches"]):
        run.traced.append(steps.batch_of(engine, plan, i + k, new))
    profile.stop()
    return profile.reduce()


def sample(c: cell_mod.Cell, batches: List[Batch], seed: int):
    """(batch, rows) of the check: ``batches_per_length`` batches of each
    prompt length, ``row_blocks`` rows of each."""
    spec = c.traffic["check"]
    rng = np.random.default_rng([_seed(seed), _SAMPLE])
    out = []
    for P in sorted({b.prompt_len for b in batches}):
        of_len = [b for b in batches if b.prompt_len == P]
        pick = rng.choice(len(of_len), min(spec["batches_per_length"],
                                           len(of_len)), replace=False)
        for k in sorted(pick):
            out.append((of_len[k], check.sample_rows(
                rng, of_len[k].rows, spec["row_blocks"])))
    return out


def reference_inputs(plan: Plan, b: Batch, rows: List[int], dev):
    """(tokens (R, P + n - 1): each prompt and its served tokens but the
    last, served (R, n)) of the sampled rows."""
    served = torch.tensor([b.tokens[r] for r in rows], dtype=torch.long)
    prompts = torch.as_tensor(plan.prompts(b.index)[rows])
    toks = torch.cat([prompts, served[:, :-1]], dim=1)
    return toks.to(dev), served.to(dev)


def _worst(g: torch.Tensor) -> float:
    return float(g.max()) if bool(torch.isfinite(g).all()) else float("inf")


def _gap_max(c: cell_mod.Cell, params, plan: Plan, batches: List[Batch],
             seed: int, dev, control: bool):
    """(the served tokens' widest gap over the sample, and with
    ``control`` that of the tokens the float8 reference puts first at the
    same positions, else None)."""
    from bench.reference import common
    common.strict_f32()
    ref = cell_mod.module("reference", c.family)
    worst, low = 0.0, (0.0 if control else None)
    for b, rows in sample(c, batches, seed):
        toks, served = reference_inputs(plan, b, rows, dev)
        lg = ref.logits(c.cfg, params, toks, b.prompt_len - 1)
        worst = max(worst, _worst(check.gaps(lg, served)))
        if control:
            lo = ref.logits(c.cfg, params, toks, b.prompt_len - 1, "fp8")
            low = max(low, _worst(check.control_gaps(lg, lo)))
            del lo
        del lg
        _free(dev)
    return worst, low
