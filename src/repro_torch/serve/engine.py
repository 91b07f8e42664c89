"""Batched serving engine: slot-based batching over a shared prefill/decode
pair (twin of ``repro.serve.engine``).

A fixed batch of B slots, each holding one request's cache rows; per-slot
positions and an active mask let finished slots stop while the others
decode.  Greedy or temperature sampling (a seeded ``torch.Generator``).
The engine runs on ``device`` (the card unless the caller passes
``device="cpu"``), moving the parameters there if they live elsewhere.

As the reference ``jax.jit``s ``prefill`` and ``decode_step``, the engine
runs them as ``_graphs.CapturedStep``s in one graph pool: on the card each
is captured as a CUDA graph once per signature and replayed; the prefill
graph's output caches are the decode graph's state, so a second
``generate`` at the same prompt length replays both and captures
nothing.  On the CPU the same steps run eagerly on the same static
buffers.  Sampling, the EOS mask and the per-step read of the tokens stay
outside the graphs, as outside the reference's jit.  The parameters are
read by address: replacing ``params`` under a captured step raises.

``timings``: seconds in prefill calls / decode steps and their counts
(host clock; each ends in a device read of the sampled tokens; warm-up
and capture excluded; a decode step's seconds exclude the loop-top read
of the active mask), the captures (``captures``, one per step and
signature), the seconds of their warm-up and capture (``capture_s``), the
eager warm-up runs of the prefill (``warmup_prefills``: they launch the
prefill's kernels) and the bytes the graph pool reserved (``pool_bytes``).
Inside the decode steps, on the host clock with no sync added:
``decode_launch_s``, the decode step's copies and replays (its
``CapturedStep.run_s``); ``decode_read_s``, the seconds the decode loop
spent blocked in reads of device values (the loop-top read included),
which on the card is mostly the wait for the step's device work; and
``decode_syncs``, those reads (3 a step: the loop-top ``any()``, the
active mask and the tokens).  ``warmup_s`` is the host's part of
``capture_s`` in eager warm-up runs.

Spans (``_trace``, only while a ``torch.profiler`` profile runs):
``serve.generate`` around each call, holding ``serve.upload``,
``serve.prefill`` and one ``serve.decode`` a loop iteration, each with
its ``graph.step``, ``serve.sample`` and ``serve.read`` spans.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._graphs import CapturedStep, GraphPool
from repro_torch._trace import (DECODE, GENERATE, PREFILL, READ, SAMPLE,
                                UPLOAD, span)
from repro_torch.distributed.sharding import tree_map
from repro_torch.models.model import Model


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    prompt_len: int
    steps: int


class ServeEngine:
    def __init__(self, model: Model, params, *, max_seq: int,
                 batch_slots: int, temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_seq = max_seq
        self.slots = batch_slots
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._pool = GraphPool(self.device)
        self._prefill = CapturedStep(
            lambda p, batch, _, cache_len: model.prefill(p, batch,
                                                         cache_len),
            self._pool)
        self._decode = CapturedStep(
            lambda p, batch, caches: model.decode_step(p, caches, batch),
            self._pool)
        self.timings: Dict[str, float] = dict(
            prefill_s=0.0, prefills=0, decode_s=0.0, decode_steps=0,
            decode_read_s=0.0, decode_syncs=0)
        self._calls = 0
        self.timings.update(self._graph_timings())

    # ------------------------------------------------------------------
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """``model.prefill(params, batch, max_seq)``, captured: (logits,
        caches), both the graph's static outputs."""
        return self._prefill(self.params, batch, cache_len=self.max_seq)

    def decode(self, caches, batch: Dict[str, torch.Tensor]):
        """``model.decode_step(params, caches, batch)``, captured for these
        caches (a prefill's): (logits, caches advanced in place)."""
        return self._decode(self.params, batch, caches)

    def _setup_s(self) -> float:
        return self._prefill.setup_s + self._decode.setup_s

    def _graph_timings(self) -> Dict[str, float]:
        return dict(captures=self._prefill.captures + self._decode.captures,
                    capture_s=self._setup_s(),
                    warmup_prefills=self._prefill.warmups,
                    pool_bytes=self._pool.reserved,
                    decode_launch_s=self._decode.run_s,
                    warmup_s=self._prefill.warmup_s + self._decode.warmup_s)

    def _read(self, read: Callable[[], Any]) -> Any:
        """``read()``, one blocking read of device values by the decode
        loop, in a ``serve.read`` span; its seconds and the read counted."""
        t0 = time.perf_counter()
        with span(READ):
            value = read()
        self.timings["decode_read_s"] += time.perf_counter() - t0
        self.timings["decode_syncs"] += 1
        return value

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0:
            # first maximum on ties, as jnp.argmax
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(
            torch.int32)

    # ------------------------------------------------------------------
    def generate(self, prompts: np.ndarray, max_new: int,
                 eos_id: Optional[int] = None) -> List[GenerationResult]:
        """prompts: (B, P) int, B == batch_slots (pad rows for fewer).
        Synchronized prefill + per-slot decode with active masking."""
        B, P = prompts.shape
        if B != self.slots:
            raise ValueError(f"{B} prompt rows for {self.slots} slots")
        self._calls += 1
        with span(GENERATE, dict(call=self._calls, rows=B, prompt_len=P)):
            t0, s0 = time.perf_counter(), self._setup_s()
            with span(UPLOAD):
                tokens = torch.as_tensor(np.asarray(prompts),
                                         device=self.device).long()
            with span(PREFILL):
                logits, caches = self.prefill({"tokens": tokens})
                with span(SAMPLE):
                    tok = self._sample(logits)
                # honor EOS on the prefill-sampled token too: the token
                # is still emitted, but its slot goes inactive before any
                # decode step
                active = (tok != eos_id) if eos_id is not None \
                    else torch.ones((B,), dtype=torch.bool, device=self.device)
                with span(READ):
                    out = [[t] for t in tok.tolist()]
            self.timings["prefill_s"] += (time.perf_counter() - t0
                                          - (self._setup_s() - s0))
            self.timings["prefills"] += 1
            pos = torch.full((B,), P, dtype=torch.long, device=self.device)

            for _ in range(max_new - 1):
                with span(DECODE):
                    if not self._read(lambda: bool(active.any())):
                        break
                    t0, s0 = time.perf_counter(), self._setup_s()
                    logits, caches = self.decode(
                        caches, {"token": tok.long(), "positions": pos})
                    with span(SAMPLE):
                        nxt = self._sample(logits)
                        if eos_id is not None:
                            active = active & (tok != eos_id)
                        nxt = torch.where(active, nxt, tok)
                    flags = self._read(active.tolist)
                    toks = self._read(nxt.tolist)
                    for i, (a, t) in enumerate(zip(flags, toks)):
                        if a:
                            out[i].append(t)
                    self.timings["decode_s"] += (time.perf_counter() - t0
                                                 - (self._setup_s() - s0))
                    self.timings["decode_steps"] += 1
                    tok = nxt
                    pos = pos + active.long()
        self.timings.update(self._graph_timings())
        return [GenerationResult(toks, P, len(toks)) for toks in out]
