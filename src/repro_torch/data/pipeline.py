"""Deterministic, checkpointable synthetic data pipeline (twin of
``repro.data.pipeline``).

Two task modes:
- ``random``: iid zipf-ish tokens (throughput realism);
- ``copy``: induction task — second half of each sequence repeats the first
  half, so a working model's loss drops well below ln(V) within a few hundred
  steps (the end-to-end training examples use this to *prove* learning).

State is just ``(seed, step)`` — restoring a checkpoint resumes the exact
batch sequence.  Each (step, row) pair derives its own counter-based numpy
RNG, the JAX package's draws in its order, so the tokens are byte-equal to
the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class PipelineState:
    seed: int
    step: int

    def as_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d) -> "PipelineState":
        return PipelineState(int(d["seed"]), int(d["step"]))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    arch: ArchConfig
    batch: int
    seq: int
    task: str = "copy"          # copy | random
    seed: int = 1234


def _row_tokens(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """One (seq+1,) token row, counter-based (stateless) RNG."""
    rng = np.random.default_rng(
        np.uint64(cfg.seed) * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(65_537) + np.uint64(row))
    V = cfg.arch.vocab
    n = cfg.seq + 1
    if cfg.task == "copy":
        half = (n + 1) // 2
        first = rng.integers(2, V, half)
        row_toks = np.concatenate([first, first])[:n]
        row_toks[0] = 1                      # BOS
        return row_toks
    # zipf-ish unigram distribution
    r = rng.random(n)
    toks = np.minimum((V - 1) * (r ** 3), V - 1).astype(np.int64)
    return toks


def host_batch(cfg: DataConfig, state: PipelineState
               ) -> Tuple[PipelineState, Dict[str, np.ndarray]]:
    """Full global batch on host; tokens/labels (B, S) int32."""
    rows = np.stack([_row_tokens(cfg, state.step, r)
                     for r in range(cfg.batch)])
    batch = {"tokens": rows[:, :-1].astype(np.int32),
             "labels": rows[:, 1:].astype(np.int32)}
    return PipelineState(state.seed, state.step + 1), batch


def device_batch(cfg: DataConfig, state: PipelineState,
                 device: DeviceLike = None
                 ) -> Tuple[PipelineState, Dict[str, torch.Tensor]]:
    """``host_batch`` as int32 tensors on ``device`` (the card unless told
    otherwise)."""
    dev = resolve_device(device)
    state, batch = host_batch(cfg, state)
    return state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
