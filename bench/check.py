"""The correctness check of a served model: a sample of finished requests,
drawn from the seed, is run through the family's plain float32 reference
over each prompt and its served tokens, and each served token's
reference logit is compared with the reference's best at that position.
The gap, in units of the reference logits' standard deviation over the
vocabulary at that position, is 0 where the served token is the
reference's own greedy choice; ``gap_max`` is the widest over the
sample."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """ref_logits (R, n, V) float32 at the positions that produced the n
    served tokens (R, n) -> (R, n) gaps in reference standard deviations."""
    best = ref_logits.amax(dim=-1)
    got = ref_logits.gather(-1, served[..., None].long())[..., 0]
    return (best - got) / ref_logits.std(dim=-1)


def control_gaps(ref_logits: torch.Tensor,
                 low_logits: torch.Tensor) -> torch.Tensor:
    """The gaps of the tokens a lower-precision forward puts first."""
    return gaps(ref_logits, low_logits.argmax(dim=-1))


def sample_rows(rng: np.random.Generator, slots: int,
                blocks: int) -> List[int]:
    """One row from each of ``blocks`` equal runs of the slots, so every
    part of the batch is in the sample."""
    blocks = min(blocks, slots)
    edges = np.linspace(0, slots, blocks + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges, edges[1:])]


def malformed(tokens: Sequence[Sequence[int]], new: int,
              vocab: int) -> int:
    """Requests of a batch whose answer is not ``new`` ids in [0, vocab)."""
    return sum(1 for t in tokens
               if len(t) != new or any(not 0 <= x < vocab for x in t))


def limit_checks(readings: Dict[str, float], limits: Dict[str, float]
                 ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every reading finite and within its limit, {name: {value,
    limit}})."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in readings.items())
    return ok, out
