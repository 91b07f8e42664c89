"""Operations and bytes of the port's kernels K5 (flash attention) and K6
(selective scan), and the roofline bound of a call: frozen copies of
``repro_torch.kernels.flash_attention.k5_cost``,
``repro_torch.kernels.selective_scan.k6_cost`` and ``chip_smoke.py``'s
``bound_ms`` / ``_k5_bound`` / ``_k6_bound``, kept here so that a change
to the port cannot move the yardstick.  Each counts the algorithm's work
from the shapes: the live (row, key) pairs of the causal mask once, and
each input and output byte moved once."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _itemsize(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def k5_cost(B: int, H: int, K: int, S: int, hd: int, window: int,
            dtype: torch.dtype) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K5 call: the two products over the live (row,
    key) pairs of the causal (banded, with ``window > 0``) mask, 4 FLOPs
    per (pair, head, dim); q and o (B, H, S, hd) and k and v (B, K, S, hd)
    each moved once in ``dtype``."""
    es = _itemsize(dtype)
    nbytes = es * S * hd * (2 * B * H + 2 * B * K)
    if window > 0:
        m = min(S, window)          # rows r < window see r + 1 keys
        pairs = m * (m + 1) // 2 + (S - m) * window
    else:
        pairs = S * (S + 1) // 2
    return 4 * B * H * hd * pairs, nbytes


def k6_cost(B: int, S: int, D: int, N: int, dtype: torch.dtype,
            heads: Optional[int] = None) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K6 call: 5 FLOPs per (b, t, d, n) (the decay
    product, the input product, the state update and y's product and sum;
    the exps are not counted); x and y (B, S, D) in ``dtype``, B and C
    (B, S, N), the final state (B, D, N) in f32, and dt (B, S, D) in
    ``dtype`` with A (D, N) f32, or in the per-head form (``heads`` H) dt
    (B, S, H) with A (H,), each moved once."""
    es = _itemsize(dtype)
    steps, a = (D, D * N) if heads is None else (heads, heads)
    nbytes = (es * B * S * (2 * D + steps)
              + 4 * (2 * B * S * N + a + B * D * N))
    return 5 * B * S * D * N, nbytes


def bound_ms(nbytes: float, ops: float, rates: Sequence[float],
             op_rate: Optional[float] = None) -> Tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over the memory rate and
    ``ops`` over ``op_rate`` (default: the f32 rate outside the tensor
    cores).  ``rates``: (bytes/s, f32 FLOP/s, bf16 tensor FLOP/s, TF32
    tensor FLOP/s), as ``peaks.rates`` gives them."""
    tb = nbytes / rates[0] * 1e3
    to = ops / (op_rate or rates[1]) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k5_bound_ms(B: int, H: int, K: int, S: int, hd: int, window: int,
                dtype: torch.dtype, rates: Sequence[float]
                ) -> Tuple[float, str]:
    """K5's bound on the tensor cores: at the dense bf16 rate for bf16
    inputs, and for f32 three times over at the dense TF32 rate (3xTF32,
    the least tensor work that keeps f32 accuracy)."""
    ops, nbytes = k5_cost(B, H, K, S, hd, window, dtype)
    if dtype == torch.bfloat16:
        return bound_ms(nbytes, ops, rates, rates[2])
    return bound_ms(nbytes, 3 * ops, rates, rates[3])


def k6_bound_ms(B: int, S: int, D: int, N: int, dtype: torch.dtype,
                rates: Sequence[float], heads: Optional[int] = None
                ) -> Tuple[float, str]:
    """K6's bound on the f32 pipes (its exps left out)."""
    ops, nbytes = k6_cost(B, S, D, N, dtype, heads)
    return bound_ms(nbytes, ops, rates)
