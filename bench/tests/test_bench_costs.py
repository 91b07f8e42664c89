"""The frozen yardstick (``bench/costs``) against the port's own cost
functions and ``chip_smoke.py``'s bounds today, at granite's, zamba2's
and nemotron's hd 192 shapes."""
import importlib.util

import pytest
import torch

from _bench_small import ROOT

from bench.costs import dense, hybrid, kernels, peaks
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import k5_cost
from repro_torch.kernels.selective_scan import k6_cost


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RATES = peaks.rates("NVIDIA H100 80GB HBM3")
# (B, H, K, S, hd, window): granite, zamba2 at the cells' sizes, nemotron
K5_SHAPES = [(8, 32, 8, 3000, 64, 0), (8, 32, 32, 2048, 64, 0),
             (4, 32, 8, 512, 64, 0), (2, 24, 2, 512, 192, 0),
             (1, 32, 8, 5000, 64, 4096)]
# (B, S, D, N, heads): zamba2 per head, falcon's (D, N) form
K6_SHAPES = [(8, 3000, 4096, 64, 64), (4, 512, 4096, 64, 64),
             (4, 512, 8192, 16, None)]


@pytest.mark.parametrize("shape", K5_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_cost_frozen_equal(shape, dtype):
    assert kernels.k5_cost(*shape, dtype) == k5_cost(*shape, dtype)
    got = kernels.k5_bound_ms(*shape, dtype, RATES)
    assert got == _chip_smoke()._k5_bound(*shape, dtype, RATES)


@pytest.mark.parametrize("shape", K6_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_cost_frozen_equal(shape, dtype):
    B, S, D, N, heads = shape
    assert kernels.k6_cost(B, S, D, N, dtype, heads) == \
        k6_cost(B, S, D, N, dtype, heads)
    assert kernels.k6_bound_ms(B, S, D, N, dtype, RATES, heads) == \
        _chip_smoke()._k6_bound(B, S, D, N, dtype, RATES, heads=heads)


def test_k5_counts_the_causal_half_once():
    """The algorithm's work: S (S + 1) / 2 live pairs, 4 FLOPs a pair,
    head and dim, whatever a kernel recomputes or triples."""
    for S in (1, 4, 3000):
        ops, _ = kernels.k5_cost(1, 1, 1, S, 1, 0, torch.bfloat16)
        assert ops == 4 * S * (S + 1) // 2
    full, _ = kernels.k5_cost(2, 32, 8, 3000, 64, 0, torch.bfloat16)
    assert full < 4 * 2 * 32 * 64 * 3000 * 3000 * 0.51


def test_peaks_are_the_data_sheets():
    assert RATES == (3.35e12, 67e12, 989e12, 495e12)
    with pytest.raises(KeyError):
        peaks.rates("a CPU")


def _cfg(name):
    a = get_config(name)
    return {k: getattr(a, k) for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab", "expand", "ssm_state", "ssm_conv", "ssm_head_dim",
        "attn_every")}


def test_dense_flops_count_the_port_weights():
    a, c = get_config("granite-3-2b"), _cfg("granite-3-2b")
    D, V, L = a.d_model, a.vocab, a.n_layers
    assert dense.token_weights(c) == a.param_count() - 2 * V * D - D \
        - 2 * L * D
    per_token = 2 * dense.token_weights(c)
    assert 4.8e9 < per_token < 4.95e9
    # a prefill: every token's products, the causal pairs, one head a row
    assert dense.prefill_flops(c, 1, 1) == per_token + 40 * 4 * 32 * 64 \
        + 2 * D * V
    assert dense.decode_flops(c, 2, 9) - dense.decode_flops(c, 2, 8) \
        == 2 * 40 * 4 * 32 * 64


def test_hybrid_flops_count_the_port_weights():
    a, c = get_config("zamba2-1.2b"), _cfg("zamba2-1.2b")
    di, nh = hybrid.d_inner(c), hybrid.ssm_heads(c)
    assert (di, nh) == (a.d_inner, a.d_inner // a.ssm_head_dim)
    assert hybrid.attention_layers(c) == 7 and hybrid.scan_layers(c) == 38
    D, N = a.d_model, a.ssm_state
    mamba = D * (2 * di + 2 * N + nh) + di * a.ssm_conv + di * D
    block = 4 * D * 32 * 64 + 3 * D * a.d_ff
    assert hybrid.token_weights(c) == 38 * mamba + 7 * block
    assert 2.85e9 < 2 * hybrid.token_weights(c) < 2.95e9
