"""K5 (flash attention) and K6 (selective scan) on the CPU: the wrappers'
plain versions against the JAX Pallas kernels in interpret mode and
against the JAX oracles, on the JAX suite's cases
(``tests/test_kernels.py``) plus ragged shapes, with the JAX suite's bars:
5e-6 (f32) / 6e-3 (bf16) for attention, 2e-6 / 5e-2 for the scan.  K6's
final state is held against ``chunked_selective_scan``'s ``h_last``.  The
wrappers take the plain version only for CPU tensors: any other device
goes to the kernel's launcher, which refuses what is not on the card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import flash_attention_op, selective_scan_op
from repro.models.ssm import chunked_selective_scan
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import selective_scan as sc_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.selective_scan import selective_scan

FLASH_CASES = [
    # (B, H, K, S, hd, window, dtype); the first six are the JAX suite's
    (2, 4, 4, 256, 64, 0, jnp.float32),
    (1, 8, 2, 128, 128, 0, jnp.bfloat16),
    (2, 4, 1, 256, 64, 0, jnp.float32),
    (2, 4, 4, 256, 64, 128, jnp.float32),
    (1, 2, 2, 384, 128, 0, jnp.bfloat16),
    (1, 4, 2, 512, 32, 256, jnp.bfloat16),
]
RAGGED_FLASH = [
    (1, 4, 2, 200, 64, 0, jnp.float32),       # S no multiple of a block
    (2, 6, 3, 77, 120, 30, jnp.bfloat16),     # danube's head dim, window
]
SCAN_CASES = [
    # (B, S, D, N, block_d, q_chunk, dtype), the JAX suite's
    (2, 32, 128, 16, 128, 16, jnp.float32),
    (1, 64, 256, 16, 128, 32, jnp.float32),
    (2, 48, 128, 8, 64, 16, jnp.float32),
    (1, 32, 128, 16, 128, 8, jnp.bfloat16),
]
RAGGED_SCAN = [
    (2, 37, 96, 16, jnp.float32),             # S and D ragged
    (1, 45, 200, 8, jnp.bfloat16),
]


def _tol(dt, f32, bf16):
    return f32 if dt == jnp.float32 else bf16


def _ids(cases):
    return ["-".join(str(getattr(v, "__name__", v)) for v in c)
            for c in cases]


def _qkv(case, seed):
    B, H, K, S, hd, _, dt = case
    g = np.random.default_rng(seed)
    arrs = [jnp.asarray(g.standard_normal(shp), dt)
            for shp in ((B, H, S, hd), (B, K, S, hd), (B, K, S, hd))]
    return arrs, [tensor_from_numpy(np.asarray(a), "cpu") for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES, ids=_ids(FLASH_CASES))
def test_flash_plain_matches_pallas_and_oracle(case):
    (jq, jk, jv), (q, k, v) = _qkv(case, 11)
    win, dt = case[5], case[6]
    tol = _tol(dt, 5e-6, 6e-3)
    got = ops.flash_attention_op(q, k, v, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, flash_attention_op(jq, jk, jv, window=win, interpret=True),
           tol)
    _close(got, jref.attention_ref(jq, jk, jv, window=win), tol)
    _close(pref.attention_ref(q, k, v, window=win),
           jref.attention_ref(jq, jk, jv, window=win), tol)


@pytest.mark.parametrize("case", RAGGED_FLASH, ids=_ids(RAGGED_FLASH))
def test_flash_plain_ragged_matches_oracle(case):
    (jq, jk, jv), (q, k, v) = _qkv(case, 12)
    win, dt = case[5], case[6]
    _close(ops.flash_attention_op(q, k, v, window=win),
           jref.attention_ref(jq, jk, jv, window=win),
           _tol(dt, 5e-6, 6e-3))


def _scan_inputs(B, S, D, N, dt_, seed):
    g = np.random.default_rng(seed)
    arrs = [jnp.asarray(g.random((B, S, D)) * 0.1 + 0.01, dt_),
            jnp.asarray(g.standard_normal((B, S, D)), dt_),
            jnp.asarray(g.standard_normal((B, S, N)), jnp.float32),
            jnp.asarray(g.standard_normal((B, S, N)), jnp.float32),
            jnp.asarray(-np.exp(g.standard_normal((D, N)) * 0.3),
                        jnp.float32)]
    return arrs, [tensor_from_numpy(np.asarray(a), "cpu") for a in arrs]


def _h_last(jin):
    dt, x, b, _, a = (jnp.asarray(t, jnp.float32) for t in jin)
    dA = jnp.exp(dt[..., None] * a)
    dBx = (dt * x)[..., None] * b[:, :, None, :]
    h0 = jnp.zeros((x.shape[0],) + a.shape, jnp.float32)
    return chunked_selective_scan(dA, dBx, h0, chunk=8)[1]


@pytest.mark.parametrize("case", SCAN_CASES, ids=_ids(SCAN_CASES))
def test_scan_plain_matches_pallas_and_oracle(case):
    B, S, D, N, bd, qc, dt_ = case
    jin, tin = _scan_inputs(B, S, D, N, dt_, 21)
    tol = _tol(dt_, 2e-6, 5e-2)
    y, h = ops.selective_scan_op(*tin)
    assert y.dtype == tin[1].dtype and h.dtype == torch.float32
    _close(y, selective_scan_op(*jin, block_d=bd, q_chunk=qc,
                                interpret=True), tol)
    _close(y, jref.selective_scan_ref(*jin), tol)
    _close(pref.selective_scan_ref(*tin), jref.selective_scan_ref(*jin), tol)
    _close(h, _h_last(jin), tol)


@pytest.mark.parametrize("case", RAGGED_SCAN, ids=_ids(RAGGED_SCAN))
def test_scan_plain_ragged_matches_oracle(case):
    B, S, D, N, dt_ = case
    jin, tin = _scan_inputs(B, S, D, N, dt_, 22)
    tol = _tol(dt_, 2e-6, 5e-2)
    y, h = ops.selective_scan_op(*tin)
    _close(y, jref.selective_scan_ref(*jin), tol)
    _close(h, _h_last(jin), tol)


def test_wrappers_use_plain_versions_only_on_the_cpu():
    """CPU tensors run the plain version and count no launch; meta tensors
    get the outputs' shapes (the dry run) and count no launch; the
    kernel's launcher checks its arguments before building anything and
    refuses a non-CUDA device."""
    (_, (q, k, v)) = _qkv((1, 2, 1, 8, 16, 0, jnp.float32), 1)
    (_, sc) = _scan_inputs(1, 8, 16, 8, jnp.float32, 1)
    n5, n6 = flash_attention.launches, selective_scan.launches
    flash_attention(q, k, v)
    selective_scan(*sc)
    assert (flash_attention.launches, selective_scan.launches) == (n5, n6)
    meta = [t.to("meta") for t in (q, k, v)]
    o = flash_attention(*meta)
    assert o.device.type == "meta" and o.shape == q.shape
    y, h = selective_scan(*[t.to("meta") for t in sc])
    assert (y.device.type, tuple(y.shape), tuple(h.shape), h.dtype) == (
        "meta", tuple(sc[1].shape), (1, 16, 8), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod._check_args(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        sc_mod._check_args(*[t.to("meta") for t in sc])
    assert (flash_attention.launches, selective_scan.launches) == (n5, n6)


@pytest.mark.parametrize("bad", ["head_dim", "H % K", "state size",
                                 "one dtype"])
def test_kernel_launchers_refuse_shapes_they_do_not_take(bad):
    m = dict(device="meta")
    with pytest.raises(ValueError, match=bad):
        if bad == "head_dim":
            flash_attention(torch.empty(1, 2, 8, 256, **m),
                            torch.empty(1, 2, 8, 256, **m),
                            torch.empty(1, 2, 8, 256, **m))
        elif bad == "H % K":
            flash_attention(torch.empty(1, 3, 8, 64, **m),
                            torch.empty(1, 2, 8, 64, **m),
                            torch.empty(1, 2, 8, 64, **m))
        elif bad == "state size":
            selective_scan(torch.empty(1, 4, 32, **m),
                           torch.empty(1, 4, 32, **m),
                           torch.empty(1, 4, 12, **m),
                           torch.empty(1, 4, 12, **m),
                           torch.empty(32, 12, **m))
        else:
            selective_scan(torch.empty(1, 4, 32, **m),
                           torch.empty(1, 4, 32, dtype=torch.float16, **m),
                           torch.empty(1, 4, 16, **m),
                           torch.empty(1, 4, 16, **m),
                           torch.empty(32, 16, **m))


@pytest.mark.parametrize("dtype,hd,aligned,want", [
    (torch.bfloat16, 64, True, "bf16-mma-64"),
    (torch.bfloat16, 32, True, "bf16-mma-64"),
    (torch.bfloat16, 120, True, "bf16-mma-128"),
    (torch.bfloat16, 128, True, "bf16-mma-128"),
    (torch.bfloat16, 100, True, "bf16-mma-128-elementwise"),
    (torch.bfloat16, 7, True, "bf16-mma-64-elementwise"),
    (torch.bfloat16, 64, False, "bf16-mma-64-elementwise"),
    (torch.float32, 64, True, "f32-fma-64"),
    (torch.float32, 120, False, "f32-fma-128-elementwise"),
    (torch.float32, 120, True, "f32-fma-128"),
    (torch.float32, 60, True, "f32-fma-64"),
    (torch.float32, 30, True, "f32-fma-64-elementwise"),
])
def test_flash_variant_names_the_route(dtype, hd, aligned, want):
    """bf16 runs on the tensor cores and f32 on the FMA pipes, each with
    16-byte copies only for aligned tensors whose rows are 16-byte
    multiples (hd % 8 == 0 in bf16, hd % 4 == 0 in f32); hd pads to 64 or
    128."""
    assert fa_mod.variant(dtype, hd, aligned) == want


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype,fp32_pipes,want_us,want_by", [
    (torch.bfloat16, False, 6.26, "bytes"),
    (torch.float32, False, 26.08, "operations"),
    (torch.float32, True, 64.23, "operations"),
])
def test_k5_bound_at_granites_prefill(dtype, fp32_pipes, want_us, want_by):
    """chip_smoke's K5 bound at granite-3-2b's prefill (B 4, H 32, K 8, S
    512, hd 64) on an H100 SXM: bf16 by its bytes; f32 by three times
    its causal products at the dense TF32 rate (3xTF32), with the FMAs'
    bound on the f32 pipes beside it."""
    cs = _chip_smoke()
    rates = cs.card_rates("NVIDIA H100 80GB HBM3")
    ms, by = cs._k5_bound(4, 32, 8, 512, 64, 0, dtype, rates,
                          fp32_pipes=fp32_pipes)
    es = 2 if dtype == torch.bfloat16 else 4
    nbytes = es * 512 * 64 * (2 * 4 * 32 + 2 * 4 * 8)
    ops_ = 4 * 4 * 32 * 64 * (512 * 513 // 2)
    rate = (989e12 if dtype == torch.bfloat16
            else 67e12 if fp32_pipes else 495e12 / 3)
    assert ms == pytest.approx(max(nbytes / 3.35e12, ops_ / rate) * 1e3,
                               rel=1e-12)
    assert (by, round(ms * 1e3, 2)) == (want_by, want_us)


@pytest.mark.parametrize("dtype,D,aligned,want", [
    (torch.float32, 8192, True, "f32-cp.async"),
    (torch.float32, 200, True, "f32-cp.async"),
    (torch.float32, 198, True, "f32-elementwise"),
    (torch.float32, 8192, False, "f32-elementwise"),
    (torch.bfloat16, 96, True, "bf16-cp.async"),
    (torch.bfloat16, 100, True, "bf16-elementwise"),
])
def test_scan_variant_names_the_staging(dtype, D, aligned, want):
    assert sc_mod.variant(dtype, D, aligned) == want


@pytest.mark.parametrize("bad", ["float16 attention", "head_dim 0",
                                 "head_dim 129", "float16 scan",
                                 "k/v shape", "dt/x shape"])
def test_launchers_refuse_before_building(bad):
    """What each kernel refuses, refused before any build or launch (meta
    tensors never reach the card)."""
    m = dict(device="meta")
    n5, n6 = flash_attention.launches, selective_scan.launches
    with pytest.raises(ValueError):
        if bad == "float16 attention":
            fa_mod.variant(torch.float16, 64)
        elif bad == "head_dim 0":
            fa_mod.variant(torch.bfloat16, 0)
        elif bad == "head_dim 129":
            flash_attention(*(torch.empty(1, 2, 8, 129, dtype=torch.bfloat16,
                                          **m) for _ in range(3)))
        elif bad == "float16 scan":
            sc_mod.variant(torch.float16, 64)
        elif bad == "k/v shape":
            flash_attention(torch.empty(1, 4, 8, 64, **m),
                            torch.empty(1, 2, 9, 64, **m),
                            torch.empty(1, 2, 9, 64, **m))
        else:
            selective_scan(torch.empty(1, 4, 32, **m),
                           torch.empty(1, 5, 32, **m),
                           torch.empty(1, 4, 16, **m),
                           torch.empty(1, 4, 16, **m),
                           torch.empty(32, 16, **m))
    assert (flash_attention.launches, selective_scan.launches) == (n5, n6)
