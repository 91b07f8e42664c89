"""K5 (flash attention) and K6 (selective scan) on the CPU: the wrappers'
plain versions against the JAX Pallas kernels in interpret mode and
against the JAX oracles, on the JAX suite's cases
(``tests/test_kernels.py``) plus ragged shapes, with the JAX suite's bars:
5e-6 (f32) / 6e-3 (bf16) for attention, 2e-6 / 5e-2 for the scan.  K6's
final state is held against ``chunked_selective_scan``'s ``h_last``.  K6's
per-head form (Mamba-2: dt (B, S, H), a (H,)) is held bit for bit against
its per-channel case on dt and a repeated over each head's channels, and
against the Pallas kernel and the oracle on the broadcast (D, N) inputs.
The wrappers take the plain version only for CPU tensors: any other device
goes to the kernel's launcher, which refuses what is not on the card.
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import flash_attention_op, selective_scan_op
from repro.models.ssm import chunked_selective_scan
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import _build, ops
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
    (1, 12, 1, 128, 192, 0, jnp.float32),     # nemotron's head dim, 12:1
]
RAGGED_FLASH = [
    (1, 4, 2, 200, 64, 0, jnp.float32),       # S no multiple of a block
    (2, 6, 3, 77, 120, 30, jnp.bfloat16),     # danube's head dim, window
    (2, 24, 2, 96, 192, 0, jnp.bfloat16),     # nemotron's head dim, 12:1
    (1, 12, 1, 77, 192, 0, jnp.float32),
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
    (torch.bfloat16, 64, True, "bf16-wgmma-64"),
    (torch.bfloat16, 32, True, "bf16-wgmma-64"),
    (torch.bfloat16, 8, True, "bf16-wgmma-64"),
    (torch.bfloat16, 120, True, "bf16-wgmma-128"),
    (torch.bfloat16, 128, True, "bf16-wgmma-128"),
    (torch.bfloat16, 136, True, "bf16-wgmma-192"),
    (torch.bfloat16, 100, True, "bf16-mma-128-elementwise"),
    (torch.bfloat16, 7, True, "bf16-mma-64-elementwise"),
    (torch.bfloat16, 64, False, "bf16-mma-64-elementwise"),
    (torch.bfloat16, 128, False, "bf16-mma-128-elementwise"),
    (torch.float32, 64, True, "f32-fma-64"),
    (torch.float32, 120, False, "f32-fma-128-elementwise"),
    (torch.float32, 120, True, "f32-fma-128"),
    (torch.float32, 60, True, "f32-fma-64"),
    (torch.float32, 30, True, "f32-fma-64-elementwise"),
    (torch.bfloat16, 192, True, "bf16-wgmma-192"),
    (torch.bfloat16, 130, False, "bf16-mma-192-elementwise"),
    (torch.bfloat16, 192, False, "bf16-mma-192-elementwise"),
    (torch.float32, 192, True, "f32-fma-192"),
])
def test_flash_variant_names_the_route(dtype, hd, aligned, want):
    """bf16 runs on the tensor cores: the TMA-fed wgmma kernel where the
    rows are 16-byte multiples (hd % 8 == 0) and every tensor is 16-byte
    aligned, else the mma.sync kernel staging element by element; f32 runs
    on the FMA pipes, with 16-byte copies only for aligned tensors whose
    rows are 16-byte multiples (hd % 4 == 0).  hd pads to 64, 128 or
    192."""
    assert fa_mod.variant(dtype, hd, aligned) == want


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case", ["contiguous", "model view", "fused slice",
                                  "size-1 dims"])
def test_tma_plan_takes_strided_views(case):
    """The tensor maps' dims (hd, S, heads, B) and byte strides (S, heads,
    B) come from the tensor's own strides, so the model's transposed
    (B, S, H, hd) views and slices of a fused projection need no copy; a
    dim of size 1 takes the row pitch; the box is 64 dims x 64 rows."""
    B, S, H, hd = 2, 77, 6, 120
    if case == "contiguous":
        t, want = _bf16(B, H, S, hd), (2 * hd, 2 * S * hd, 2 * H * S * hd)
    elif case == "model view":
        t = _bf16(B, S, H, hd).transpose(1, 2)
        want = (2 * H * hd, 2 * hd, 2 * S * H * hd)
    elif case == "fused slice":     # q of a (B, S, H + 2 K, hd) projection
        t = _bf16(B, S, H + 2 * 3, hd)[:, :, :H].transpose(1, 2)
        want = (2 * (H + 6) * hd, 2 * hd, 2 * S * (H + 6) * hd)
    else:
        B, S, H = 1, 1, 1
        t = _bf16(B, S, H, hd).transpose(1, 2)
        want = (240, 240, 240)
    plan = fa_mod.tma_plan(t)
    assert plan.dims == (hd, S, H, B)
    assert plan.strides == want
    assert plan.box == (64, 64, 1, 1)
    assert all(st % 16 == 0 for st in plan.strides)


@pytest.mark.parametrize("case,why", [
    ("row stride 300 bytes", "16-byte multiple"),
    ("padded rows", "16-byte multiple"),
    ("last stride", "last stride"),
    ("misaligned base", "aligned"),
    ("f32", "bf16"),
])
def test_tma_plan_refuses_what_tma_cannot_describe(case, why):
    """A stride that is no 16-byte multiple (hd 150, or rows padded to 68
    of 64 dims), a last stride other than 1, a base off 16 bytes or an f32
    tensor: ``tma_plan`` refuses, and the launcher sends such tensors to
    the element-wise route as contiguous copies."""
    if case == "row stride 300 bytes":
        t = _bf16(1, 2, 9, 150)
    elif case == "padded rows":
        t = _bf16(1, 2, 9, 68)[..., :64]
    elif case == "last stride":
        t = _bf16(1, 2, 64, 9).transpose(2, 3)
    elif case == "misaligned base":
        t = _bf16(2 * 2 * 9 * 64 + 1)[1:].view(2, 2, 9, 64)
    else:
        t = torch.zeros(1, 2, 9, 64)
    assert why in fa_mod.tma_refusal(t)
    with pytest.raises(ValueError, match=why):
        fa_mod.tma_plan(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,window", [
    (2, 77, 6, 3, 120, 30), (1, 64, 8, 2, 64, 0), (2, 33, 4, 4, 32, 0),
    (1, 40, 12, 1, 192, 16)])
def test_op_on_strided_views_equals_contiguous_copies(dtype, B, S, H, K, hd,
                                                      window):
    """The model hands K5 transposed (B, S, heads, hd) views; the op takes
    them as they are and gives, bit for bit, what it gives on contiguous
    copies (the plain version on the CPU), in q's layout as the card's
    wgmma route and the meta form do (so the model's transpose back is a
    view)."""
    g = np.random.default_rng(S * hd + window)
    q, k, v = (torch.from_numpy(g.standard_normal((B, S, n, hd)).astype(
        np.float32)).to(dtype).transpose(1, 2) for n in (H, K, K))
    got = ops.flash_attention_op(q, k, v, window=window)
    want = ops.flash_attention_op(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=window)
    assert torch.equal(got, want)
    assert got.stride() == q.stride()
    assert got.transpose(1, 2).is_contiguous()


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
                                 "head_dim 193", "float16 scan",
                                 "k/v shape", "dt/x shape",
                                 "attention off the card",
                                 "strided attention off the card"])
def test_launchers_refuse_before_building(bad):
    """What each kernel refuses, refused before any build or launch (meta
    tensors never reach the card; the launcher refuses CPU tensors,
    strided or not, before it routes or builds)."""
    m = dict(device="meta")
    n5, n6 = flash_attention.launches, selective_scan.launches
    libs = dict(_build._LIBS)
    with pytest.raises(ValueError):
        if bad == "attention off the card":
            fa_mod.launch(*(torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
                            for _ in range(3)))
        elif bad == "strided attention off the card":
            fa_mod.launch(*(torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
                            .transpose(1, 2) for _ in range(3)))
        elif bad == "float16 attention":
            fa_mod.variant(torch.float16, 64)
        elif bad == "head_dim 0":
            fa_mod.variant(torch.bfloat16, 0)
        elif bad == "head_dim 193":
            flash_attention(*(torch.empty(1, 2, 8, 193, dtype=torch.bfloat16,
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
    assert _build._LIBS == libs


# K6's per-head form: (B, S, H, P, N, dtype); S ragged where no Pallas
# kernel runs (it takes S a multiple of q_chunk)
PER_HEAD = [(2, 37, 96, 1, 16, jnp.float32), (2, 37, 8, 32, 16, jnp.bfloat16),
            (1, 29, 3, 64, 64, jnp.float32), (2, 37, 2, 64, 64, jnp.bfloat16),
            (1, 21, 4, 32, 64, jnp.float32), (2, 19, 5, 24, 16, jnp.float32)]
# (B, S, H, P, N, block_d, q_chunk, dtype): D = H·P a multiple of block_d
PER_HEAD_PALLAS = [(2, 32, 128, 1, 16, 128, 16, jnp.float32),
                   (1, 32, 4, 32, 16, 128, 8, jnp.float32),
                   (2, 32, 2, 64, 64, 128, 16, jnp.float32),
                   (1, 32, 2, 64, 16, 128, 8, jnp.bfloat16)]


def _head_inputs(B, S, H, P, N, dt_, seed):
    """Per-head inputs made with numpy: (dt (B, S, H), x, b, c, a (H,))
    and their per-channel repeat (dt (B, S, D), a (D,)), both as torch
    tensors, and the broadcast (D, N) form as JAX arrays."""
    g = np.random.default_rng(seed)
    D = H * P
    dt = jnp.asarray(g.random((B, S, H)) * 0.1 + 0.01, dt_)
    x = jnp.asarray(g.standard_normal((B, S, D)), dt_)
    b = jnp.asarray(g.standard_normal((B, S, N)), jnp.float32)
    c = jnp.asarray(g.standard_normal((B, S, N)), jnp.float32)
    a = jnp.asarray(-np.exp(g.standard_normal(H) * 0.3), jnp.float32)
    dt_d, a_d = jnp.repeat(dt, P, axis=-1), jnp.repeat(a, P)
    head = [tensor_from_numpy(np.asarray(t), "cpu") for t in (dt, x, b, c, a)]
    chan = [tensor_from_numpy(np.asarray(t), "cpu")
            for t in (dt_d, x, b, c, a_d)]
    jdn = (dt_d, x, b, c, jnp.broadcast_to(a_d[:, None], (D, N)))
    return head, chan, jdn


@pytest.mark.parametrize("case", PER_HEAD, ids=_ids(PER_HEAD))
def test_scan_per_head_equals_per_channel_bitwise(case):
    """The per-head plain version (one exp per (b, t, head), broadcast over
    the head's P channels and the N states) gives the per-channel plain
    version's y and h_S bit for bit on dt and a repeated P times."""
    B, S, H, P, N, dt_ = case
    head, chan, _ = _head_inputs(B, S, H, P, N, dt_, 23)
    y, h = ops.selective_scan_op(*head)
    y_c, h_c = ops.selective_scan_op(*chan)
    assert y.dtype == head[1].dtype and y.shape == (B, S, H * P)
    assert torch.equal(y, y_c) and torch.equal(h, h_c)


@pytest.mark.parametrize("case", PER_HEAD_PALLAS,
                         ids=_ids(PER_HEAD_PALLAS))
def test_scan_per_head_matches_pallas_and_oracle(case):
    B, S, H, P, N, bd, qc, dt_ = case
    head, _, jdn = _head_inputs(B, S, H, P, N, dt_, 24)
    tol = _tol(dt_, 2e-6, 5e-2)
    y, h = ops.selective_scan_op(*head)
    _close(y, selective_scan_op(*jdn, block_d=bd, q_chunk=qc,
                                interpret=True), tol)
    _close(y, jref.selective_scan_ref(*jdn), tol)
    _close(h, _h_last(jdn), tol)


@pytest.mark.parametrize("case", PER_HEAD[-2:], ids=_ids(PER_HEAD[-2:]))
def test_scan_per_head_ragged_matches_oracle(case):
    B, S, H, P, N, dt_ = case
    head, _, jdn = _head_inputs(B, S, H, P, N, dt_, 25)
    y, h = ops.selective_scan_op(*head)
    _close(y, jref.selective_scan_ref(*jdn), 2e-6)
    _close(pref.selective_scan_ref(*head), jref.selective_scan_ref(*jdn),
           2e-6)
    _close(h, _h_last(jdn), 2e-6)


def test_scan_per_head_meta_route_launches_nothing():
    """Meta tensors of the per-head form get y (B, S, D) and h_S (B, D, N)
    f32 through the custom op, with no launch; the launcher refuses them
    before building anything."""
    head, _, _ = _head_inputs(2, 5, 3, 24, 64, jnp.bfloat16, 1)
    meta = [t.to("meta") for t in head]
    n = dict(selective_scan.route_launches)
    y, h = selective_scan(*meta)
    assert (y.device.type, tuple(y.shape), y.dtype) == (
        "meta", (2, 5, 72), torch.bfloat16)
    assert (tuple(h.shape), h.dtype) == ((2, 72, 64), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        sc_mod._check_args(*meta)
    assert selective_scan.route_launches == n


@pytest.mark.parametrize("bad", ["no multiple", "a's length", "(B, S, H)",
                                 "takes dt (B, S, D)"])
def test_scan_per_head_refuses_shapes(bad):
    """D not a multiple of H, dt's last dim not a's length, dt of another
    (B, S), and a (D, N) with a per-head dt: refused on the meta route (and
    so before any launch), the CPU route and the launcher alike."""
    B, S, H, P, N = 1, 4, 3, 8, 16
    dt_h, a_h = (B, S, H), (H,)
    shapes = {"no multiple": ((B, S, 5), (B, S, 32), (5,)),
              "a's length": ((B, S, H), (B, S, H * P), (H + 1,)),
              "(B, S, H)": ((B, S + 1, H), (B, S, H * P), a_h),
              "takes dt (B, S, D)": (dt_h, (B, S, H * P), (H * P, N))}[bad]
    dt, x, a = shapes
    for dev in ("meta", "cpu"):
        args = [torch.zeros(dt, device=dev), torch.zeros(x, device=dev),
                torch.zeros(B, S, N, device=dev),
                torch.zeros(B, S, N, device=dev), torch.zeros(a, device=dev)]
        with pytest.raises(ValueError, match=re.escape(bad)):
            selective_scan(*args)
        with pytest.raises(ValueError, match=re.escape(bad)):
            sc_mod._check_args(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_cost_counts_per_head_bytes(dtype):
    """The per-head form moves dt (B, S, H) and A (H,): its bytes are the
    per-channel case's less (D - H) values of dt per (b, t) and of A; the
    FLOPs are the same.  The custom op's formula counts the same."""
    B, S, H, P, N = 4, 512, 64, 64, 64
    D, es = H * P, (2 if dtype == torch.bfloat16 else 4)
    f_h, b_h = sc_mod.k6_cost(B, S, D, N, dtype, heads=H)
    f_c, b_c = sc_mod.k6_cost(B, S, D, N, dtype, heads=D)
    f_dn, b_dn = sc_mod.k6_cost(B, S, D, N, dtype)
    assert f_h == f_c == f_dn == 5 * B * S * D * N
    assert b_c - b_h == es * B * S * (D - H) + 4 * (D - H)
    assert b_h == (es * B * S * (2 * D + H)
                   + 4 * (2 * B * S * N + H + B * D * N))
    assert b_dn - b_c == 4 * D * (N - 1)
    meta = [torch.empty(s, device="meta", dtype=t) for s, t in (
        ((B, S, H), dtype), ((B, S, D), dtype), ((B, S, N), torch.float32),
        ((B, S, N), torch.float32), ((H,), torch.float32))]
    assert sc_mod.selective_scan_cost(*meta) == (f_h, b_h)
