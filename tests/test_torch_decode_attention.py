"""Decode attention on one device (``models.attention.attention_decode``)
against the formula it replaced, kept here as the reference: the scores as
an einsum over an f32 copy of the whole K cache, the weighted sum as an
einsum over the V cache, both through permuted copies of the cache.  The
port now reads the cache in place: one batched product a step and layer for
the scores and one for the weighted sum, each on a view of the cache, with q
block-diagonal over the kv heads.

The bars.  Both forms multiply the same values: a product of two bf16
values is exact in f32, and in an f32 cache both round each product once.
They differ only in the order of the f32 sums (the port's also add exact
zeros, the products of q's zero blocks), so

- the scores lie within the summation bound of their exact (float64)
  value: (hd + 1) x 2^-24 x sum_h |q_h k_h|, for any order;
- in an f32 cache the outputs agree to 1e-5 of the output's largest
  magnitude: a score moved by a few f32 ulps of the sum's terms moves its
  softmax weight by as much, relatively, and each output is a weighted
  mean of values of that magnitude (the largest gap seen is below 1e-6 of
  it);
- in a bf16 cache the weights are rounded to bf16 before the weighted sum
  and the result to bf16 after it, so an f32 sum moved by an ulp can land
  on the other side of a bf16 rounding: the outputs agree to one bf16 ulp
  of the output's largest magnitude (2^-8 of the power of two at or below
  it).

The cache write stays bitwise, and no op inside the step makes a tensor as
large as one layer's K cache (the reference's f32 copy and permuted copies
each do)."""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import write_rows
from repro_torch.models import attention as A


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread each, so the test workers running
    beside this file do not wait on each other's thread barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (q heads, kv heads, attention, cache length): G = 4, G = 1, the ring
KINDS = {"gqa": (8, 2, "full", 40), "mha": (4, 4, "full", 40),
         "swa": (8, 2, "swa", 16)}
# rows barely started and rows near the cache's end; the ring wraps
POSITIONS = {"full": [0, 39, 1, 37, 17, 2], "swa": [0, 47, 3, 16, 15, 29]}


def _cfg(kind: str, hd: int):
    H, K, attention, cl = KINDS[kind]
    return dataclasses.replace(
        get_config("granite-3-2b").reduced(), d_model=H * hd, n_heads=H,
        n_kv_heads=K, head_dim=hd, attention=attention, window=cl), cl


def _inputs(cfg, cl: int, B: int, dtype, seed: int = 0):
    """Params (``wo`` the identity, so the output is the attention's own),
    the new token's x, a random cache and the rows' positions."""
    g = torch.Generator().manual_seed(seed)
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    p = {"wq": rnd(D, H * hd, scale=D ** -0.5),
         "wk": rnd(D, K * hd, scale=D ** -0.5),
         "wv": rnd(D, K * hd, scale=D ** -0.5),
         "wo": torch.eye(H * hd, D, dtype=dtype)}
    x = rnd(B, 1, D, scale=2.0)
    cache = A.KVCache(rnd(B, cl, K, hd), rnd(B, cl, K, hd))
    pos = torch.tensor(POSITIONS[cfg.attention][:B], dtype=torch.int32)
    return p, x, cache, pos


def _reference(cfg, p, x, cache, positions):
    """The replaced single-device decode attention, as it was."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q, k_new, v_new = A._project_qkv(cfg, p, x, positions[:, None])
    ck, cv = cache
    cl = ck.shape[1]
    is_swa = cfg.attention == "swa"
    slot = positions % cl if is_swa else positions
    write_rows(ck, slot, k_new[:, 0])
    write_rows(cv, slot, v_new[:, 0])
    scores = torch.einsum("bkgh,btkh->bkgt", q[:, 0].float(),
                          ck.float()) * (hd ** -0.5)
    slot_ids = torch.arange(cl)[None, :]
    valid = A._live_slots(slot_ids, positions, slot, cl, is_swa)
    scores = scores.masked_fill(~valid[:, None, None], A.NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w.to(cv.dtype), cv)
    return out.reshape(B, 1, H * hd) @ p["wo"], A.KVCache(ck, cv)


def _copy(cache):
    return A.KVCache(cache.k.clone(), cache.v.clone())


def _bf16_ulp_bar(want: torch.Tensor) -> float:
    top = want.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 192])
@pytest.mark.parametrize("B", [3, 6])
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_attention_matches_the_einsum_formula(kind, B, hd, dtype):
    cfg, cl = _cfg(kind, hd)
    p, x, cache, pos = _inputs(cfg, cl, B, dtype)
    ref_cache = _copy(cache)
    got, got_cache = A.attention_decode(cfg, p, x, cache, pos)
    want, want_cache = _reference(cfg, p, x, ref_cache, pos)
    # the write happens in place, bit for bit as before
    assert got_cache.k is cache.k and got_cache.v is cache.v
    assert torch.equal(got_cache.k, want_cache.k)
    assert torch.equal(got_cache.v, want_cache.v)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.float32:
        bar = 1e-5 * want.abs().max().item()
    else:
        bar = _bf16_ulp_bar(want)
    gap = (got.float() - want.float()).abs().max().item()
    assert gap <= bar, (gap, bar)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G", [(5, 2, 4), (3, 4, 1), (4, 4, 2)])
def test_decode_scores_are_f32_sums_of_exact_products(B, K, G, dtype):
    """The scores (``_decode_scores``) within the summation bound of the
    float64 product of the same inputs, as the reference's are."""
    hd, cl = 64, 33
    g = torch.Generator().manual_seed(B * 100 + K * 10 + G)
    q = torch.randn(B, K, G, hd, generator=g).to(dtype)
    ck = torch.randn(B, cl, K, hd, generator=g).to(dtype)
    scores = A._decode_scores(q, ck)
    assert scores.dtype == torch.float32 and scores.shape == (B, cl, K * G)
    scores = scores.view(B, cl, K, G)
    exact = torch.einsum("bkgh,btkh->btkg", q.double(), ck.double())
    bound = (hd + 1) * 2.0 ** -24 * torch.einsum(
        "bkgh,btkh->btkg", q.double().abs(), ck.double().abs())
    assert ((scores.double() - exact).abs() <= bound).all()
    ref = torch.einsum("bkgh,btkh->btkg", q.float(), ck.float())
    assert ((ref.double() - exact).abs() <= bound).all()


class _Bmms(TorchDispatchMode):
    """Records the storages of every ``bmm``'s two operands."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket is torch.ops.aten.bmm:
            self.calls.append(tuple(a.untyped_storage().data_ptr()
                                    for a in args[:2]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,B", [("gqa", 3), ("mha", 6), ("swa", 4)])
def test_decode_products_read_the_caches_in_place(kind, B, dtype):
    """Two batched products a step and layer, the scores' on the K cache
    and the weighted sum's on the V cache, each taking the cache itself
    (a view sharing its storage) as an operand."""
    cfg, cl = _cfg(kind, 64)
    p, x, cache, pos = _inputs(cfg, cl, B, dtype)
    with _Bmms() as mode:
        A.attention_decode(cfg, p, x, cache, pos)
    k, v = (t.untyped_storage().data_ptr() for t in cache)
    assert [k in c for c in mode.calls] == [True, False]
    assert [v in c for c in mode.calls] == [False, True]


class _Fresh(TorchDispatchMode):
    """Records the element count of every op output that shares no
    storage with the op's inputs (an ``out=`` or in-place result does)."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = {t.untyped_storage().data_ptr()
               for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in ins):
                self.sizes.append((func.__name__, t.numel()))
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,B", [("gqa", 3), ("mha", 3), ("mha", 6),
                                    ("swa", 4)])
def test_decode_attention_makes_no_cache_sized_tensor(kind, B, dtype):
    """No aten op of the step (K >= 2) returns a new tensor with as many
    elements as one layer's K cache.  The CPU's ``bmm.dtype`` casts inside
    the op, one batch entry at a time; the card's test measures the
    memory a call takes."""
    cfg, cl = _cfg(kind, 64)
    assert cfg.n_kv_heads >= 2
    p, x, cache, pos = _inputs(cfg, cl, B, dtype)
    n = cache.k.numel()
    ref_cache = _copy(cache)
    with _Fresh() as mode:
        A.attention_decode(cfg, p, x, cache, pos)
    big = [(op, k) for op, k in mode.sizes if k >= n]
    assert not big, big
    # the mode sees the reference's copies of the cache
    with _Fresh() as mode:
        _reference(cfg, p, x, ref_cache, pos)
    assert any(k >= n for _, k in mode.sizes)
