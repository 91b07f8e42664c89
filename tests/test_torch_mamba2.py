"""The port's Mamba-2 block (``repro_torch.models.ssm``) and K6's
per-head form against the JAX package on the CPU, at the reduced
zamba2-1.2b (d_inner 256, 8 heads of 32 channels, N 16).

The JAX block's parameters go into the port as they are.  The scan
route (``mamba2_apply``: prefill's per-head K6 call, whose plain
version runs here, and the training route's chunked scan), the SSD form
(``mamba2_apply_ssd``) and the decode step (``mamba2_step``) are held
against the JAX functions, the final state and conv tail included: f32
within 1e-5 (rtol and atol, the Mamba-1 test's bar), bf16 within 2e-2 x
max|out|.  K6's plain version with one decay per channel (the per-head
form at H = D) is held against the (D, N) form on the broadcast decay
and against the JAX reference scan.
``Model.loss`` and its gradients for the reduced zamba2 (scan and ssd)
are held against ``jax.value_and_grad`` of the JAX loss in f32.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed.sharding import init_tree
from repro.kernels.ref import selective_scan_ref as jax_scan_ref
from repro.models import ssm as jssm
from repro.models.model import ModelFlags as JaxFlags
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.distributed.sharding import tree_leaves
from repro_torch.kernels.selective_scan import selective_scan_plain
from repro_torch.models import ssm
from repro_torch.models.model import ModelFlags, build_model
from test_torch_models import numpy_tree

ARCH = "zamba2-1.2b"
JCFG = JAX_ARCHS[ARCH].reduced()
PCFG = get_config(ARCH).reduced()
BF16_BAR = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(dtype):
    p = init_tree(jssm.mamba2_template(JCFG), jax.random.key(0))
    p = {k: (v.astype(dtype) if v.dtype == jnp.bfloat16 else v)
         for k, v in p.items()}
    return p, {k: tensor_from_numpy(np.asarray(v), "cpu")
               for k, v in p.items()}


def _x(shape, dtype, seed=3):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    dtype)
    return x, tensor_from_numpy(np.asarray(x), "cpu")


def _close(got, want, dtype, scale=None):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(want).max() if scale is None else scale
        assert np.abs(got - want).max() <= BF16_BAR * scale


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("chunk", [None, 8], ids=["k6", "chunked"])
def test_mamba2_apply_matches_reference(chunk, dtype):
    """Output, final state and conv tail; ``chunk=None`` is prefill's K6
    route (its plain version on the CPU), 8 the training route."""
    jp, pp = _params(dtype)
    jx, px = _x((2, 23, JCFG.d_model), dtype)
    out, st = jssm.mamba2_apply(JCFG, jp, jx, chunk=8, return_state=True)
    pout, pst = ssm.mamba2_apply(PCFG, pp, px, chunk=chunk,
                                 return_state=True)
    _close(pout, out, dtype)
    _close(pst["h"], st["h"], dtype)
    _close(pst["conv"], st["conv"], dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("chunk", [8, 128])
def test_mamba2_apply_ssd_matches_reference(chunk, dtype):
    jp, pp = _params(dtype)
    jx, px = _x((2, 23, JCFG.d_model), dtype)
    out, st = jssm.mamba2_apply_ssd(JCFG, jp, jx, chunk=chunk,
                                    return_state=True)
    pout, pst = ssm.mamba2_apply_ssd(PCFG, pp, px, chunk=chunk,
                                     return_state=True)
    _close(pout, out, dtype)
    _close(pst["h"], st["h"], dtype)
    _close(pst["conv"], st["conv"], dtype)


def test_scan_and_ssd_routes_agree():
    """The two algorithms compute one function: f32 within 1e-4 x max."""
    _, pp = _params(jnp.float32)
    _, px = _x((2, 40, PCFG.d_model), jnp.float32)
    a, sa = ssm.mamba2_apply(PCFG, pp, px, return_state=True)
    b, sb = ssm.mamba2_apply_ssd(PCFG, pp, px, chunk=16, return_state=True)
    assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert float((sa["h"] - sb["h"]).abs().max()) <= \
        1e-4 * float(sb["h"].abs().max())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_mamba2_step_matches_reference(dtype):
    """Three decode steps from the prefill's state."""
    jp, pp = _params(dtype)
    jx, px = _x((2, 12, JCFG.d_model), dtype)
    _, st = jssm.mamba2_apply(JCFG, jp, jx[:, :9], chunk=8,
                              return_state=True)
    cache = jssm.SSMCache(st["h"], st["conv"])
    pcache = ssm.SSMCache(tensor_from_numpy(np.asarray(st["h"]), "cpu"),
                          tensor_from_numpy(np.asarray(st["conv"]), "cpu"))
    for t in range(9, 12):
        y, cache = jssm.mamba2_step(JCFG, jp, jx[:, t], cache)
        py, pcache = ssm.mamba2_step(PCFG, pp, px[:, t], pcache)
        _close(py, y, dtype)
        _close(pcache.h, cache.h, dtype)
        _close(pcache.conv, cache.conv, dtype)


def test_per_channel_scan_equals_the_broadcast_form():
    """K6's plain version with a per-channel decay (D,) gives the values
    of the (D, N) form on the broadcast decay, and of the JAX reference
    scan on it."""
    rng = np.random.default_rng(5)
    B, S, D, N = 2, 19, 24, 16
    dt = rng.uniform(0.01, 0.2, (B, S, D)).astype(np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    a = -np.exp(rng.standard_normal(D) * 0.3).astype(np.float32)
    a_full = np.ascontiguousarray(np.broadcast_to(a[:, None], (D, N)))
    t = [torch.from_numpy(v) for v in (dt, x, b, c)]
    y1, h1 = selective_scan_plain(*t, torch.from_numpy(a))
    y2, h2 = selective_scan_plain(*t, torch.from_numpy(a_full))
    torch.testing.assert_close(y1, y2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h1, h2, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax_scan_ref(*map(jnp.asarray, (dt, x, b, c, a_full))))
    np.testing.assert_allclose(y1.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("algo", ["scan", "ssd"])
def test_model_loss_and_grads_match_reference_f32(algo):
    """Reduced zamba2 (4 Mamba-2 blocks, the tied attention block after
    each pair) with f32 parameters: loss rel 1e-5 and every gradient leaf
    within 1e-4 x its max|g| of ``jax.value_and_grad``."""
    jmodel = jax_build(JCFG, JaxFlags(attn_chunk=16, ssm_chunk=8,
                                      ssm_algo=algo))
    params = jmodel.init(jax.random.key(0))
    head = np.random.default_rng(1).standard_normal(
        (JCFG.d_model, JCFG.vocab)) / math.sqrt(JCFG.d_model)
    params["lm_head"] = jnp.asarray(head, jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, JCFG.vocab, (2, 24)).astype(np.int32)
             for k in ("tokens", "labels")}
    (want_l, _), want_g = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    pparams = params_from_numpy(numpy_tree(params), PCFG, device="cpu")
    leaves = tree_leaves(pparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = build_model(PCFG, ModelFlags(attn_chunk=16, ssm_chunk=8,
                                           ssm_algo=algo)).loss(
        pparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_l)) <= \
        1e-5 * abs(float(want_l))
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(),
                                                         1e-30)
