"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's on the CPU, at the reduced moonshot-v1-16b-a3b (4 experts, top
2) and phi3.5-moe-42b-a6.6b.

The JAX block's parameters (``init_tree`` of its template) go into the
port as they are.  ``moe_apply``'s output and aux loss are held against
the JAX ``moe_apply`` (bf16 at the JAX suite's ``atol=3e-2``, f32 within
1e-5 x max|y|), the expert ids and the capacity drops equal the JAX
dispatch's on every stream, ties go to the lower expert id as
``jax.lax.top_k`` sends them, and the checks of
``tests/test_components.py`` (dense oracle without drops, finite output
with drops, gradients reaching every parameter kind) run on the port.
``Model.loss`` and its gradients for the reduced moonshot, with the aux
term, are held against ``jax.value_and_grad`` of the JAX loss in f32.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed.sharding import init_tree
from repro.models import moe as jmoe
from repro.models.model import ModelFlags as JaxFlags
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.distributed.sharding import tree_leaves
from repro_torch.models import moe
from repro_torch.models.model import ModelFlags, build_model
from test_torch_models import numpy_tree

ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch=ARCH, **kw):
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _both(jcfg, dtype=None, seed=0):
    """The JAX block's parameters and the same as port tensors."""
    p = init_tree(jmoe.moe_template(jcfg), jax.random.key(seed))
    if dtype is not None:
        p = {k: (v if k == "router" else v.astype(dtype))
             for k, v in p.items()}
    return p, {k: tensor_from_numpy(np.asarray(v), "cpu")
               for k, v in p.items()}


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape) * 0.3
    return jnp.asarray(x, dtype), torch.from_numpy(
        np.array(jnp.asarray(x, dtype).astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _jax_routing(jcfg, p, x):
    """The JAX block's top-k ids and each group's dispatch slots."""
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    top_w, top_e = jax.lax.top_k(probs, jcfg.top_k)
    C = jmoe._capacity(jcfg, x.shape[1])
    slots = [np.asarray(jmoe._dispatch_group(jcfg, x[b], top_w[b], top_e[b],
                                             C)[1])
             for b in range(x.shape[0])]
    return np.asarray(top_e), np.stack(slots), C


CASES = [  # (arch, capacity factor, dtype, (B, S))
    (ARCH, 1.25, "bfloat16", (2, 24)),
    (ARCH, 1.0, "bfloat16", (2, 32)),
    (ARCH, 16.0, "bfloat16", (2, 24)),
    (ARCH, 1.25, "float32", (3, 17)),
    (ARCH, 1.0, "float32", (2, 32)),
    ("phi3.5-moe-42b-a6.6b", 1.25, "bfloat16", (2, 24)),
    ("phi3.5-moe-42b-a6.6b", 1.25, "float32", (2, 19)),
]


@pytest.mark.parametrize("arch,cf,dtype,shape", CASES)
def test_moe_apply_matches_reference(arch, cf, dtype, shape):
    jcfg, pcfg = _cfgs(arch, capacity_factor=cf)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp, pp = _both(jcfg, jdt)
    jx, px = _x(shape + (jcfg.d_model,), jdt)
    want, want_aux = jmoe.moe_apply(jcfg, jp, jx)
    got, got_aux = moe.moe_apply(pcfg, pp, px)
    # routing: the same expert ids, slots and drops per group
    top_e, slots, C = _jax_routing(jcfg, jp, jx)
    _, _, p_top_e = moe.route(pcfg, pp, px)
    np.testing.assert_array_equal(p_top_e.numpy(), top_e)
    assert moe._capacity(pcfg, shape[1]) == C
    _, p_slot = moe._dispatch(pcfg, p_top_e, C)
    np.testing.assert_array_equal(p_slot.numpy(), slots)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=3e-2)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(float(got_aux) - float(want_aux)) <= 1e-5 * float(want_aux)


def test_capacity_one_drops_and_stays_finite():
    """cf 1.0 overflows some experts (slots at the trash row E*C, as in
    the JAX dispatch) and the output stays finite."""
    jcfg, pcfg = _cfgs(capacity_factor=1.0)
    jp, pp = _both(jcfg, jnp.bfloat16)
    jx, px = _x((2, 32, jcfg.d_model), jnp.bfloat16)
    _, slots, C = _jax_routing(jcfg, jp, jx)
    _, _, top_e = moe.route(pcfg, pp, px)
    _, p_slot = moe._dispatch(pcfg, top_e, C)
    trash = pcfg.n_experts * C
    assert (slots == trash).any()
    np.testing.assert_array_equal(p_slot.numpy() == trash, slots == trash)
    got, _ = moe.moe_apply(pcfg, pp, px)
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_matches_dense_oracle_without_drops(dtype):
    """cf 16: no token is dropped, so the dispatch equals running every
    expert on every token (the port's and the JAX oracle)."""
    jcfg, pcfg = _cfgs(capacity_factor=16.0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp, pp = _both(jcfg, jdt)
    jx, px = _x((2, 24, jcfg.d_model), jdt)
    got, aux = moe.moe_apply(pcfg, pp, px)
    dense = moe.moe_ref_dense(pcfg, pp, px)
    want = np.asarray(jmoe.moe_ref_dense(jcfg, jp, jx).astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(),
                                   dense.float().numpy(), atol=3e-2)
        np.testing.assert_allclose(dense.float().numpy(), want, atol=3e-2)
    else:
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - dense.numpy()).max() <= 1e-5 * scale
        assert np.abs(dense.numpy() - want).max() <= 1e-5 * scale
    assert float(aux) > 0.0


def test_ties_go_to_the_lower_expert_id():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1, in that order, as ``jax.lax.top_k`` returns."""
    jcfg, pcfg = _cfgs()
    jp, pp = _both(jcfg, jnp.float32)
    jp["router"] = jnp.zeros_like(jp["router"])
    pp["router"] = torch.zeros_like(pp["router"])
    jx, px = _x((2, 8, jcfg.d_model), jnp.float32)
    top_e, slots, _ = _jax_routing(jcfg, jp, jx)
    _, top_w, p_top_e = moe.route(pcfg, pp, px)
    np.testing.assert_array_equal(p_top_e.numpy(), top_e)
    assert (p_top_e.numpy() == np.arange(pcfg.top_k)).all()
    assert torch.equal(top_w, torch.full_like(top_w, 1.0 / pcfg.top_k))


def test_gradients_flow_to_all_param_kinds():
    jcfg, pcfg = _cfgs(capacity_factor=4.0)
    _, pp = _both(jcfg, jnp.bfloat16)
    _, px = _x((1, 16, jcfg.d_model), jnp.bfloat16)
    for t in pp.values():
        t.requires_grad_(True)
    y, aux = moe.moe_apply(pcfg, pp, px)
    loss = torch.sum(torch.square(y.float())) + 0.01 * aux
    grads = torch.autograd.grad(loss, list(pp.values()))
    for k, g in zip(pp, grads):
        assert float(g.float().abs().max()) > 0, k


@pytest.mark.parametrize("cf", [1.0, 16.0])
def test_combine_is_a_fixed_order_sum(cf):
    """Each token's output is its k weighted expert rows added one by one
    in ascending expert id (the JAX scatter-add's order), bit for bit;
    a dropped entry adds zero."""
    jcfg, pcfg = _cfgs(capacity_factor=cf)
    _, pp = _both(jcfg, jnp.bfloat16)
    _, px = _x((2, 32, jcfg.d_model), jnp.bfloat16)
    _, top_w, top_e = moe.route(pcfg, pp, px)
    top_w = top_w.to(torch.bfloat16)
    C = moe._capacity(pcfg, px.shape[1])
    order, slot = moe._dispatch(pcfg, top_e, C)
    E = pcfg.n_experts
    y_pad = torch.randn(2, E * C + 1, pcfg.d_model).to(torch.bfloat16)
    y_pad[:, -1] = 0
    out = moe._combine(y_pad, slot, order, top_w)
    k = pcfg.top_k
    want = torch.zeros_like(out)
    for b in range(2):
        where = {int(order[b, j]): int(slot[b, j])
                 for j in range(slot.shape[1])}
        for t in range(px.shape[1]):
            acc = torch.zeros_like(out[b, t])
            for i in sorted(range(k), key=lambda i: int(top_e[b, t, i])):
                sl = where[t * k + i]
                w = top_w[b, t, i] if sl < E * C else torch.zeros_like(
                    top_w[b, t, i])
                acc = acc + y_pad[b, sl] * w
            want[b, t] = acc
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_model_loss_and_grads_match_reference_f32():
    """Reduced moonshot (cf 16) with f32 parameters: ``Model.loss`` (cross
    entropy + 0.01 x the layers' aux) rel 1e-5, aux rel 1e-5 and every
    gradient leaf within 1e-4 x its max|g| of ``jax.value_and_grad``."""
    jcfg, pcfg = _cfgs(capacity_factor=16.0)
    jmodel = jax_build(jcfg, JaxFlags(attn_chunk=16, ssm_chunk=8))
    params = jmodel.init(jax.random.key(0))
    head = np.random.default_rng(1).standard_normal(
        (jcfg.d_model, jcfg.vocab)) / math.sqrt(jcfg.d_model)
    params["lm_head"] = jnp.asarray(head, jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
             for k in ("tokens", "labels")}
    (want_l, want_m), want_g = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    pparams = params_from_numpy(numpy_tree(params), pcfg, device="cpu")
    leaves = tree_leaves(pparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, m = build_model(pcfg, ModelFlags(attn_chunk=16, ssm_chunk=8)).loss(
        pparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(want_m["aux"]) > 0
    loss = float(loss.detach())
    assert abs(loss - float(want_l)) <= 1e-5 * abs(float(want_l))
    assert abs(float(m["aux"]) - float(want_m["aux"])) <= \
        1e-5 * float(want_m["aux"])
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(),
                                                         1e-30)
