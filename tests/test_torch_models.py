"""The port's model stack against the JAX model on the CPU.

Configs equal the JAX ones field by field.  For the reduced granite-3-2b
(dense GQA, K5 on prefill), falcon-mamba-7b (Mamba-1, K6 on prefill) and
h2o-danube-3-4b (sliding window, the ring-buffer cache), the JAX model's
parameters, with a seeded non-zero ``lm_head``, are carried into the port
with ``params_from_numpy``; the port's prefill logits and five decode
steps are held against the JAX model's full forward (``stack_apply``), as
``tests/test_decode_consistency.py`` holds the JAX model's own prefill and
decode: 2e-2 x max|logit| for attention, 8e-2 for the Mamba-1 scan in bf16
(its bf16 rounding differs by scan order).  With float32 parameters on
both sides the bar is 1e-4 x max|logit|.
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
from repro.models import transformer as jtr
from repro.models.model import ModelFlags as JaxFlags
from repro.models.model import build_model as jax_build
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.sharding import tree_leaves
from repro_torch.models import ssm as port_ssm
from repro_torch.models.model import build_model

B, N_DEC = 2, 5
CASES = {
    # arch: (prompt length, bf16 bar; x max|logit|)
    "granite-3-2b": (37, 2e-2),
    "falcon-mamba-7b": (37, 8e-2),
    "h2o-danube-3-4b": (70, 2e-2),   # past the reduced window of 64
}


def jax_model_params(cfg, dtype=None, head_seed=1):
    """The JAX model and its parameters with a seeded non-zero lm_head
    (std 1/sqrt(d_model)), optionally cast to ``dtype``."""
    model = jax_build(cfg, JaxFlags(attn_chunk=16, ssm_chunk=8))
    params = model.init(jax.random.key(0))
    head = np.random.default_rng(head_seed).standard_normal(
        (cfg.d_model, cfg.vocab)) / math.sqrt(cfg.d_model)
    params["lm_head"] = jnp.asarray(head, params["lm_head"].dtype)
    if dtype is not None:
        params = jax.tree.map(lambda a: a.astype(dtype), params)
    return model, params


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_equal_the_reference(name):
    port, ref = ARCHS[name], JAX_ARCHS[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.reduced().param_count() == ref.reduced().param_count()


@pytest.mark.parametrize("name", ["granite-3-2b", "falcon-mamba-7b",
                                  "h2o-danube-3-4b", "llama3.2-3b",
                                  "nemotron-4-340b", "musicgen-medium"])
def test_template_matches_reference(name):
    """Same names, shapes and dtypes as the JAX template, and at full size
    the same parameter count (no allocation).  The analytic
    ``param_count`` leaves out Mamba-1's ``conv_b`` (d_inner per layer) in
    both packages; every other family's count is exact."""
    from repro.distributed.sharding import Param as JaxParam
    is_leaf = lambda t: isinstance(t, JaxParam)  # noqa: E731
    full = get_config(name)
    n = sum(math.prod(p.shape)
            for p in tree_leaves(build_model(full).template()))
    jfull, _ = jax.tree.flatten(jax_build(JAX_ARCHS[name]).template(),
                                is_leaf=is_leaf)
    assert n == sum(math.prod(p.shape) for p in jfull)
    conv_b = full.n_layers * full.d_inner if full.has_ssm else 0
    assert n == full.param_count() + conv_b
    cfg = full.reduced()
    jtpl = jax_build(JAX_ARCHS[name].reduced()).template()
    jl, _ = jax.tree.flatten(jtpl, is_leaf=is_leaf)
    pl = tree_leaves(build_model(cfg).template())
    assert [p.shape for p in pl] == [p.shape for p in jl]
    assert [p.init for p in pl] == [p.init for p in jl]
    assert [str(p.dtype).split(".")[-1] for p in pl] == \
        [jnp.dtype(p.dtype).name for p in jl]


def test_init_is_seeded_and_follows_the_recipes():
    cfg = get_config("falcon-mamba-7b").reduced()
    m = build_model(cfg)
    a, b = m.init(3, device="cpu"), m.init(3, device="cpu")
    c = m.init(4, device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["embed"], c["embed"])
    assert not a["lm_head"].any()                      # zero-init head
    ssm = a["stack"]["layers"]["ssm"]
    n = cfg.ssm_state
    assert torch.equal(ssm["A_log"][0, 0],
                       torch.log(torch.arange(1, n + 1).float()))
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
    assert ssm["in_proj"].dtype == torch.bfloat16
    std = float(ssm["in_proj"].float().std())
    assert abs(std - 1 / math.sqrt(cfg.d_model)) < 0.1 / math.sqrt(
        cfg.d_model)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "zamba2-1.2b",
                                  "qwen2-vl-72b"])
def test_unported_families_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item M"):
        build_model(get_config(name).reduced())


def _run_both(name, dtype):
    S_pre, bar = CASES[name]
    cfg = JAX_ARCHS[name].reduced()
    jmodel, jparams = jax_model_params(cfg, dtype)
    S = S_pre + N_DEC
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, S))

    def full_forward(params, tokens):
        x, pos = jmodel._inputs({"tokens": tokens}, params)
        h, _ = jtr.stack_apply(cfg, params["stack"], x, pos, remat="none",
                               attn_chunk=16, ssm_chunk=8)
        return jmodel._logits(params, h)

    ref = np.asarray(jax.jit(full_forward)(jparams, jnp.asarray(toks)))
    pcfg = get_config(name).reduced()
    pmodel = build_model(pcfg)
    pparams = params_from_numpy(numpy_tree(jparams), pcfg, device="cpu")
    got = []
    logits, caches = pmodel.prefill(
        pparams, {"tokens": torch.from_numpy(toks[:, :S_pre])}, S)
    got.append(logits.numpy())
    for t in range(N_DEC):
        logits, caches = pmodel.decode_step(pparams, caches, {
            "token": torch.from_numpy(toks[:, S_pre + t]),
            "positions": torch.full((B,), S_pre + t, dtype=torch.long)})
        got.append(logits.numpy())
    want = ref[:, S_pre - 1:S_pre + N_DEC].transpose(1, 0, 2)
    return np.stack(got), want, bar


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_decode_match_reference_forward_bf16(name):
    got, want, bar = _run_both(name, None)
    scale = float(np.abs(want).max())
    assert scale > 1.0                               # a non-trivial head
    err = np.abs(got - want).max(axis=(1, 2))
    assert err.max() <= bar * scale, (err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_decode_match_reference_forward_f32(name):
    got, want, _ = _run_both(name, jnp.float32)
    scale = float(np.abs(want).max())
    err = np.abs(got - want).max(axis=(1, 2))
    assert err.max() <= 1e-4 * scale, (err, scale)


def test_mamba1_prefill_state_matches_reference():
    """K6's final state and the conv tail (the decode cache) against the
    JAX block's ``return_state`` outputs, in f32."""
    from repro.models import ssm as jssm
    cfg = JAX_ARCHS["falcon-mamba-7b"].reduced()
    _, jparams = jax_model_params(cfg, jnp.float32)
    p = jax.tree.map(lambda a: a[0], jparams["stack"]["layers"]["ssm"])
    x = np.random.default_rng(3).standard_normal((2, 23, cfg.d_model))
    out, st = jssm.mamba1_apply(cfg, p, jnp.asarray(x, jnp.float32),
                                chunk=8, return_state=True)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    pout, pst = port_ssm.mamba1_apply(
        get_config("falcon-mamba-7b").reduced(), pp,
        torch.from_numpy(x.astype(np.float32)), return_state=True)
    for a, b in ((pout, out), (pst["h"], st["h"]), (pst["conv"], st["conv"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_params_from_numpy_keeps_dtypes_and_refuses_mismatches():
    cfg = JAX_ARCHS["granite-3-2b"].reduced()
    _, jparams = jax_model_params(cfg)
    tree = numpy_tree(jparams)
    pcfg = get_config("granite-3-2b").reduced()
    got = params_from_numpy(tree, pcfg, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    assert got["ln_f"].dtype == torch.float32
    np.testing.assert_array_equal(
        got["embed"].float().numpy(), np.asarray(tree["embed"], np.float32))
    bad = dict(tree, ln_f=tree["ln_f"][:-1])
    with pytest.raises(ValueError, match="ln_f"):
        params_from_numpy(bad, pcfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        params_from_numpy(missing, pcfg, device="cpu")
