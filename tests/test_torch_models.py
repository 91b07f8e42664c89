"""The port's model stack against the JAX model on the CPU.

Configs equal the JAX ones field by field, and every config builds.  For
the reduced granite-3-2b (dense GQA, K5 on prefill), falcon-mamba-7b
(Mamba-1, K6 on prefill), h2o-danube-3-4b (sliding window, the ring-buffer
cache), moonshot-v1-16b-a3b (MoE at capacity factor 16, so nothing is
dropped) and phi3.5-moe-42b-a6.6b (MoE), zamba2-1.2b (Mamba-2 with the
tied attention block; the scan and the SSD route), qwen2-vl-72b (patch
embeddings and M-RoPE ids from the stub frontend) and musicgen-medium
(GELU), the JAX model's parameters, with a seeded non-zero ``lm_head``,
are carried into the port with ``params_from_numpy``; the port's prefill
logits and five decode steps are held against the JAX model's full
forward (``stack_apply``), as ``tests/test_decode_consistency.py`` holds
the JAX model's own prefill and decode, at its bars: 2e-2 x max|logit|
for attention, 8e-2 for the Mamba-1 scan and 4e-1 for zamba2 in bf16
(their bf16 rounding differs by scan order).  With float32 parameters on
both sides the bar is 1e-4 x max|logit|.

In bf16 the two MoE cases run with the JAX forward's expert choices:
across two implementations (or two attention routes of one) a bf16 ulp
in a router's input flips a near-tie between experts, and a flipped
token's output is another expert's (measured on this stream with the
port's own choices: moonshot token 13 in layers 0, 1 and 3, max error
1.48 against a bar of 0.084; phi3.5 7 routings).  The port's router then
takes the JAX ids and weighs them with its own probabilities, so the
check holds everything but the discontinuous choice; the f32 cases and
``tests/test_torch_moe.py`` hold the choice itself (ids and drops equal
the JAX dispatch's).
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
from repro.models import frontend as jfrontend
from repro.models import transformer as jtr
from repro.models.model import ModelFlags as JaxFlags
from repro.models.model import build_model as jax_build
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.distributed.sharding import tree_leaves
from repro_torch.models import ssm as port_ssm
from repro_torch.models import moe as port_moe
from repro_torch.models.model import ModelFlags, build_model

B, N_DEC = 2, 5
CASES = {
    # case: (arch, prompt length, bf16 bar x max|logit|, config overrides,
    # ssm_algo)
    "granite-3-2b": ("granite-3-2b", 37, 2e-2, {}, "scan"),
    "falcon-mamba-7b": ("falcon-mamba-7b", 37, 8e-2, {}, "scan"),
    # past the reduced window of 64
    "h2o-danube-3-4b": ("h2o-danube-3-4b", 70, 2e-2, {}, "scan"),
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", 37, 2e-2,
                            {"capacity_factor": 16.0}, "scan"),
    "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", 37, 2e-2,
                             {"capacity_factor": 16.0}, "scan"),
    "zamba2-1.2b": ("zamba2-1.2b", 37, 4e-1, {}, "scan"),
    "zamba2-1.2b-ssd": ("zamba2-1.2b", 37, 4e-1, {}, "ssd"),
    "qwen2-vl-72b": ("qwen2-vl-72b", 37, 2e-2, {}, "scan"),
    "musicgen-medium": ("musicgen-medium", 37, 2e-2, {}, "scan"),
}


def jax_model_params(cfg, dtype=None, head_seed=1, ssm_algo="scan"):
    """The JAX model and its parameters with a seeded non-zero lm_head
    (std 1/sqrt(d_model)), optionally cast to ``dtype``."""
    model = jax_build(cfg, JaxFlags(attn_chunk=16, ssm_chunk=8,
                                    ssm_algo=ssm_algo))
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


def _analytic_gap(cfg) -> int:
    """What the analytic ``param_count`` (the same in both packages)
    leaves out of the template: Mamba-1's ``conv_b`` (d_inner per layer);
    for the hybrid the tied block's MLP and each Mamba-2 block's
    ``D_skip`` (n_heads per layer), less the second norm it counts per
    layer that the block does not have.  Every other family's count is
    exact."""
    if cfg.family == "hybrid":
        nh = cfg.d_inner // cfg.ssm_head_dim
        return (3 * cfg.d_model * cfg.d_ff
                + cfg.n_layers * (nh - cfg.d_model))
    return cfg.n_layers * cfg.d_inner if cfg.has_ssm else 0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_template_matches_reference(name):
    """Same names, shapes, init recipes and dtypes as the JAX template,
    and at full size the same parameter count (no allocation)."""
    from repro.distributed.sharding import Param as JaxParam
    is_leaf = lambda t: isinstance(t, JaxParam)  # noqa: E731
    full = get_config(name)
    n = sum(math.prod(p.shape)
            for p in tree_leaves(build_model(full).template()))
    jfull, _ = jax.tree.flatten(jax_build(JAX_ARCHS[name]).template(),
                                is_leaf=is_leaf)
    assert n == sum(math.prod(p.shape) for p in jfull)
    assert n == full.param_count() + _analytic_gap(full)
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


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_config_builds(name):
    """Every config the JAX package serves builds in the port, full and
    reduced (templates and cache templates, no allocation), and the
    Mamba-2 SSD flag is accepted."""
    for cfg in (get_config(name), get_config(name).reduced()):
        for algo in ("scan", "ssd"):
            model = build_model(cfg, ModelFlags(ssm_algo=algo))
            assert tree_leaves(model.template())
            assert tree_leaves(model.cache_template(2, 16))


def _jax_expert_ids(monkeypatch):
    """Patch the JAX MoE block to record each call's top-k expert ids
    (in call order, from inside the compiled forward); returns the list
    they land in."""
    ids = []
    ref_apply = jtr.moe_mod.moe_apply

    def recording(cfg, p, x):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        jax.debug.callback(lambda e: ids.append(np.asarray(e)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return ref_apply(cfg, p, x)

    monkeypatch.setattr(jtr.moe_mod, "moe_apply", recording)
    return ids


def _forced_route(monkeypatch, ids, S_pre):
    """Make the port's router take the recorded JAX ids, layer by layer:
    the prefill's S_pre tokens, then one token per decode step; the
    weights are the port's own probabilities at those ids."""
    L = len(ids)
    calls = ([torch.from_numpy(e[:, :S_pre]).long() for e in ids]
             + [torch.from_numpy(ids[l][:, t:t + 1]).long()
                for t in range(S_pre, S_pre + N_DEC) for l in range(L)])
    it = iter(calls)

    def route(cfg, p, x):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        e = next(it)
        w = torch.gather(probs, -1, e)
        return probs, w / torch.sum(w, -1, keepdim=True), e

    monkeypatch.setattr(port_moe, "route", route)


def _run_both(name, dtype, monkeypatch=None):
    """The port's prefill and 5 decode steps, and the JAX full forward's
    logits at the same positions.  With ``monkeypatch`` an MoE model
    takes the JAX forward's expert ids."""
    arch, S_pre, bar, over, algo = CASES[name]
    cfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), **over)
    jmodel, jparams = jax_model_params(cfg, dtype, ssm_algo=algo)
    S = S_pre + N_DEC
    if cfg.input_mode == "embeddings":
        embeds = jfrontend.fake_patch_embeddings(cfg, B, S)
        if dtype is not None:
            embeds = embeds.astype(dtype)
        ids = jfrontend.mrope_position_ids(B, S, grid=4)
        batch = {"embeds": embeds, "positions": ids}
    else:
        batch = {"tokens": jnp.asarray(np.random.default_rng(7).integers(
            0, cfg.vocab, (B, S)))}

    def full_forward(params, batch):
        x, pos = jmodel._inputs(batch, params)
        h, _ = jtr.stack_apply(cfg, params["stack"], x, pos, remat="none",
                               attn_chunk=16, ssm_chunk=8, ssm_algo=algo)
        return jmodel._logits(params, h)

    pin = monkeypatch is not None and cfg.is_moe
    if pin:
        ids = _jax_expert_ids(monkeypatch)
    ref = np.asarray(jax.jit(full_forward)(jparams, batch))
    if pin:
        jax.effects_barrier()
        assert len(ids) == cfg.n_layers
        _forced_route(monkeypatch, ids, S_pre)
    pcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    pmodel = build_model(pcfg, ModelFlags(ssm_algo=algo, ssm_chunk=8))
    pparams = params_from_numpy(numpy_tree(jparams), pcfg, device="cpu")
    pb = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in batch.items()}
    got = []
    logits, caches = pmodel.prefill(
        pparams, {k: v[:, :S_pre] for k, v in pb.items()}, S)
    got.append(logits.numpy())
    for t in range(N_DEC):
        step = {"positions": torch.full((B,), S_pre + t, dtype=torch.long)}
        if cfg.input_mode == "embeddings":
            step["embed"] = pb["embeds"][:, S_pre + t]
            step["rope_positions"] = pb["positions"][:, S_pre + t]
        else:
            step["token"] = pb["tokens"][:, S_pre + t]
        logits, caches = pmodel.decode_step(pparams, caches, step)
        got.append(logits.numpy())
    want = ref[:, S_pre - 1:S_pre + N_DEC].transpose(1, 0, 2)
    return np.stack(got), want, bar


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_decode_match_reference_forward_bf16(name, monkeypatch):
    got, want, bar = _run_both(name, None, monkeypatch)
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
