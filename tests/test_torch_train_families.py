"""The training path of the MoE, hybrid and VLM families against the JAX
package's on the CPU.

Reduced moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b (4 experts, top 2,
capacity factor 16: no drops), zamba2-1.2b through both Mamba-2 routes
(``scan``: the chunked scan; ``ssd``: the chunk-matmul form) and
qwen2-vl-72b (patch embeddings and M-RoPE positions from both packages'
stub frontends, byte for byte the same), each with the JAX model's
parameters carried over by ``params_from_numpy``: ``Model.loss`` and its
gradients against ``jax.value_and_grad`` of the JAX loss in f32 (phi3.5
and qwen2-vl; the other two families' are in ``tests/test_torch_moe.py``
and ``tests/test_torch_mamba2.py``), 8 AdamW
steps of ``make_train_step`` against the JAX step from one state, the
remat modes bit for bit, and the MoE backward under
``torch.use_deterministic_algorithms`` (which raises on an op with no
deterministic form) bit for bit the default mode's.  Each bar has the gap
measured on the CPU beside it.
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
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import PipelineState as JaxPipelineState
from repro.data.pipeline import host_batch as jax_host_batch
from repro.models import frontend as jfrontend
from repro.models.model import ModelFlags as JaxFlags
from repro.models.model import build_model as jax_build
from repro.train import optimizer as jopt
from repro.train.train_step import TrainState as JaxState
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data.pipeline import DataConfig, PipelineState, device_batch
from repro_torch.distributed.sharding import tree_leaves
from repro_torch.models import frontend
from repro_torch.models.model import ModelFlags, build_model
from repro_torch.train import optimizer as popt
from repro_torch.train.train_step import make_train_step
from test_torch_models import numpy_tree

B = 2
FAMILIES = {
    # id: (arch, config overrides, flags, sequence length); attention
    # chunk 16 and scan chunk 8 throughout (28 tokens: the last scan / SSD
    # chunk is padded)
    "moonshot": ("moonshot-v1-16b-a3b", {"capacity_factor": 16.0}, {}, 24),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 16.0}, {},
                   24),
    "zamba2-scan": ("zamba2-1.2b", {}, {"ssm_algo": "scan"}, 28),
    "zamba2-ssd": ("zamba2-1.2b", {}, {"ssm_algo": "ssd"}, 28),
    "qwen2-vl": ("qwen2-vl-72b", {}, {}, 24),
}
MOE = ("moonshot", "phi3.5-moe")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(fam):
    arch, over, _, _ = FAMILIES[fam]
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _flags(fam, **kw):
    return ModelFlags(attn_chunk=16, ssm_chunk=8, **FAMILIES[fam][2], **kw)


def _batch(cfg, S, seed, dtype=np.float32):
    """A numpy batch: tokens and labels, or (VLM) the reference frontend's
    patch embeddings (as ``dtype``) and M-RoPE ids with labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.input_mode != "embeddings":
        return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32), "labels": labels}
    emb = np.asarray(jfrontend.fake_patch_embeddings(cfg, B, S, seed=seed)
                     .astype(jnp.float32)).astype(dtype)
    pos = np.asarray(jfrontend.mrope_position_ids(B, S, grid=4))
    return {"embeds": emb, "positions": pos, "labels": labels}


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v))
            for k, v in batch.items()}


def _setup(fam, dtype=jnp.float32):
    """The JAX model and parameters (a seeded head; every leaf cast to
    ``dtype``, or with None the model's own dtypes: bf16, the router and
    norms f32), a numpy batch, the port's config."""
    jcfg, pcfg = _cfgs(fam)
    S = FAMILIES[fam][3]
    jmodel = jax_build(jcfg, JaxFlags(attn_chunk=16, ssm_chunk=8,
                                      **FAMILIES[fam][2]))
    params = jmodel.init(jax.random.key(0))
    head = np.random.default_rng(1).standard_normal(
        (jcfg.d_model, jcfg.vocab)) / math.sqrt(jcfg.d_model)
    params["lm_head"] = jnp.asarray(head, params["lm_head"].dtype)
    if dtype is not None:
        params = jax.tree.map(lambda a: a.astype(dtype), params)
    return jmodel, params, _batch(jcfg, S, 3), pcfg


def _port_value_and_grad(pcfg, flags, tree, batch, emb=torch.float32):
    """(loss, aux, gradients as f32 numpy; a zero gradient for a leaf the
    loss does not use: qwen2-vl's token table), the embeddings as
    ``emb``."""
    params = params_from_numpy(tree, pcfg, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    b = _to_torch(batch)
    if "embeds" in b:
        b["embeds"] = b["embeds"].to(emb)
    loss, metrics = build_model(pcfg, flags).loss(params, b)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (float(loss.detach()), float(metrics["aux"].detach()),
            [np.zeros(t.shape, np.float32) if g is None
             else g.float().numpy() for t, g in zip(leaves, grads)])


def _leaf_gaps(got, want):
    out = []
    for a, b in zip(got, want):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        out.append(err / scale if scale else err)
    return out


@pytest.mark.parametrize("fam", ["phi3.5-moe", "qwen2-vl"])
def test_loss_and_grads_match_reference_f32(fam):
    """f32 parameters: ``Model.loss`` (cross-entropy + 0.01 x the MoE
    layers' aux) rel 1e-5 and aux rel 1e-5 (measured <= 1.1e-7), every
    gradient leaf within 1e-4 x its max|g| of ``jax.value_and_grad``
    (measured <= 1.8e-6), the same leaves non-zero on both sides (all but
    qwen2-vl's token table, which embeddings bypass).  moonshot and
    zamba2 (scan, SSD) are held so at the same bars by
    ``tests/test_torch_moe.py`` and ``tests/test_torch_mamba2.py``."""
    jmodel, params, batch, pcfg = _setup(fam)
    (want_l, want_m), want_g = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want_g = [np.asarray(g, np.float32) for g in jax.tree.leaves(want_g)]
    got_l, got_aux, got_g = _port_value_and_grad(
        pcfg, _flags(fam), numpy_tree(params), batch)
    assert abs(got_l - float(want_l)) <= 1e-5 * abs(float(want_l))
    want_aux = float(want_m["aux"])
    assert (want_aux > 0) == (fam in MOE)
    assert abs(got_aux - want_aux) <= 1e-5 * want_aux
    assert len(got_g) == len(want_g)
    # every leaf has a gradient, but the token table of a model fed
    # embeddings
    used = [float(np.abs(g).max()) > 0 for g in want_g]
    assert used == [float(np.abs(g).max()) > 0 for g in got_g]
    assert sum(used) == len(used) - (fam == "qwen2-vl")
    assert max(_leaf_gaps(got_g, want_g)) <= 1e-4


# x max|g| of a leaf: the largest gap measured between the two packages'
# gradients (1.8e-6, test_loss_and_grads_match_reference_f32 and
# tests/test_torch_{moe,mamba2}.py), rounded up; a gradient within it of
# zero may have either sign in the port
GRAD_NOISE = 2e-6


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_train_step_matches_reference_over_8_steps(fam):
    """8 AdamW steps from one state (f32 parameters, a seeded head): every
    step's loss and grad norm rel 1e-4 (measured <= 5.0e-7 and 5.5e-6),
    the final parameters within 1e-4 of each leaf's L2 norm, the step
    counter equal.  Token families read their batches through each
    package's pipeline (byte-equal); qwen2-vl takes a fresh frontend batch
    a step.

    AdamW divides each element's first moment by the root of its second,
    so an element whose gradient is near zero moves by up to lr whatever
    its size, in the direction of its sign.  Where the reference's
    gradient at some step is non-zero but within ``GRAD_NOISE`` x max|g|
    of its leaf, the sign is rounding's, and the element is left out of
    the parameter bar; at most 2e-2 of a leaf may be (measured <= 7.2e-3,
    the MoE experts), and the assertion shows the first few of their
    gradients.  Measured parameter gaps on the rest: <= 6.0e-6.  Without
    the rule zamba2's scan route gave 2.38e-4 in its token table: at step
    5 one element's reference gradient, ~1e-8 against the leaf's max|g|
    ~1e-2, had the opposite sign in the port, and AdamW turned it into a
    9.6e-4 step; the reference's jitted step against the same step op by
    op misses the 1e-4 bar on this data too (1.07e-4,
    ``tools/ref_step_jitter.py``)."""
    jmodel, params, _, pcfg = _setup(fam)
    jcfg, _ = _cfgs(fam)
    S = FAMILIES[fam][3]
    kw = dict(lr_peak=3e-3, warmup_steps=2, total_steps=8)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt.AdamWConfig(**kw)))
    jgrad = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))
    jstate = JaxState.create(params)
    pstate = train_state_from_numpy(
        jax.tree.map(np.asarray, {"params": jstate.params,
                                  "opt": jstate.opt, "step": jstate.step}),
        pcfg, device="cpu")
    pstep = make_train_step(build_model(pcfg, _flags(fam)),
                            popt.AdamWConfig(**kw))
    vlm = jcfg.input_mode == "embeddings"
    jd, pd = JaxDataConfig(jcfg, 4, S, seed=5), DataConfig(pcfg, 4, S,
                                                           seed=5)
    jps, pps = JaxPipelineState(5, 0), PipelineState(5, 0)
    near0 = [np.zeros(np.shape(a), bool)
             for a in jax.tree.leaves(jstate.params)]
    small = [[] for _ in near0]
    for step in range(8):
        if vlm:
            jb = _batch(jcfg, S, 10 + step)
            pb = _to_torch(jb)
        else:
            jps, jb = jax_host_batch(jd, jps)
            pps, pb = device_batch(pd, pps, "cpu")
        jb = {k: jnp.asarray(v) for k, v in jb.items()}
        for i, g in enumerate(jax.tree.leaves(jgrad(jstate.params, jb))):
            g = np.asarray(g)
            hit = (g != 0) & (np.abs(g) <= GRAD_NOISE * np.abs(g).max())
            near0[i] |= hit
            small[i] += [(step, float(x), float(np.abs(g).max()))
                         for x in g[hit][:3]]
        jstate, jmet = jstep(jstate, jb)
        pstate, pmet = pstep(pstate, pb)
        assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-4)
        assert float(pmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4)
    got = train_state_to_numpy(pstate)
    assert int(got["step"]) == int(jstate.step) == 8
    for a, b, m, sm in zip(_flat(got["params"]),
                           jax.tree.leaves(jstate.params), near0, small):
        b = np.asarray(b)
        # (step, gradient, the leaf's max|g|) of the first few left out
        assert m.sum() <= 2e-2 * m.size, (m.sum(), m.size, sm)
        assert (np.linalg.norm((a - b)[~m])
                <= 1e-4 * np.linalg.norm(b)), (m.sum(), sm)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_remat_modes_bitwise_equal(fam, remat):
    """The model's own dtypes (bf16 weights), a seeded head: each remat
    mode gives the loss and gradients of ``none`` bit for bit (a recomputed forward on the CPU
    rounds as the first one did; the MoE's routing is recomputed too)."""
    _, params, batch, pcfg = _setup(fam, None)
    tree = numpy_tree(params)
    l0, a0, g0 = _port_value_and_grad(pcfg, _flags(fam, remat="none"), tree,
                                      batch, torch.bfloat16)
    l1, a1, g1 = _port_value_and_grad(pcfg, _flags(fam, remat=remat), tree,
                                      batch, torch.bfloat16)
    assert (l0, a0) == (l1, a1)
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fam", MOE)
def test_moe_backward_runs_under_deterministic_algorithms(fam):
    """The MoE families' loss and gradients under
    ``torch.use_deterministic_algorithms(True)`` (which raises on an op
    with no deterministic form) equal the default mode's bit for bit."""
    _, params, batch, pcfg = _setup(fam, None)
    tree = numpy_tree(params)
    l0, a0, g0 = _port_value_and_grad(pcfg, _flags(fam), tree, batch)
    torch.use_deterministic_algorithms(True)
    try:
        l1, a1, g1 = _port_value_and_grad(pcfg, _flags(fam), tree, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    assert (l0, a0) == (l1, a1)
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)


def test_vlm_batch_is_the_reference_frontend_bytes():
    """The qwen2-vl training batch built from the port's frontend equals
    the reference frontend's byte for byte (bf16 embeddings, int32 ids)."""
    jcfg, pcfg = _cfgs("qwen2-vl")
    S = FAMILIES["qwen2-vl"][3]
    emb = frontend.fake_patch_embeddings(pcfg, B, S, seed=3, device="cpu")
    want = np.asarray(jfrontend.fake_patch_embeddings(jcfg, B, S, seed=3)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(emb.float().numpy(), want)
    pos = frontend.mrope_position_ids(B, S, grid=4, device="cpu")
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jfrontend.mrope_position_ids(B, S, grid=4)))
