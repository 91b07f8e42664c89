"""The port's training path against the JAX package's on the CPU.

Reduced granite-3-2b (dense GQA), falcon-mamba-7b (Mamba-1) and
h2o-danube-3-4b (sliding window, sequences past the reduced window of 64)
with the JAX model's parameters carried over by ``params_from_numpy``:
``Model.loss`` and its gradients against ``jax.value_and_grad`` of the JAX
model's loss, the chunked vocab loss, the three remat modes, AdamW and the
LR schedule, ``make_train_step`` over 8 steps (with and without
microbatches) from one state, and the training route's two cores,
``chunked_selective_scan`` and ``attention_core``, against the JAX
functions and their sequential / naive forms (as
``tests/test_components.py`` holds the JAX ones).  Each bar has the gap
measured on the CPU beside it.
"""
from __future__ import annotations

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
from repro.models import ssm as jssm
from repro.models.attention import attention_core as jax_attention_core
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
from repro_torch.models import attention as pattn
from repro_torch.models import ssm as pssm
from repro_torch.models.model import ModelFlags, build_model
from repro_torch.train import optimizer as popt
from repro_torch.train.train_step import make_train_step
from test_torch_models import numpy_tree

B = 2
CASES = {
    # arch: (sequence length, attention chunk); ssm chunk 8 throughout
    "granite-3-2b": (40, 16),
    "falcon-mamba-7b": (40, 16),
    "h2o-danube-3-4b": (80, 32),     # past the reduced window of 64
}



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are small: on one intra-op thread they run
    as fast, and the test workers running beside this file (pytest-xdist)
    do not wait on each other's thread barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _setup(name, dtype=None, head_seed=1, loss_chunk=0):
    """The JAX model and parameters (a seeded lm_head unless ``head_seed``
    is None, cast to ``dtype``), a token batch, the port's config and
    flags."""
    S, ac = CASES[name]
    cfg = JAX_ARCHS[name].reduced()
    jmodel = jax_build(cfg, JaxFlags(attn_chunk=ac, ssm_chunk=8,
                                     loss_chunk=loss_chunk))
    params = jmodel.init(jax.random.key(0))
    if head_seed is not None:
        head = np.random.default_rng(head_seed).standard_normal(
            (cfg.d_model, cfg.vocab)) / math.sqrt(cfg.d_model)
        params["lm_head"] = jnp.asarray(head, params["lm_head"].dtype)
    if dtype is not None:
        params = jax.tree.map(lambda a: a.astype(dtype), params)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    flags = ModelFlags(attn_chunk=ac, ssm_chunk=8, loss_chunk=loss_chunk)
    return jmodel, params, batch, get_config(name).reduced(), flags


def _jax_value_and_grad(jmodel, params, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _port_value_and_grad(pcfg, flags, tree, batch):
    params = params_from_numpy(tree, pcfg, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = build_model(pcfg, flags).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert float(metrics["aux"]) == 0.0
    assert float(metrics["ce"].detach()) == loss
    return loss, [g.float().numpy() for g in grads]


def _leaf_gaps(got, want):
    """Per leaf: max |got - want| / max |want| (0 where both are 0)."""
    out = []
    for a, b in zip(got, want):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        out.append(err / scale if scale else err)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_match_reference_f32(name):
    """f32 parameters: loss rel 1e-5 (measured <= 2.2e-7), every leaf's
    gradient within 1e-4 x its max|g| (measured <= 2.3e-6)."""
    jmodel, params, batch, pcfg, flags = _setup(name, jnp.float32)
    want_l, want_g = _jax_value_and_grad(jmodel, params, batch)
    got_l, got_g = _port_value_and_grad(pcfg, flags, numpy_tree(params),
                                        batch)
    assert abs(got_l - want_l) <= 1e-5 * abs(want_l)
    assert max(_leaf_gaps(got_g, want_g)) <= 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_step0_loss_is_ln_vocab_and_grads_match(name):
    """The model's own init (bf16, zero-init untied head): the step-0 loss
    is ln V on both sides to f32 rounding (measured 7.4e-8 relative in the
    port, 3.1e-7 in the reference; bar 1e-6), and the gradients (only the
    head's is non-zero: the hidden state times the softmax error) within
    2e-2 x max|g| of the reference's (measured 8.2e-3 granite, 1.3e-2
    danube, 1.9e-2 falcon)."""
    bar = 2e-2
    jmodel, params, batch, pcfg, flags = _setup(name, head_seed=None)
    want_l, want_g = _jax_value_and_grad(jmodel, params, batch)
    got_l, got_g = _port_value_and_grad(pcfg, flags, numpy_tree(params),
                                        batch)
    ln_v = math.log(pcfg.vocab)
    assert abs(want_l - ln_v) <= 1e-6 * ln_v
    assert abs(got_l - ln_v) <= 1e-6 * ln_v
    assert max(_leaf_gaps(got_g, want_g)) <= bar


@pytest.mark.parametrize("name,bar", [("falcon-mamba-7b", 8e-2),
                                      ("granite-3-2b", 4e-2),
                                      ("h2o-danube-3-4b", 4e-2)])
def test_bf16_grads_as_close_to_f32_as_the_reference(name, bar):
    """A seeded head, bf16 parameters: every gradient leaf within ``bar``
    x max|g| of the f32 gradient at the same (bf16-valued) parameters.
    The bf16 rounding alone moves the JAX package's own gradients by up to
    2.2 % (granite), 1.7 % (danube) and 4.3 % (falcon; its scan, as in the
    serving bars) of max|g|; the port's measured 2.1, 1.9 and 2.6 %."""
    jmodel, params, batch, pcfg, flags = _setup(name)
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    _, truth = _jax_value_and_grad(jmodel, params32, batch)
    _, got_g = _port_value_and_grad(pcfg, flags, numpy_tree(params), batch)
    assert max(_leaf_gaps(got_g, truth)) <= bar


@pytest.mark.parametrize("dtype", [jnp.float32, None],
                         ids=["f32", "bf16"])
def test_loss_chunk_equals_unchunked_and_reference(dtype):
    """loss_chunk 13 (four chunks, the last padded and masked) against
    the unchunked loss (the reference's bar, rel 1e-3; measured 7.2e-8)
    and against the JAX package's chunked loss (rel 1e-5 in f32, measured
    7.2e-8; rel 1e-3 in bf16, measured 1.4e-4), gradients in f32 within
    1e-4 x max|g| (measured 1.7e-6)."""
    jmodel, params, batch, pcfg, flags = _setup("granite-3-2b", dtype,
                                                loss_chunk=13)
    want_l, want_g = _jax_value_and_grad(jmodel, params, batch)
    tree = numpy_tree(params)
    got_l, got_g = _port_value_and_grad(pcfg, flags, tree, batch)
    flat_l, _ = _port_value_and_grad(
        pcfg, ModelFlags(attn_chunk=flags.attn_chunk, ssm_chunk=8), tree,
        batch)
    assert got_l == pytest.approx(flat_l, rel=1e-3)
    if dtype is None:
        assert got_l == pytest.approx(want_l, rel=1e-3)
    else:
        assert got_l == pytest.approx(want_l, rel=1e-5)
        assert max(_leaf_gaps(got_g, want_g)) <= 1e-4


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_modes_bitwise_equal(name, remat):
    """On the CPU a recomputed forward rounds as the first one did, so
    each remat mode gives the same loss and gradients, bit for bit, as
    ``none`` (bf16 parameters, a seeded head)."""
    _, params, batch, pcfg, flags = _setup(name)
    tree = numpy_tree(params)
    base = ModelFlags(attn_chunk=flags.attn_chunk, ssm_chunk=8,
                      remat="none")
    l0, g0 = _port_value_and_grad(pcfg, base, tree, batch)
    l1, g1 = _port_value_and_grad(
        pcfg, ModelFlags(attn_chunk=flags.attn_chunk, ssm_chunk=8,
                         remat=remat), tree, batch)
    assert l0 == l1
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)


def test_unknown_remat_refuses():
    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg, ModelFlags(remat="everything"))
    params = model.init(0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat"):
        model.loss(params, {"tokens": toks, "labels": toks})


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------


def _opt_inputs(seed):
    """A tree with bf16 and f32 leaves of 1-3 dims (the stacked norm
    scales and A_log are decayed: ndim >= 2), grads, moments."""
    g = np.random.default_rng(seed)
    shapes = {"a": (3, 17), "b": {"c": (2, 4, 5), "d": (9,)}, "e": (4, 6)}
    dtypes = {"a": "bfloat16", "b": {"c": "float32", "d": "float32"},
              "e": "float32"}

    def tree(fn, t=shapes, d=dtypes):
        if isinstance(t, dict):
            return {k: tree(fn, t[k], d[k]) for k in t}
        return fn(t, d)

    params = tree(lambda s, d: g.standard_normal(s).astype(np.float32))
    grads = tree(lambda s, d: (g.standard_normal(s) * 3).astype(np.float32))
    mu = tree(lambda s, d: (g.standard_normal(s) * 0.1).astype(np.float32))
    nu = tree(lambda s, d: g.random(s).astype(np.float32))
    return params, grads, mu, nu, tree(lambda s, d: d)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("step,clip", [(0, 1.0), (5, 1.0), (150, 1.0),
                                       (150, 100.0)])
def test_adamw_update_matches_reference(step, clip):
    """New parameters, moments, grad norm and lr rel 1e-6 of the JAX
    package's, bf16 leaves included, written into the given tensors (measured: parameters, moments and lr
    bitwise equal, the grad norm within 1 ulp: a sum order)."""
    params, grads, mu, nu, dts = _opt_inputs(step)
    jcfg = jopt.AdamWConfig(lr_peak=1e-2, warmup_steps=10, total_steps=200,
                            clip_norm=clip)
    pcfg = popt.AdamWConfig(lr_peak=1e-2, warmup_steps=10, total_steps=200,
                            clip_norm=clip)

    def cast_j(t, d):
        if isinstance(t, dict):
            return {k: cast_j(t[k], d[k]) for k in t}
        return jnp.asarray(t, d)

    def cast_p(t, d):
        if isinstance(t, dict):
            return {k: cast_p(t[k], d[k]) for k in t}
        return torch.tensor(t).to(getattr(torch, d))

    f32 = jax.tree.map(lambda _: "float32", dts)
    jp, jm, jo = jopt.adamw_update(
        jcfg, cast_j(params, dts), cast_j(grads, f32),
        {"mu": cast_j(mu, f32), "nu": cast_j(nu, f32)},
        jnp.asarray(step, jnp.int32))
    p_in = cast_p(params, dts)
    m_in = {"mu": cast_p(mu, f32), "nu": cast_p(nu, f32)}
    leaves_in = _flat(p_in) + _flat(m_in)
    pp, pm, po = popt.adamw_update(pcfg, p_in, cast_p(grads, f32), m_in,
                                   torch.tensor(step, dtype=torch.int32))
    # the state is updated in place (donated), as the train step relies on
    assert all(a is b for a, b in zip(_flat(pp) + _flat(pm), leaves_in))
    pairs = list(zip(_flat(pp), _flat(jp))) + list(
        zip(_flat(pm), _flat(jm)))
    for a, b in pairs:
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=1e-6)
    for k in ("grad_norm", "lr"):
        assert float(po[k]) == pytest.approx(float(jo[k]), rel=1e-6)
    assert [t.dtype for t in _flat(pp)] == [
        torch.bfloat16, torch.float32, torch.float32, torch.float32]


def test_opt_template_and_init_opt_mirror_the_parameters():
    """f32 zero moments with the parameters' shapes, bf16 leaves too."""
    model = build_model(get_config("falcon-mamba-7b").reduced())
    tpl = model.template()
    mt = popt.opt_template(tpl)
    opt = popt.init_opt(model.init(0, device="cpu"))
    for k in ("mu", "nu"):
        for p, t, z in zip(tree_leaves(tpl), tree_leaves(mt[k]),
                           tree_leaves(opt[k])):
            assert t.shape == p.shape == tuple(z.shape)
            assert t.dtype == z.dtype == torch.float32
            assert t.init == "zeros" and not z.any()


def test_lr_schedule_matches_reference():
    """rel 1e-6 (measured: one step of 111 off by 1 ulp)."""
    steps = np.arange(0, 260, 7, dtype=np.int32)
    for kw in (dict(lr_peak=3e-4, warmup_steps=100, total_steps=10_000),
               dict(lr_peak=3e-3, warmup_steps=2, total_steps=8),
               dict(lr_peak=1e-3, warmup_steps=0, total_steps=50)):
        want = np.asarray(jopt.lr_at(jopt.AdamWConfig(**kw),
                                     jnp.asarray(steps)))
        got = popt.lr_at(popt.AdamWConfig(**kw),
                         torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step over several steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,micro", [("granite-3-2b", 1),
                                        ("granite-3-2b", 2),
                                        ("falcon-mamba-7b", 2),
                                        ("h2o-danube-3-4b", 1)])
def test_train_step_matches_reference_over_8_steps(name, micro):
    """8 AdamW steps from one state (f32 parameters, a seeded head) on the
    copy task: every step's loss and grad norm rel 1e-4 (measured <=
    4.3e-7 and 1.9e-6), the final parameters within 1e-4 of each leaf's
    L2 norm (measured <= 5.9e-6; elementwise AdamW turns rounding-level
    gradient differences near 0 into up to lr-sized steps, 3.3e-4 x
    max|p| in the embedding), the step counter equal; the port reads its
    batches through its own pipeline, byte-equal to the reference's."""
    S, _ = CASES[name]
    jmodel, params, _, pcfg, flags = _setup(name, jnp.float32)
    kw = dict(lr_peak=3e-3, warmup_steps=2, total_steps=8)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt.AdamWConfig(**kw),
                                        microbatches=micro))
    jstate = JaxState.create(params)
    pstate = train_state_from_numpy(
        jax.tree.map(np.asarray, {"params": jstate.params,
                                  "opt": jstate.opt, "step": jstate.step}),
        pcfg, device="cpu")
    pstep = make_train_step(build_model(pcfg, flags),
                            popt.AdamWConfig(**kw), microbatches=micro)
    jcfg = JaxDataConfig(JAX_ARCHS[name].reduced(), 4, S, seed=5)
    dcfg = DataConfig(pcfg, 4, S, seed=5)
    jps, pps = JaxPipelineState(5, 0), PipelineState(5, 0)
    for _ in range(8):
        jps, jb = jax_host_batch(jcfg, jps)
        pps, pb = device_batch(dcfg, pps, "cpu")
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in jb.items()})
        pstate, pmet = pstep(pstate, pb)
        assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-4)
        assert float(pmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4)
    got = train_state_to_numpy(pstate)
    assert int(got["step"]) == int(jstate.step) == 8
    want = jax.tree.leaves(jstate.params)
    for a, b in zip(_flat(got["params"]), want):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the training route's cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(1, 4), (13, 4), (37, 16), (64, 64),
                                     (70, 16), (5, 64)])
def test_chunked_scan_matches_sequential_and_reference(s, chunk):
    """h_all and h_last against the sequential recurrence (the reference
    suite's bar, atol 1e-4) and against the JAX function (atol 1e-5;
    measured 4.8e-7), and the gradients of a loss through it against autograd
    through the sequential loop (1e-5 x max|g|)."""
    rng = np.random.default_rng(s * 100 + chunk)
    Bn, M, N = 2, 3, 4
    dA = (rng.random((Bn, s, M, N)) * 0.9 + 0.05).astype(np.float32)
    dBx = rng.standard_normal((Bn, s, M, N)).astype(np.float32)
    h0 = rng.standard_normal((Bn, M, N)).astype(np.float32)
    w = rng.standard_normal((Bn, s, M, N)).astype(np.float32)
    ja, jl = jssm.chunked_selective_scan(jnp.asarray(dA), jnp.asarray(dBx),
                                         jnp.asarray(h0), chunk=chunk)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (dA, dBx, h0)]
    pa, pl = pssm.chunked_selective_scan(*ins, chunk=chunk)
    np.testing.assert_allclose(pa.detach().numpy(), np.asarray(ja),
                               atol=1e-5)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               atol=1e-5)
    h = ins[2]
    seq = []
    for t in range(s):
        h = ins[0][:, t] * h + ins[1][:, t]
        seq.append(h)
    seq = torch.stack(seq, 1)
    np.testing.assert_allclose(pa.detach().numpy(), seq.detach().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(pl.detach().numpy(), h.detach().numpy(),
                               atol=1e-4)
    wt = torch.from_numpy(w)
    got = torch.autograd.grad((pa * wt).sum() + pl.sum(), ins)
    want = torch.autograd.grad((seq * wt).sum() + h.sum(), ins)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _naive_attention(q, k, v, window=0, q_offset=0):
    B_, S, K, G, hd = q.shape
    T = k.shape[1]
    s = torch.einsum("bskgh,btkh->bkgst", q, k) * hd ** -0.5
    rows = torch.arange(S)[:, None] + q_offset
    cols = torch.arange(T)[None, :]
    mask = cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = torch.where(mask, s, -1e30)
    return torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, -1), v)


@pytest.mark.parametrize("chunk", [7, 16, 64, 100])
@pytest.mark.parametrize("window", [0, 24])
def test_attention_core_matches_naive_and_reference(chunk, window):
    """As the reference suite's chunked-vs-naive test (atol 2e-5), and
    against the JAX ``attention_core`` (atol 2e-5; measured 3.6e-7)."""
    rng = np.random.default_rng(chunk + window)
    Bn, S, K, G, hd = 2, 50, 2, 2, 16
    q = rng.standard_normal((Bn, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((Bn, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((Bn, S, K, hd)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = pattn.attention_core(*t, window=window, chunk=chunk).numpy()
    np.testing.assert_allclose(
        got, _naive_attention(*t, window=window).numpy(), atol=2e-5)
    want = jax_attention_core(*(jnp.asarray(x) for x in (q, k, v)),
                              window=window, chunk=chunk)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def test_attention_core_query_offset():
    """Queries at positions 30..49 against 50 keys (``q_offset``), with
    and without a window, against the naive form and the JAX function."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((1, 20, 2, 3, 8)).astype(np.float32)
    k = rng.standard_normal((1, 50, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 50, 2, 8)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for window in (0, 12):
        got = pattn.attention_core(*t, window=window, q_offset=30,
                                   chunk=8).numpy()
        np.testing.assert_allclose(
            got, _naive_attention(*t, window, 30).numpy(), atol=2e-5)
        want = jax_attention_core(*(jnp.asarray(x) for x in (q, k, v)),
                                  window=window, q_offset=30, chunk=8)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
