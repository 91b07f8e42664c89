"""The port's serving path against the JAX one on the CPU: the slot
engine's greedy tokens equal the JAX ``ServeEngine``'s with the same
parameters (carried over by ``params_from_numpy``, float32, with a seeded
non-zero ``lm_head`` so the tokens are not all 0; float32 keeps the two
argmaxes from parting on a bf16 near-tie) for the dense, Mamba-1, SWA,
MoE (capacity factor 16, so no token overflows) and hybrid families, EOS
sampled at prefill ends its slot at once in both, a second ``generate``
on one engine (its captured steps replayed, on the CPU their static
buffers reused) equals a fresh engine's, and the serve launcher places
the replica on the reference's pod and serves on the CPU.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as port_serve
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine
from test_torch_models import jax_model_params, numpy_tree
from test_torch_reference import load_reference

SLOTS, P, MAX_NEW = 4, 9, 6


# config overrides per arch: the MoE at capacity factor 16 (no token
# overflows its expert, so the tokens do not hang on the drop order)
OVERRIDES = {"moonshot-v1-16b-a3b": {"capacity_factor": 16.0}}


def _engines(name):
    over = OVERRIDES.get(name, {})
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    from repro.configs import ARCHS
    jmodel, jparams = jax_model_params(
        dataclasses.replace(ARCHS[name].reduced(), **over), jnp.float32,
        head_seed=5)
    kw = dict(max_seq=P + MAX_NEW + 8, batch_slots=SLOTS)
    jeng = JaxEngine(jmodel, jparams, **kw)
    peng = ServeEngine(build_model(cfg),
                       params_from_numpy(numpy_tree(jparams), cfg, "cpu"),
                       device="cpu", **kw)
    prompts = np.random.default_rng(9).integers(
        2, cfg.vocab, (SLOTS, P)).astype(np.int32)
    return jeng, peng, prompts


@pytest.mark.parametrize("name", ["granite-3-2b", "falcon-mamba-7b",
                                  "h2o-danube-3-4b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b"])
def test_greedy_tokens_equal_reference_engine(name):
    jeng, peng, prompts = _engines(name)
    want = [r.tokens for r in jeng.generate(prompts, MAX_NEW)]
    got = peng.generate(prompts, MAX_NEW)
    assert [r.tokens for r in got] == want
    assert len({t for toks in want for t in toks}) > 1   # not all one token
    assert all(r.prompt_len == P and r.steps == MAX_NEW for r in got)
    t = peng.timings
    assert t["prefills"] == 1 and t["decode_steps"] == MAX_NEW - 1


@pytest.mark.parametrize("name", ["granite-3-2b", "falcon-mamba-7b"])
def test_second_generate_equals_a_fresh_engine(name):
    """The second ``generate`` reuses the first's captured steps (no new
    signature) and the caches they wrote; its tokens are a fresh
    engine's.  A new prompt length adds one prefill and one decode
    signature."""
    _, peng, prompts = _engines(name)
    _, fresh, _ = _engines(name)
    peng.generate(prompts[::-1].copy(), MAX_NEW)
    assert peng.timings["captures"] == 2
    again = [r.tokens for r in peng.generate(prompts, MAX_NEW)]
    assert peng.timings["captures"] == 2
    assert again == [r.tokens for r in fresh.generate(prompts, MAX_NEW)]
    peng.generate(prompts[:, :P - 2], MAX_NEW)
    assert peng.timings["captures"] == 4
    t = peng.timings
    assert t["prefills"] == 3 and t["warmup_prefills"] == 0
    assert t["capture_s"] == 0.0 and t["pool_bytes"] == 0


def test_eos_sampled_at_prefill_ends_its_slot():
    jeng, peng, prompts = _engines("granite-3-2b")
    first = peng.generate(prompts, 1)
    eos = first[0].tokens[0]
    want = [r.tokens for r in jeng.generate(prompts, MAX_NEW, eos_id=eos)]
    got = [r.tokens for r in peng.generate(prompts, MAX_NEW, eos_id=eos)]
    assert got == want
    assert got[0] == [eos]
    assert any(len(toks) > 1 for toks in got)


def test_serve_launcher_on_the_cpu():
    out = port_serve.main(["--arch", "granite-3-2b", "--requests", "2",
                           "--max-new", "4", "--prompt-len", "8"],
                          device="cpu")
    assert out["requests"] == 2 and len(out["results"]) == 2
    assert all(len(r.tokens) == 4 for r in out["results"])
    assert out["tokens"] == 8 and out["tok_per_s"] > 0
    assert out["g_per_request"] > 0
    assert out["prefills"] == 1 and out["decode_steps"] == 3
    assert out["captures"] == 2 and out["warmup_prefills"] == 0
    ref = load_reference()
    fleet = ref.fleet.synthetic_fleet(64, seed=0)
    pl = ref.scheduler.place_jobs(fleet, jnp.asarray([4], jnp.int32))
    assert out["pod"] == int(pl.node[0])


def test_temperature_sampling_is_seeded_and_slot_count_checked():
    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    params["lm_head"] = params["lm_head"].normal_(
        generator=torch.Generator().manual_seed(2))
    prompts = np.random.default_rng(4).integers(2, cfg.vocab, (2, 5))

    def run(seed):
        eng = ServeEngine(model, params, max_seq=16, batch_slots=2,
                          temperature=0.8, seed=seed, device="cpu")
        return [r.tokens for r in eng.generate(prompts, 6)]

    a, b, c = run(1), run(1), run(2)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab for toks in a for t in toks)
    with pytest.raises(ValueError, match="slots"):
        ServeEngine(model, params, max_seq=16, batch_slots=3,
                    device="cpu").generate(prompts, 2)
