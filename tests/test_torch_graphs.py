"""The captured-step helper (``repro_torch._graphs``) on the CPU, where it
captures nothing and runs the step on its static buffers with the keying
and copy logic the card runs: one entry per signature (input shapes,
dtypes and devices, the state's addresses, the static values), a second
call with new inputs equal to a direct call of the step, outputs handed
back in the static buffers, and the refusals: DTensor parameters,
inputs or state, parameters swapped under a captured step, a leaf that
is not a tensor.  The reduced granite-3-2b and falcon-mamba-7b prefill
and decode steps, f32.  The card's form (capture, replay, launch counts)
is in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch._graphs import CapturedStep, GraphPool
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import mesh as port_mesh
from repro_torch.models.model import build_model

B, P, CACHE = 2, 7, 16


def _setup(name="granite-3-2b"):
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    params["lm_head"] = torch.from_numpy(np.random.default_rng(1)
                                         .standard_normal(
        (cfg.d_model, cfg.vocab)).astype(np.float32) * 0.05)
    pool = GraphPool(torch.device("cpu"))
    prefill = CapturedStep(
        lambda p, b, _, cache_len: model.prefill(p, b, cache_len), pool)
    decode = CapturedStep(
        lambda p, b, caches: model.decode_step(p, caches, b), pool)
    return cfg, model, params, prefill, decode


def _tokens(cfg, seed, n=P):
    return {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab, (B, n)))}


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(sh.tree_leaves(a),
                                                 sh.tree_leaves(b)))


@pytest.mark.parametrize("name", ["granite-3-2b", "falcon-mamba-7b"])
def test_one_entry_per_signature(name):
    cfg, _, params, prefill, decode = _setup(name)
    _, caches = prefill(params, _tokens(cfg, 0), cache_len=CACHE)
    prefill(params, _tokens(cfg, 1), cache_len=CACHE)
    assert len(prefill.entries) == prefill.captures == 1
    # a new prompt length, and a new cache length, each add one
    prefill(params, _tokens(cfg, 2, P + 3), cache_len=CACHE)
    assert prefill.captures == 2
    prefill(params, _tokens(cfg, 2), cache_len=CACHE + 4)
    assert prefill.captures == 3
    # decode keys on the caches' addresses: the prefill's static caches
    # key one entry however often they are advanced
    step = {"token": torch.zeros(B, dtype=torch.long),
            "positions": torch.full((B,), P, dtype=torch.long)}
    for t in range(3):
        _, caches = decode(params, {**step, "positions": step["positions"]
                                    + t}, caches)
    assert decode.captures == 1
    other = sh.tree_map(torch.clone, caches)
    decode(params, step, other)
    assert decode.captures == 2
    assert prefill.warmups == decode.warmups == 0
    assert prefill.warmup_s == decode.warmup_s == 0.0
    assert prefill.run_s > 0 and decode.run_s > 0
    # nothing is captured on the CPU: every call runs the step eagerly
    assert all(e.graph is None for e in prefill.entries.values())
    assert all(e.graph is None for e in decode.entries.values())


@pytest.mark.parametrize("name", ["granite-3-2b", "falcon-mamba-7b"])
def test_second_call_equals_a_direct_call(name):
    """A second call with new inputs equals the step called directly on
    them: prefill logits and caches, then three decode steps advancing
    the captured caches against three on the direct caches."""
    cfg, model, params, prefill, decode = _setup(name)
    prefill(params, _tokens(cfg, 0), cache_len=CACHE)
    got, caches = prefill(params, _tokens(cfg, 1), cache_len=CACHE)
    want, want_caches = model.prefill(params, _tokens(cfg, 1), CACHE)
    assert torch.equal(got, want) and _equal_trees(caches, want_caches)
    tok = want.argmax(-1)
    for t in range(3):
        step = {"token": tok, "positions": torch.full((B,), P + t,
                                                      dtype=torch.long)}
        got, caches = decode(params, step, caches)
        want, want_caches = model.decode_step(params, want_caches, step)
        assert torch.equal(got, want)
        tok = want.argmax(-1)
    assert _equal_trees(caches, want_caches)


def test_outputs_come_back_in_the_static_buffers():
    cfg, _, params, prefill, decode = _setup()
    first, caches = prefill(params, _tokens(cfg, 0), cache_len=CACHE)
    kept = first.clone()
    second, caches2 = prefill(params, _tokens(cfg, 1), cache_len=CACHE)
    assert second is first and caches2 is caches
    assert not torch.equal(first, kept)        # overwritten in place
    # the inputs went into the entry's own buffers, not by address
    tokens = _tokens(cfg, 3)
    prefill(params, tokens, cache_len=CACHE)
    (entry,) = prefill.entries.values()
    assert entry.static_in["tokens"] is not tokens["tokens"]
    assert torch.equal(entry.static_in["tokens"], tokens["tokens"])
    step = {"token": torch.ones(B, dtype=torch.long),
            "positions": torch.full((B,), P, dtype=torch.long)}
    logits, out = decode(params, step, caches)
    again, out2 = decode(params, step, out)
    assert again is logits and out is out2 is caches


def test_swapped_parameters_raise():
    cfg, _, params, prefill, _ = _setup()
    prefill(params, _tokens(cfg, 0), cache_len=CACHE)
    moved = sh.tree_map(torch.clone, params)
    with pytest.raises(ValueError, match="by address"):
        prefill(moved, _tokens(cfg, 0), cache_len=CACHE)
    # the same tensors in a new dict are the same parameters
    prefill(dict(params), _tokens(cfg, 1), cache_len=CACHE)


def test_dtensors_and_non_tensors_raise():
    cfg, _, params, prefill, _ = _setup()
    mesh = port_mesh.make_fake_mesh(MeshShape(("data",), (1,)))
    try:
        x = sh.meta_dtensor((B, P), torch.int64, mesh, (None, None))
        with pytest.raises(ValueError, match="DTensor"):
            prefill(params, {"tokens": x}, cache_len=CACHE)
        w = sh.meta_dtensor(params["ln_f"].shape, torch.float32, mesh,
                            (None,))
        with pytest.raises(ValueError, match="DTensor"):
            prefill({**params, "ln_f": w}, _tokens(cfg, 0), cache_len=CACHE)
    finally:
        port_mesh.close_fake_world()
    with pytest.raises(TypeError, match="not a tensor"):
        prefill(params, {"tokens": np.zeros((B, P), np.int64)},
                cache_len=CACHE)
    assert prefill.captures == 0
