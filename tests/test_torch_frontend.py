"""The port's frontend stubs and M-RoPE against the JAX package on the
CPU: ``fake_codec_tokens``, ``mrope_position_ids`` and
``fake_patch_embeddings`` give the reference's bytes, ``apply_rope`` with
(B, S, 3) ids matches the JAX rotation (f32 within 1e-6, bf16 bit for
bit or one bf16 ulp), M-RoPE ids with t = h = w turn as plain RoPE does,
and an M-RoPE model refuses inputs without positions, as the JAX model
does."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import frontend as jfrontend
from repro.models.layers import apply_rope as jax_apply_rope
from repro_torch.configs import get_config
from repro_torch.convert import bf16_bits
from repro_torch.models import frontend
from repro_torch.models.layers import apply_rope
from repro_torch.models.model import build_model


@pytest.mark.parametrize("arch,shape,seed", [
    ("musicgen-medium", (2, 37), 0), ("musicgen-medium", (3, 5), 4)])
def test_codec_tokens_are_the_reference_bytes(arch, shape, seed):
    got = frontend.fake_codec_tokens(get_config(arch), *shape, seed,
                                     device="cpu")
    want = np.asarray(jfrontend.fake_codec_tokens(JAX_ARCHS[arch], *shape,
                                                  seed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batch,seq,grid", [(2, 42, 4), (1, 9, 4),
                                            (3, 1100, 32)])
def test_mrope_ids_are_the_reference_bytes(batch, seq, grid):
    got = frontend.mrope_position_ids(batch, seq, grid=grid, device="cpu")
    want = np.asarray(jfrontend.mrope_position_ids(batch, seq, grid=grid))
    assert got.dtype == torch.int32 and got.shape == (batch, seq, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 7])
def test_patch_embeddings_are_the_reference_bytes(seed):
    cfg = get_config("qwen2-vl-72b").reduced()
    got = frontend.fake_patch_embeddings(cfg, 2, 19, seed, device="cpu")
    want = np.asarray(jfrontend.fake_patch_embeddings(
        JAX_ARCHS["qwen2-vl-72b"].reduced(), 2, 19, seed))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16_bits(got),
                                  want.view(np.uint16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 128])
def test_mrope_rotation_matches_reference(dtype, hd):
    rng = np.random.default_rng(2)
    B, S, H = 2, 40, 3
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    ids = np.asarray(jfrontend.mrope_position_ids(B, S, grid=4))
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jax_apply_rope(jx, jnp.asarray(ids), 1e6).astype(
        jnp.float32))
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = apply_rope(px, torch.from_numpy(ids.copy()), 1e6).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        # one bf16 ulp where the f32 rotation rounds on the other side
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_equal_mrope_ids_turn_as_plain_rope():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 11, 4, 64)).astype(
        np.float32))
    pos = torch.arange(11, dtype=torch.int32).expand(2, 11)
    three = torch.stack([pos] * 3, dim=-1)
    torch.testing.assert_close(apply_rope(x, three, 1e4),
                               apply_rope(x, pos, 1e4), rtol=0, atol=0)


def test_mrope_model_needs_positions():
    cfg = get_config("qwen2-vl-72b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    embeds = frontend.fake_patch_embeddings(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="positions"):
        model.prefill(params, {"embeds": embeds}, 8)
