"""Modality frontend stubs (twin of ``repro.models.frontend``).

- musicgen: EnCodec tokenization is stubbed; the backbone consumes
  flattened codec token ids (vocab 2048) directly, and
  ``fake_codec_tokens`` makes a deterministic stream of them.
- qwen2-vl: the ViT frontend is stubbed; ``fake_patch_embeddings`` gives
  precomputed patch embeddings (B, S, d_model) and ``mrope_position_ids``
  the 3-channel M-RoPE ids (temporal, height, width) the backbone's rotary
  layer expects.

Each draws with ``np.random.default_rng(seed)`` as the JAX package does,
so the arrays are the same bytes, and returns them as tensors on
``device`` (the card unless told otherwise).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig


def fake_codec_tokens(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                      *, device: DeviceLike = None) -> torch.Tensor:
    """(B, S) int32 codec token ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    return torch.from_numpy(ids).to(resolve_device(device))


def mrope_position_ids(batch: int, seq: int, *, grid: int = 32,
                       device: DeviceLike = None) -> torch.Tensor:
    """(B, S, 3) int32 position ids [temporal, height, width].

    A vision-prefix layout: the first grid * grid positions are image
    patches (t = 0, raster-scan h / w), the rest is text (t = h = w
    advancing together, qwen2-vl style)."""
    s = np.arange(seq)
    n_img = min(grid * grid, seq)
    t = np.where(s < n_img, 0, s - n_img + 1)
    h = np.where(s < n_img, s // grid, s - n_img + 1)
    w = np.where(s < n_img, s % grid, s - n_img + 1)
    ids = np.stack([t, h, w], axis=-1).astype(np.int32)
    ids = np.ascontiguousarray(np.broadcast_to(ids, (batch, seq, 3)))
    return torch.from_numpy(ids).to(resolve_device(device))


def fake_patch_embeddings(cfg: ArchConfig, batch: int, seq: int,
                          seed: int = 0, *, device: DeviceLike = None
                          ) -> torch.Tensor:
    """(B, S, d_model) bf16 patch embeddings, std 0.02."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32)
    return torch.from_numpy(x * np.float32(0.02)).to(
        resolve_device(device)).to(torch.bfloat16)
