"""Model facade: template / init / loss / prefill / decode for every
arch (twin of ``repro.models.model``).

Batch conventions
-----------------
train:   {"tokens": (B, S) int | "embeds": (B, S, D),
          "labels": (B, S) int, ["positions": (B, S) or (B, S, 3) int]}
prefill: {"tokens" | "embeds", ["positions"]}
decode:  {"token": (B,) int | "embed": (B, D), "positions": (B,) int,
          ["rope_positions": (B, 3) int]}

An arch with ``input_mode="embeddings"`` (qwen2-vl) takes precomputed
patch embeddings instead of tokens; an M-RoPE arch needs its (B, S, 3)
positions in training and prefill, and in decode takes them as
``rope_positions`` (default: the linear position three times over).

Parameters are nested dicts of tensors with the JAX tree's names, shapes
and dtypes (``Model.init`` draws them; ``convert.params_from_numpy`` brings
in a JAX model's).  ``loss`` is the training forward, plain torch under
autograd as the JAX package's is plain jnp; prefill runs the kernels K5 /
K6 (the SSD form of Mamba-2, ``ssm_algo="ssd"``, is plain torch on every
route, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import Param, gather_last, init_tree
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (embed_lookup, embed_template, lm_head,
                                       rmsnorm, rmsnorm_template,
                                       softmax_xent)


@dataclasses.dataclass(frozen=True)
class ModelFlags:
    """The JAX package's flags, with its defaults, shape the training
    forward: ``remat`` (none | full | dots), the attention and scan chunk
    lengths, ``ssm_algo`` (``scan`` or, for Mamba-2, ``ssd``) and
    ``loss_chunk`` (0 = the unchunked vocab loss).
    ``use_kernel=False`` runs prefill's attention and scan through their
    plain torch versions on any device (the reference route the kernels
    are held against on the card); training never runs the kernels."""
    remat: str = "full"          # none | full | dots
    attn_chunk: int = 1024
    ssm_chunk: int = 64
    ssm_algo: str = "scan"       # scan | ssd (mamba2 only)
    loss_chunk: int = 0          # 0 = unchunked vocab loss
    use_kernel: bool = True


class Model:
    def __init__(self, cfg: ArchConfig, flags: ModelFlags = ModelFlags()):
        self.cfg = cfg
        self.flags = flags

    # ------------------------------------------------------------------
    def template(self) -> Dict[str, Any]:
        cfg = self.cfg
        t: Dict[str, Any] = {
            "embed": embed_template(cfg.vocab, cfg.d_model),
            "stack": tr.stack_template(cfg),
            "ln_f": rmsnorm_template(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            # zero-init output head, as in the JAX package: logits start
            # at exactly 0
            t["lm_head"] = Param((cfg.d_model, cfg.vocab), ("fsdp", "vocab"),
                                 init="zeros")
        return t

    def init(self, seed: int = 0, *, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Parameters on ``device`` (the card unless told otherwise), drawn
        from ``generator`` or a fresh one seeded with ``seed``."""
        return init_tree(self.template(), seed, device=device,
                         generator=generator)

    def cache_template(self, batch: int, seq_len: int) -> Dict[str, Any]:
        return tr.stack_cache_template(self.cfg, batch, seq_len)

    def loss(self, params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"ce", "aux"}): mean next-token cross-entropy, f32, plus
        0.01 x the blocks' auxiliary loss.  With ``loss_chunk`` the
        (B, S, V) logits are made ``loss_chunk`` positions at a time, each
        chunk under a checkpoint, the padded tail masked out."""
        cfg, fl = self.cfg, self.flags
        x, pos = self._inputs(batch, params)
        h, aux = tr.stack_apply(cfg, params["stack"], x, pos,
                                remat=fl.remat, attn_chunk=fl.attn_chunk,
                                ssm_chunk=fl.ssm_chunk, ssm_algo=fl.ssm_algo)
        labels = batch["labels"]
        if fl.loss_chunk:
            c = fl.loss_chunk
            pad = (-h.shape[1]) % c
            hp = F.pad(h, (0, 0, 0, pad))
            lp = F.pad(labels, (0, pad))
            mp = F.pad(torch.ones(labels.shape, dtype=torch.float32,
                                  device=h.device), (0, pad))

            def body(hc, lc, mc):
                logits = self._logits(params, hc)
                lz = torch.logsumexp(logits, dim=-1)
                gold = gather_last(logits, lc)
                return torch.sum((lz - gold) * mc), torch.sum(mc)

            tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
            for i in range(hp.shape[1] // c):
                sl = slice(i * c, (i + 1) * c)
                t, n = checkpoint(body, hp[:, sl], lp[:, sl], mp[:, sl],
                                  use_reentrant=False)
                tot, cnt = tot + t, cnt + n
            ce = tot / torch.clamp_min(cnt, 1.0)
        else:
            ce = softmax_xent(self._logits(params, h), labels)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    def _inputs(self, batch: Dict[str, torch.Tensor], params) -> Tuple:
        cfg = self.cfg
        if cfg.input_mode == "embeddings":
            x = batch["embeds"]
        else:
            x = embed_lookup(params["embed"], batch["tokens"])
        B, S = x.shape[:2]
        if "positions" in batch:
            pos = batch["positions"]
        elif cfg.rope == "mrope":
            raise ValueError("an M-RoPE arch needs explicit positions")
        else:
            pos = torch.arange(S, dtype=torch.int32,
                               device=x.device).expand(B, S)
        return x, pos

    def _logits(self, params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rmsnorm(h, params["ln_f"], cfg.norm_eps)
        w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        return lm_head(w, h, tied=cfg.tie_embeddings)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, cache_len: int):
        """Logits (B, V) f32 of the last prompt token and the caches."""
        fl = self.flags
        x, pos = self._inputs(batch, params)
        h, caches = tr.stack_prefill(self.cfg, params["stack"], x, pos,
                                     cache_len, use_kernel=fl.use_kernel,
                                     ssm_algo=fl.ssm_algo,
                                     ssm_chunk=fl.ssm_chunk)
        logits = self._logits(params, h[:, -1:])[:, 0]
        return logits, caches

    @torch.no_grad()
    def decode_step(self, params, caches, batch):
        """One token per row at its own position; the caches are updated
        in place and returned."""
        cfg = self.cfg
        if cfg.input_mode == "embeddings":
            x = batch["embed"][:, None]
        else:
            x = embed_lookup(params["embed"], batch["token"][:, None])
        pos = batch["positions"]                     # (B,) linear slots
        rope_pos = None
        if cfg.rope == "mrope":
            rope_pos = batch.get("rope_positions")
            if rope_pos is None:
                rope_pos = torch.stack([pos] * 3, dim=-1)
        h, caches = tr.stack_decode(cfg, params["stack"], caches, x, pos,
                                    rope_pos)
        logits = self._logits(params, h)[:, 0]
        return logits, caches


def build_model(cfg: ArchConfig, flags: ModelFlags = ModelFlags()) -> Model:
    return Model(cfg, flags)
