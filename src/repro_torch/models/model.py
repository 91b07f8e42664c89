"""Model facade: template / init / loss / prefill / decode for the ported
archs (twin of ``repro.models.model``).

Batch conventions
-----------------
train:   {"tokens": (B, S) int, "labels": (B, S) int,
          ["positions": (B, S) int]}
prefill: {"tokens": (B, S) int, ["positions": (B, S) int]}
decode:  {"token": (B,) int, "positions": (B,) int}

Parameters are nested dicts of tensors with the JAX tree's names, shapes
and dtypes (``Model.init`` draws them; ``convert.params_from_numpy`` brings
in a JAX model's).  ``loss`` is the training forward, plain torch under
autograd as the JAX package's is plain jnp; prefill runs the kernels K5 /
K6.  Embeddings input is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import Param, init_tree
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (embed_lookup, embed_template, lm_head,
                                       rmsnorm, rmsnorm_template,
                                       softmax_xent)


@dataclasses.dataclass(frozen=True)
class ModelFlags:
    """The JAX package's flags, with its defaults, shape the training
    forward: ``remat`` (none | full | dots), the attention and scan chunk
    lengths, ``ssm_algo`` (``scan``; the Mamba-2 ``ssd`` path is not
    ported) and ``loss_chunk`` (0 = the unchunked vocab loss).
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
        tr.check_supported(cfg)
        if flags.ssm_algo != "scan":
            raise NotImplementedError(
                f"ssm_algo={flags.ssm_algo!r} is not ported yet: ROADMAP "
                "Queue 1 item M5 (Mamba-2 and the zamba2 hybrid)")
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                "embeddings input is not ported yet: ROADMAP Queue 1 item "
                "M6 (the frontend, M-RoPE and embeddings input)")
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
                                ssm_chunk=fl.ssm_chunk)
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
                gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
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
        x = embed_lookup(params["embed"], batch["tokens"])
        B, S = x.shape[:2]
        if "positions" in batch:
            pos = batch["positions"]
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
        x, pos = self._inputs(batch, params)
        h, caches = tr.stack_prefill(self.cfg, params["stack"], x, pos,
                                     cache_len,
                                     use_kernel=self.flags.use_kernel)
        logits = self._logits(params, h[:, -1:])[:, 0]
        return logits, caches

    @torch.no_grad()
    def decode_step(self, params, caches, batch):
        """One token per row at its own position; the caches are updated
        in place and returned."""
        x = embed_lookup(params["embed"], batch["token"][:, None])
        h, caches = tr.stack_decode(self.cfg, params["stack"], caches, x,
                                    batch["positions"])
        logits = self._logits(params, h)[:, 0]
        return logits, caches


def build_model(cfg: ArchConfig, flags: ModelFlags = ModelFlags()) -> Model:
    return Model(cfg, flags)
