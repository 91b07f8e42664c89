"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig``; every assigned input shape
is a ``ShapeSpec``.  ``(arch, shape)`` cells drive the dry-run, the roofline
table and the smoke tests.  Nothing in this module touches device state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned; identical across the LM family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                   # dense FFN width (per-expert width for MoE)
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    mlp: str = "swiglu"         # swiglu | relu2 | gelu
    attention: str = "full"     # full | swa | none
    window: int = 4_096         # SWA window
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM ---
    ssm_variant: Optional[str] = None   # mamba1 | mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64              # mamba2 head dim
    dt_rank: int = 0                    # mamba1: 0 -> ceil(d_model / 16)
    # --- hybrid (zamba2-style) ---
    attn_every: int = 0                 # shared attn block every k SSM blocks
    # --- modality / misc ---
    input_mode: str = "tokens"          # tokens | embeddings
    rope: str = "rope"                  # rope | mrope | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    notes: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_variant == "mamba1" and self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.attention != "none"

    @property
    def has_ssm(self) -> bool:
        return self.ssm_variant is not None

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model if self.has_ssm else 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(seq) decode state (500k-context OK)."""
        return self.attention in ("swa", "none") or self.family in ("ssm", "hybrid")

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        D, H, K, hd, F, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                self.head_dim, self.d_ff, self.vocab,
                                self.n_layers)
        per_layer = 0
        attn = 0
        if self.has_attention:
            attn = D * H * hd + 2 * D * K * hd + H * hd * D  # q, k, v, o
        if self.mlp == "swiglu":
            ffn = 3 * D * F
        else:
            ffn = 2 * D * F
        if self.is_moe:
            ffn = self.n_experts * ffn + D * self.n_experts  # experts + router
        ssm = 0
        if self.has_ssm:
            di, N = self.d_inner, self.ssm_state
            if self.ssm_variant == "mamba1":
                ssm = (D * 2 * di + di * self.ssm_conv
                       + di * (self.dt_rank + 2 * N) + self.dt_rank * di
                       + di * N + 2 * di + di * D)
            else:  # mamba2
                nh = di // self.ssm_head_dim
                ssm = (D * (2 * di + 2 * N + nh) + di * self.ssm_conv
                       + 2 * nh + di + di * D + di)
        if self.family == "hybrid":
            # SSM blocks every layer + ONE shared attention block.
            per_layer = ssm + 2 * D          # ssm + norms
            total = L * per_layer + attn + 2 * D
        else:
            blocks = []
            if self.has_attention:
                blocks.append(attn + D)      # attn + pre-norm
            if self.has_ssm:
                blocks.append(ssm + D)
            if F:
                blocks.append(ffn + D)
            per_layer = sum(blocks)
            total = L * per_layer
        total += V * D                        # embedding
        if not self.tie_embeddings:
            total += V * D                    # lm head
        total += D                            # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        ffn_one = (3 if self.mlp == "swiglu" else 2) * self.d_model * self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * ffn_one
        return full - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            window=64,
        )
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=min(self.n_kv_heads, 4) or 2,
                      head_dim=32)
        if self.is_moe:
            kw.update(n_experts=4, top_k=min(self.top_k, 2))
        if self.has_ssm:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
                      dt_rank=8)
        if self.attn_every:
            kw.update(attn_every=2)
        kw["name"] = self.name + "-reduced"
        return ArchConfig(**kw)
