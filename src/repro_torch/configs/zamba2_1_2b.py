"""zamba2-1.2b [arXiv:2411.15242].

38 Mamba-2 blocks, d_model=2048, ssm_state=64, plus a SINGLE shared
full-attention block (32H, kv=32, d_ff=8192 MLP) applied every 6 SSM blocks
(weight-tied, zamba-style).  Hybrid -> long_500k RUNS (SSM state + the one
shared-attn KV cache sharded over the mesh).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32_000,
    mlp="swiglu",
    ssm_variant="mamba2",
    ssm_state=64,
    ssm_conv=4,
    expand=2,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
    notes="shared (tied) attention block every 6 mamba2 blocks.",
)
