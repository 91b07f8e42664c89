"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32H (GQA kv=8), expert d_ff=6400, vocab=32064,
MoE 16 experts top-2.  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32_064,
    mlp="swiglu",
    n_experts=16,
    top_k=2,
    rope_theta=10_000.0,
    notes="long_500k skipped (pure full attention).",
)
