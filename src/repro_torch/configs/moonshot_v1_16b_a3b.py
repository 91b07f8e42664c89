"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [hf:moonshotai/Moonlight-16B-A3B].

48L, d_model=2048, 16 heads (GQA kv=16), expert d_ff=1408, vocab=163840,
MoE 64 experts top-6.  Full attention -> long_500k skipped (O(L^2)).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163_840,
    mlp="swiglu",
    n_experts=64,
    top_k=6,
    rope_theta=50_000.0,
    notes="kimi/moonlight MoE; long_500k skipped (pure full attention).",
)
