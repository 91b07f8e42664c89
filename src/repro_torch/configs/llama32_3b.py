"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B family].

28L, d_model=3072, 24H (GQA kv=8), d_ff=8192, vocab=128256, tied embeddings.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128_256,
    mlp="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    notes="long_500k skipped (pure full attention).",
)
