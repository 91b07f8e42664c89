"""qwen2-vl-72b [arXiv:2409.12191].

80L, d_model=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064, M-RoPE.
Vision frontend is a STUB per the brief: input_specs() provides precomputed
patch embeddings (B, S, d_model) + 3-channel M-RoPE position ids.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152_064,
    mlp="swiglu",
    input_mode="embeddings",
    rope="mrope",
    rope_theta=1_000_000.0,
    notes="backbone only; patch embeddings from stub frontend; M-RoPE.",
)
