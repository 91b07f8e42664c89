"""musicgen-medium [arXiv:2306.05284].

48L decoder-only over EnCodec tokens: d_model=1536, 24H (kv=24),
d_ff=6144, vocab=2048.  The EnCodec frontend is a STUB per the brief;
the backbone consumes codec tokens directly.  GELU MLP.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    mlp="gelu",
    rope_theta=10_000.0,
    notes=("EnCodec frontend stubbed (codebooks flattened to one token "
           "stream). long_500k skipped (pure full attention)."),
)
