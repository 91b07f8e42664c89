"""nemotron-4-340b [arXiv:2402.16819].

96L, d_model=18432, 96H (GQA kv=8), d_ff=73728, vocab=256000,
squared-ReLU MLP.  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256_000,
    mlp="relu2",
    rope_theta=10_000.0,
    notes="squared-ReLU; long_500k skipped (pure full attention).",
)
