"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model=2048, 32H (GQA kv=8), d_ff=8192, vocab=49155.
vocab 49155 is NOT divisible by the 16-way model axis: the sharding rules
fall back to d_model sharding for the embedding (see distributed/sharding.py).
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=49_155,
    mlp="swiglu",
    rope_theta=10_000.0,
    notes="long_500k skipped (pure full attention); indivisible vocab.",
)
