"""h2o-danube-3-4b [arXiv:2401.16818].

24L, d_model=3840, 32H (GQA kv=8), d_ff=10240, vocab=32000.
llama+mistral mix with sliding-window attention: window-bounded KV cache
=> sub-quadratic decode => long_500k RUNS for this arch.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32_000,
    mlp="swiglu",
    attention="swa",
    window=4096,
    rope_theta=10_000.0,
    notes="SWA ring-buffer KV => long_500k supported.",
)
