"""falcon-mamba-7b [arXiv:2410.05355].

64L, d_model=4096, attention-free Mamba-1, ssm_state=16, vocab=65024.
O(1)-state decode -> long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65_024,
    attention="none",
    rope="none",
    ssm_variant="mamba1",
    ssm_state=16,
    ssm_conv=4,
    expand=2,
    notes="pure mamba1 stack; dt_rank=ceil(d/16)=256.",
)
