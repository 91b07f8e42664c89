"""Small models and cells the benchmark's CPU tests share: the port's
configurations of granite-3-2b and zamba2-1.2b at tiny widths, and cells
of the serve driver that run them on the CPU."""
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from repro_torch.configs import get_config  # noqa: E402

from bench import cell as cell_mod  # noqa: E402

SMALL = {
    "granite-3-2b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab=97),
    "zamba2-1.2b": dict(n_layers=5, attn_every=2, d_model=64, n_heads=4,
                        n_kv_heads=4, head_dim=16, d_ff=128, vocab=97,
                        ssm_state=16, ssm_head_dim=16),
}
# the limit of the check at these sizes: the port's widest gap read
# 0.000-0.025 and the float8 control's 0.23-0.50 at 4 layers of width 128,
# seeds 0-3 of each family (CPU, bf16); it lies between, 3x above the one
# and 3x under the other, as the cells' limits do at theirs
SMALL_LIMIT = 0.08
TRAFFIC = {"driver": "serve", "slots": 4, "prompt_lengths": [16, 24, 40],
           "new_tokens": 6, "trace": {"batches": 3},
           "check": {"batches_per_length": 1, "row_blocks": 4}}


def sizes(arch) -> dict:
    """The configuration dict of a port ``ArchConfig``."""
    out = {k: getattr(arch, k) for k in cell_mod.SIZE_KEYS}
    out.update(arch=arch.name, dtype="bfloat16")
    return out


def arch(name: str, **kw):
    return dataclasses.replace(get_config(name), **{**SMALL[name], **kw})


def context(name: str, seed: int, limit: float, *, seconds: float = 0.0,
            fault=None, control: bool = False, trace: bool = False,
            **kw) -> cell_mod.Context:
    a = arch(name, **kw)
    cell = cell_mod.Cell(f"{name}.small", 1, sizes(a), TRAFFIC,
                         [], [], {"max": {"gap_max": limit}})
    return cell_mod.Context(cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), arch=a, fault=fault,
                            control=control)
