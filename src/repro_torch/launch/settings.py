"""Per-(arch × shape) dry-run settings: baseline vs optimized (twin of
``repro.launch.settings``).

``baseline`` is the paper-faithful configuration: default sharding rules,
full remat, no microbatching, unchunked vocab loss, auto gradient sync.
``optimized`` holds the reference's §Perf hillclimb winners for its
chosen cells (everything else inherits the generic optimized default).
Every registered override and field is the reference's; ``flags`` are
the port's ``ModelFlags`` (the reference's fields plus ``use_kernel``, on).

On one device ``rules`` and ``constrain_acts`` change nothing (every rule
resolves to replication), and ``grad_sync`` applies only across pods
(the dry run's ``--multi-pod`` mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import Rules
from repro_torch.models.model import ModelFlags


@dataclasses.dataclass(frozen=True)
class CellSettings:
    flags: ModelFlags = ModelFlags()
    microbatches: int = 1
    grad_sync: str = "auto"          # auto | int8 | fp32 (multi-pod only)
    rules: Rules = Rules()
    constrain_acts: bool = False     # activation constraints (meshes only)


_BASE = CellSettings()
# generic optimized default: pin activation layouts and use the SSD
# chunk-matmul path for mamba2 archs
_OPT_BASE = CellSettings(constrain_acts=True,
                         flags=ModelFlags(ssm_algo="ssd", ssm_chunk=128))

# (arch, shape, mode) -> overrides
_OVERRIDES: Dict[Tuple[str, str, str], CellSettings] = {}


def register_override(arch: str, shape: str, mode: str,
                      settings: CellSettings) -> None:
    _OVERRIDES[(arch, shape, mode)] = settings


def cell_settings(cfg: ArchConfig, shape: ShapeSpec,
                  mode: str = "baseline") -> CellSettings:
    key = (cfg.name, shape.name, mode)
    if key in _OVERRIDES:
        return _OVERRIDES[key]
    return _BASE if mode == "baseline" else _OPT_BASE


# ---------------------------------------------------------------------------
# the reference's §Perf hillclimb winners (EXPERIMENTS.md §Perf)
# ---------------------------------------------------------------------------

# zamba2: constraints + SSD chunk-matmul mamba2
register_override("zamba2-1.2b", "train_4k", "optimized", CellSettings(
    flags=ModelFlags(ssm_algo="ssd", ssm_chunk=128),
    constrain_acts=True))

# moonshot multi-pod: int8-compressed cross-pod gradient sync
register_override("moonshot-v1-16b-a3b", "train_4k", "int8", CellSettings(
    grad_sync="int8", constrain_acts=True))

# qwen2-vl: optimized mode falls back to baseline for this arch
for _shape in ("train_4k", "prefill_32k", "decode_32k"):
    register_override("qwen2-vl-72b", _shape, "optimized", CellSettings())

# llama3.2: full sequence parallelism (S over "model", no weight TP)
_LLAMA_SP_RULES = Rules().with_overrides(
    seq=(("model",), ()),
    sp_seq=(("model",), ()),
    tp=((),),
    heads=((),),
    kv_heads=((),),
    vocab=((),),
)
# under SP the q-chunk scan is redundant -> single-chunk attention
register_override("llama3.2-3b", "train_4k", "optimized", CellSettings(
    rules=_LLAMA_SP_RULES, constrain_acts=True,
    flags=ModelFlags(attn_chunk=4096)))

# int8 cross-pod gradient sync on top of the SP config (multi-pod only)
register_override("llama3.2-3b", "train_4k", "int8", CellSettings(
    rules=_LLAMA_SP_RULES, constrain_acts=True, grad_sync="int8"))

# isolation variants: explicit pod sync without activation constraints,
# in three wire formats
register_override("llama3.2-3b", "train_4k", "int8_noconstraint",
                  CellSettings(grad_sync="int8"))
register_override("llama3.2-3b", "train_4k", "int16_noconstraint",
                  CellSettings(grad_sync="int16"))
register_override("llama3.2-3b", "train_4k", "fp32_noconstraint",
                  CellSettings(grad_sync="fp32"))
