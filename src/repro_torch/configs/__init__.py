"""Registry of assigned architectures (+ the paper's own cluster config)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES  # noqa: F401

from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.phi35_moe_42b_a66b import CONFIG as _phi35
from repro_torch.configs.llama32_3b import CONFIG as _llama32
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2vl

ARCHS = {
    c.name: c
    for c in (_moonshot, _phi35, _llama32, _danube, _granite, _nemotron,
              _falcon_mamba, _zamba2, _musicgen, _qwen2vl)
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) cells; skipped==True rows are the documented
    full-attention long_500k skips."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            ok = a.supports_shape(s)
            if ok or include_skipped:
                out.append((a, s, ok))
    return out
