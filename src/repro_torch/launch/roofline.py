"""Roofline terms of one step (twin of ``repro.launch.roofline``).

Three terms, in seconds, on one row of ``launch.mesh.HARDWARE``:
    compute    = FLOPs per device / peak (dense bf16)
    memory     = bytes per device / device-memory rate
    collective = collective bytes per device / link rate

``collective_bytes`` parses compiled HLO text as the reference does: the
per-device result shapes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute, an all-reduce counted 2×
(reduce-scatter + all-gather phases of a ring), ``-start`` async variants
counted once (``-done`` twins skipped).  Nothing in the port calls it: a
torch step has no HLO text.  It is the reference's parser, kept beside
its tests for the dry run of a mesh (ROADMAP Queue 1 item 1(b), slice
(C)).

The reference builds a ``Roofline`` with ``from_compiled``, which reads
XLA's compiled text and ``cost_analysis``.  A torch step is never
compiled to text, so the port builds it with ``from_cost`` from the
counts of ``launch.step_cost`` instead; ``xla_flops_once`` /
``xla_bytes_once`` stay 0.  At ``hw="tpu-v5e"`` (the default) every term
equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

from repro_torch.launch.mesh import HARDWARE, Hardware

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLL_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "ragged-all-to-all": 1.0,
    "collective-permute": 1.0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|ragged-all-to-all|"
    r"collective-permute)(-start|-done)?\(")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Tuple[float, Dict[str, float]]:
    """Weighted per-device collective bytes from compiled HLO text."""
    per_kind: Dict[str, float] = {}
    for m in _OP_RE.finditer(hlo_text):
        shape_str, kind, suffix = m.group(1), m.group(2), m.group(3)
        if suffix == "-done":
            continue                      # counted at -start
        b = _shape_bytes(shape_str) * _COLL_MULT[kind]
        per_kind[kind] = per_kind.get(kind, 0.0) + b
    return sum(per_kind.values()), per_kind


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    per_kind: Dict[str, float]
    chips: int
    xla_flops_once: float = 0.0      # the reference's cost_analysis fields
    xla_bytes_once: float = 0.0
    hw: str = "tpu-v5e"              # a row of launch.mesh.HARDWARE

    @property
    def hardware(self) -> Hardware:
        return HARDWARE[self.hw]

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.hardware.peak_flops_bf16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hardware.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.hardware.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time model: bound by the slowest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def useful_ratio(self, model_flops_global: float) -> float:
        hlo_global = self.flops_per_device * self.chips
        return model_flops_global / max(hlo_global, 1.0)

    def roofline_fraction(self, model_flops_global: float) -> float:
        """Fraction of peak the *useful* FLOPs achieve at the modeled step
        time."""
        ideal = model_flops_global / (self.chips
                                      * self.hardware.peak_flops_bf16)
        return ideal / max(self.step_s, 1e-12)

    def as_dict(self, model_flops_global: Optional[float] = None) -> Dict:
        d = {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_per_kind": self.per_kind,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
            "xla_flops_once": self.xla_flops_once,
            "xla_bytes_once": self.xla_bytes_once,
            "hw": self.hw,
        }
        if model_flops_global is not None:
            d["model_flops_global"] = model_flops_global
            d["useful_ratio"] = self.useful_ratio(model_flops_global)
            d["roofline_fraction"] = self.roofline_fraction(model_flops_global)
        return d


def from_cost(cost, chips: int, hw: str = "tpu-v5e") -> Roofline:
    """A ``Roofline`` from a ``launch.step_cost.Cost`` of one step on one
    device of ``chips``: the port's ``from_compiled`` (a torch step has no
    compiled HLO text to parse)."""
    return Roofline(
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.coll_bytes,
        per_kind=dict(cost.coll_per_kind),
        chips=chips, hw=hw)
