"""The card's published peaks (``peaks.json``), first matching row by the
device's name."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

_TABLE = Path(__file__).resolve().parent / "peaks.json"


def rates(device_name: str) -> Tuple[float, float, float, float]:
    """(bytes/s, f32 FLOP/s, bf16 tensor FLOP/s, TF32 tensor FLOP/s) of the
    card named ``device_name``; raises for a card the table lacks."""
    for row in json.loads(_TABLE.read_text())["cards"]:
        if row["match"] in device_name:
            return (row["bytes_per_s"], row["f32_flops"], row["bf16_flops"],
                    row["tf32_flops"])
    raise KeyError(f"no peak rates for {device_name!r} in {_TABLE.name}")
