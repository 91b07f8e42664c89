"""What every run hands the harness, whatever its driver: set-up, the
reduced trace, the correctness check and the device.  A driver returns a
subclass with the records of its own window (``drivers/serve.py``:
``ServeRun``), which the driver's metric readers read, and lines of its
own for the summary (``summary()``).  Times are ``time.perf_counter()``
seconds."""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

# top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    cell: str
    cfg: Dict
    setup_s: float
    attempted: int = 0
    failed: int = 0
    correct: bool = False
    checks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    memory_peak_bytes: int = 0
    # the card's peaks (``costs/peaks.py``), set by the harness
    rates: Optional[Tuple[float, float, float, float]] = None
    trace: Optional[object] = None  # bench.trace.Trace of the traced unit

    def summary(self) -> List[str]:
        """Lines printed before the result: the driver's own account of
        its window."""
        return []


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result_line(run: Run, metrics: Dict[str, Dict], device: Dict,
                breakdown: Optional[Dict] = None) -> str:
    """The last line: the contract's keys, ``checks`` last."""
    out = {"correct": bool(run.correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = run.checks
    return json.dumps(out)
