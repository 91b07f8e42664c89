"""Fault tolerance: failure detection, straggler mitigation, MAIZX-driven
migration (a copy of ``repro.train.fault_tolerance``, which is plain numpy
and ``time``).

Pieces (all simulation-testable on CPU, designed for the 1000+-node fleet):

- ``HealthMonitor``: per-step wall-time EWMA + deviation; flags stragglers
  (step > straggler_factor × median) and hard failures (missed heartbeats).
  Straggler scores feed MAIZX's SCHEDULE_WEIGHT term — a slow pod's rank
  degrades until the scheduler migrates the job off it (the paper's ranking
  doubles as health-aware placement).
- ``MigrationPolicy``: combines MAIZX rank deltas with a hysteresis +
  migration-cost model so jobs only move when the carbon win over the
  remaining runtime exceeds the checkpoint/restore + warmup cost.

The restart itself (restore the latest checkpoint after a ``NodeFailure``)
lives in ``launch/train.py`` and runs on one device; restoring onto a
different mesh waits for ROADMAP Queue 1 item 1(b).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class HealthMonitor:
    straggler_factor: float = 1.5
    ewma_alpha: float = 0.2
    heartbeat_timeout_s: float = 60.0
    # injectable clock: tests (and the simulator's fault harness) pass a
    # deterministic counter so missed-heartbeat detection is reproducible;
    # production keeps the monotonic wall clock.  An explicit ``now``
    # argument still overrides the clock per call.
    clock: Callable[[], float] = time.monotonic
    _ewma: Dict[str, float] = dataclasses.field(default_factory=dict)
    _last_beat: Dict[str, float] = dataclasses.field(default_factory=dict)

    def record_step(self, node: str, step_time_s: float,
                    now: Optional[float] = None) -> None:
        prev = self._ewma.get(node, step_time_s)
        self._ewma[node] = (1 - self.ewma_alpha) * prev \
            + self.ewma_alpha * step_time_s
        self._last_beat[node] = self.clock() if now is None else now

    def median_step(self) -> float:
        return float(np.median(list(self._ewma.values()))) if self._ewma \
            else 0.0

    def straggler_score(self, node: str) -> float:
        """>= 0; 0 = at/faster than median.  Feeds SCHEDULE_WEIGHT."""
        med = self.median_step()
        if med <= 0 or node not in self._ewma:
            return 0.0
        return max(0.0, self._ewma[node] / med - 1.0)

    def is_straggler(self, node: str) -> bool:
        med = self.median_step()
        return (node in self._ewma and med > 0
                and self._ewma[node] > self.straggler_factor * med)

    def failed_nodes(self, now: Optional[float] = None) -> List[str]:
        now = self.clock() if now is None else now
        return [n for n, t in self._last_beat.items()
                if now - t > self.heartbeat_timeout_s]


@dataclasses.dataclass(frozen=True)
class MigrationDecision:
    migrate: bool
    target: int
    reason: str


@dataclasses.dataclass
class MigrationPolicy:
    """Move only when the carbon win pays for the move (hysteresis)."""
    min_rank_advantage: float = 0.15   # normalized score units
    migration_cost_steps: float = 50   # checkpoint+restore+warmup, in steps
    cooldown_steps: int = 500
    _last_migration_step: int = -10**9

    def decide(self, step: int, current_node: int, scores: np.ndarray,
               remaining_steps: int) -> MigrationDecision:
        best = int(np.argmin(scores))
        if best == current_node:
            return MigrationDecision(False, current_node, "already best")
        if step - self._last_migration_step < self.cooldown_steps:
            return MigrationDecision(False, current_node, "cooldown")
        adv = float(scores[current_node] - scores[best])
        if adv < self.min_rank_advantage:
            return MigrationDecision(False, current_node,
                                     f"advantage {adv:.3f} below threshold")
        if remaining_steps < 2 * self.migration_cost_steps:
            return MigrationDecision(False, current_node,
                                     "too little runtime left to amortize")
        self._last_migration_step = step
        return MigrationDecision(True, best,
                                 f"advantage {adv:.3f} over {remaining_steps} steps")


class NodeFailure(RuntimeError):
    """Raised by the launcher (or injected in tests) on hard node loss."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples: {step: kind}."""
    schedule: Dict[int, str] = dataclasses.field(default_factory=dict)

    def check(self, step: int) -> None:
        kind = self.schedule.get(step)
        if kind == "node_failure":
            raise NodeFailure(f"injected node failure at step {step}")

    def straggle_s(self, step: int) -> float:
        return 0.75 if self.schedule.get(step) == "straggler" else 0.0
