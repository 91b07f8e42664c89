"""The traced run's profile, reduced in memory: ``torch.profiler`` over
whole units of work (``Profile.start`` / ``stop``), with the unit marked
by a ``bench.unit`` span.  ``Trace`` keeps each device operation (kernel,
copy, set) with its interval, the unit's span, the device's busy time
(the union of the device intervals inside the span, as ``chip_smoke.py``'s
``device_busy`` counts device events only) and the idle gaps, each named
by the innermost host operation running at its middle.  No trace file is
written."""
from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

UNIT = "bench.unit"
TOP = 10


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]   # (name, start, end) in s
    window: Tuple[float, float]                  # the unit's span, s
    busy_s: float
    gaps: List[Tuple[str, float]]                # (host op, seconds)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches the regular
        expression ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device_ops if rx.search(n))

    def breakdown(self) -> Dict[str, List]:
        """The device operations that took most time and the host
        operations the longest idle time fell in, ``TOP`` of each."""
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device_ops:
            ops[n] += e - s
        idle: Dict[str, float] = defaultdict(float)
        for n, d in self.gaps:
            idle[n] += d
        top = lambda d: [[k[:160], v] for k, v in            # noqa: E731
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(device: List[Tuple[str, float, float]],
           host: List[Tuple[str, float, float]]) -> Trace:
    """A ``Trace`` from device and host events (name, start, end) in
    seconds; the window is the ``bench.unit`` host span."""
    units = [(s, e) for n, s, e in host if n == UNIT]
    if len(units) != 1:
        raise RuntimeError(f"the profile holds {len(units)} {UNIT} spans, "
                           f"not 1")
    w0, w1 = units[0]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device
              if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in inside])
    host = sorted((s, e, n) for n, s, e in host if n != UNIT)
    starts = [s for s, _, _ in host]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        name = "(no host op)"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        gaps.append((name, g1 - g0))
    return Trace(inside, (w0, w1), sum(e - s for s, e in busy), gaps)


class Profile:
    """``torch.profiler`` (host and CUDA activity) around one unit."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._span = None

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._prof.start()
        self._span = torch.autograd.profiler.record_function(UNIT)
        self._span.__enter__()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()

    def reduce(self) -> Optional[Trace]:
        """The unit's ``Trace``; None where the profiler saw no device
        operation."""
        from torch.autograd import DeviceType
        device, host = [], []
        for ev in self._prof.events():
            row = (ev.name, ev.time_range.start * 1e-6,
                   ev.time_range.end * 1e-6)
            if ev.device_type != DeviceType.CUDA:
                host.append(row)
            elif ev.name != UNIT:     # the span's own mark on the device
                device.append(row)
        if not device:
            return None
        return reduce(device, host)


def warm() -> None:
    """Start and stop the profiler once around a device op, so the first
    start's set-up (CUPTI) lands in set-up, not in the window."""
    import torch
    p = Profile()
    p.start()
    torch.ones(1, device="cuda").add_(1)
    p.stop()
    p.reduce()
