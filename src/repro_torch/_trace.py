"""Spans of the port on the profiler's clock.

``span(name, args=None)`` is a host op of the profiler's
(``torch._C._profiler._RecordFunctionFast``: a ``RecordFunction`` in an
op's scope, where ``torch.profiler.record_function`` enters one in the
user's) while a ``torch.profiler`` profile runs, so the spans sit on the
profile's timeline beside the kernels and the CUDA runtime calls (a
trace exported with ``export_chrome_trace`` shows them as they are,
``args`` among the inputs where the profile records shapes).  Unlike
``record_function``'s user annotations, these ops leave no mark on the
device's timeline, so a reading of the device's busy time over the
profiler's CUDA events counts the device's own work alone.
With no profile running it returns one shared no-op context and enters
nothing: a flag read and a call (under 1 us on an x86 server CPU, where
entering and leaving an ungated ``record_function`` takes about 14 us).
The spans are kept nowhere else.

The span names (the serve engine's in ``serve/engine.py``, the captured
steps' in ``_graphs.py``):

- ``serve.generate``: one ``ServeEngine.generate`` call; its ``args`` are
  the call's number on its engine, the rows and the prompt length.
- ``serve.upload``: the prompt's copy to the device.
- ``serve.prefill``: the captured prefill, its sampling and its token read.
- ``serve.decode``: one iteration of the decode loop, from its loop-top
  read of the active mask to the positions advanced.
- ``serve.sample``: the sampling, and in a decode step the EOS mask and
  the choice between the new and the held token.
- ``serve.read``: one blocking read of device values by the host.
- ``graph.step``: a captured step's call: its inputs copied into the
  static buffers and the replay (on the CPU, the eager call); a new
  signature's capture lies outside it.
- ``graph.capture``: a new signature's warm-up runs and capture.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

GENERATE = "serve.generate"
UPLOAD = "serve.upload"
PREFILL = "serve.prefill"
DECODE = "serve.decode"
SAMPLE = "serve.sample"
READ = "serve.read"
GRAPH_STEP = "graph.step"
GRAPH_CAPTURE = "graph.capture"

_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[Dict[str, int]] = None):
    """A span of the profiler's while a profile runs, else a no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if args is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, [], args)
