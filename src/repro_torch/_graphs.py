"""Compiled steps for the port: a step captured as a CUDA graph once per
input signature and replayed, the counterpart of ``jax.jit`` (which traces
once per shape and reuses the trace).

``CapturedStep(fn, pool)`` wraps ``fn(params, inputs, state, **static)``:

- ``params``: a tree of tensors the graph reads by address.  Each entry
  records their addresses at capture and refuses (``ValueError``) a call
  whose parameters lie elsewhere: a graph would go on reading the old ones.
- ``inputs``: a tree of tensors copied into the entry's static buffers on
  every call (new tensors each call, never captured by address).
- ``state``: a tree of tensors (the caches) read and written where they
  lie; their addresses are part of the signature, so the caches a
  captured prefill returns key the decode graph that advances them.
- ``static``: Python values the step closes over (``cache_len``), part of
  the signature.

The signature is the inputs' paths, shapes, dtypes and devices, the
state's paths, shapes, dtypes and addresses and the static values.  On
the first call for a signature, on a CUDA device, the step runs
``WARMUP`` times eagerly on the pool's side stream (the first run builds
and loads the kernels with ``nvcc`` and sets up cuBLAS there, so nothing
is built under capture), each time on a clone of ``state`` so the live
caches do not advance, and is then captured on that stream into the
pool; its outputs are the graph's static outputs.  Every call then
copies the inputs in, replays, and returns the static outputs, which
the next replay of any step of the pool may overwrite.  A capture or
replay error propagates: there is no eager fall-back.

On the CPU (only when the caller asks for it) nothing is captured: each
call copies the inputs into the same static buffers, calls ``fn`` on
them and copies its outputs into the static outputs, so the keying and
copy logic is the code the card runs.

Timing (host clock, no sync added): ``run_s`` sums the seconds of every
call's ``graph.step`` span (the input copies and the replay; on the CPU
the eager call), never a capture; ``setup_s`` those of the warm-ups and
captures, ``warmup_s`` the part of it in the warm-up runs.  On the card
they measure what the host spends: a replay returns once it is
enqueued, and a warm-up's device tail is waited for by its capture.
Spans (``_trace``): ``graph.step`` around each call's copies and replay,
``graph.capture`` around a new signature's warm-ups and capture; they
exist only while a profile runs.

Launch counts: the launches K5 / K6 make while a step is captured are
taken back off ``flash_attention`` / ``selective_scan``'s counters (the
capture launches nothing) and added again on every replay, so the
counters read launches on the device: captured launches x replays, plus
the warm-up runs' own launches.

DTensor parameters, inputs or state raise ``ValueError``: the mesh path's
gloo collectives cannot be captured; it runs eagerly through ``Model``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch._trace import GRAPH_CAPTURE, GRAPH_STEP, span
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import selective_scan as _ss

# eager runs before a capture: the first builds the kernels and sets up
# lazy state (cuBLAS handle and workspace on the side stream), the second
# runs in the steady state the capture records
WARMUP = 2
# the counted kernels: (wrapper, the function that adds to its counters)
_COUNTED = ((_fa.flash_attention, _fa.count_launches),
            (_ss.selective_scan, _ss.count_launches))


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a tree of dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tensors(tree, what: str):
    out = []
    for path, t in _leaves(tree):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}{path} is a {type(t).__name__}, not a "
                            f"tensor")
        if is_dtensor(t):
            raise ValueError(
                f"{what}{path} is a DTensor: a CUDA graph cannot capture the "
                f"mesh path's gloo collectives; run a mesh step eagerly "
                f"through Model")
        out.append((path, t))
    return out


def _launch_counts() -> Dict[Tuple[Callable, str], int]:
    """{(count function, route): launches} of the counted kernels."""
    return {(add, r): n for wrapper, add in _COUNTED
            for r, n in wrapper.route_launches.items()}


class GraphPool:
    """One memory pool and one side stream (warm-up and capture) shared by
    the steps of one owner, e.g. an engine's prefill and decode.  Graphs of
    one pool must not run concurrently.  ``reserved`` is the bytes their
    captures reserved in the pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.handle = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.reserved = 0


class _Entry:
    def __init__(self, params, static_in, state):
        self.param_ptrs = [t.data_ptr() for _, t in params]
        self.static_in = static_in
        self.state = state
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.launches: Dict[Tuple[Callable, str], int] = {}


class CapturedStep:
    """``fn`` captured once per signature into ``pool`` and replayed (see
    the module docstring).  ``captures`` counts signatures (on the CPU:
    their static buffers made), ``warmups`` the eager warm-up runs;
    ``run_s`` is the seconds of the calls' copies and replays, ``setup_s``
    of warm-up and capture, ``warmup_s`` of the warm-ups alone."""

    def __init__(self, fn: Callable, pool: GraphPool):
        self.fn = fn
        self.pool = pool
        self.entries: Dict[tuple, _Entry] = {}
        self.captures = self.warmups = 0
        self.run_s = self.setup_s = self.warmup_s = 0.0

    def __call__(self, params, inputs, state=None, **static):
        p = _tensors(params, "params")
        ins = _tensors(inputs, "inputs")
        st = _tensors(state, "state")
        key = (tuple((path, tuple(t.shape), t.dtype, t.device)
                     for path, t in ins),
               tuple((path, tuple(t.shape), t.dtype, t.data_ptr())
                     for path, t in st),
               tuple(sorted(static.items())))
        entry = self.entries.get(key)
        if entry is None:
            entry = _Entry(p, _map(torch.clone, inputs), state)
            if self.pool.cuda:
                with span(GRAPH_CAPTURE):
                    self._capture(entry, params, static)
            self.entries[key] = entry
            self.captures += 1
            ins = ()                     # the entry's buffers are a copy
        elif [t.data_ptr() for _, t in p] != entry.param_ptrs:
            raise ValueError(
                "the parameters are not the ones this step was captured "
                "with: a captured graph reads its parameters by address")
        t0 = time.perf_counter()
        with span(GRAPH_STEP):
            self._run(entry, ins, params, static)
        self.run_s += time.perf_counter() - t0
        return entry.out

    def _run(self, entry: _Entry, ins, params, static) -> None:
        """Copy ``ins`` into the entry's static buffers, then replay (on
        the CPU: call ``fn`` and copy its outputs into the static
        outputs)."""
        for (_, dst), (_, src) in zip(_leaves(entry.static_in), ins):
            if dst is not src:
                dst.copy_(src)
        if self.pool.cuda:
            entry.graph.replay()
            for (add, route), n in entry.launches.items():
                add(route, n)
            return
        out = self.fn(params, entry.static_in, entry.state, **static)
        if entry.out is None:
            entry.out = out
        else:
            for (_, dst), (_, src) in zip(_leaves(entry.out), _leaves(out)):
                if dst is not src:
                    dst.copy_(src)

    def _capture(self, entry: _Entry, params, static) -> None:
        """Warm up on the side stream (on clones of the state), then
        capture ``fn`` on it into the pool; the launches made under
        capture move from the counters to the entry."""
        pool, dev = self.pool, self.pool.device
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(dev)
        pool.stream.wait_stream(cur)
        with torch.cuda.stream(pool.stream):
            for _ in range(WARMUP):
                self.fn(params, entry.static_in,
                        _map(torch.clone, entry.state), **static)
                self.warmups += 1
        cur.wait_stream(pool.stream)
        self.warmup_s += time.perf_counter() - t0
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream):
            r0 = torch.cuda.memory_reserved(dev)
            entry.out = self.fn(params, entry.static_in, entry.state,
                                **static)
            pool.reserved += torch.cuda.memory_reserved(dev) - r0
        for (add, route), n in _launch_counts().items():
            n -= before[add, route]
            if n:
                entry.launches[add, route] = n
                add(route, -n)           # the capture launched nothing
        entry.graph = graph
        self.setup_s += time.perf_counter() - t0
