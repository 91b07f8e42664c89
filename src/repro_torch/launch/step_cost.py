"""FLOPs and bytes of one torch step: the counterpart of
``repro.launch.hlo_cost``.

The reference compiles a step and walks its HLO text; a torch step is
never compiled, so the port counts the aten ops the step dispatches, on
any device (the card, the CPU, or ``meta`` for a dry run), with
``StepCounter``, a ``TorchDispatchMode``.  hlo_cost's rules
(``hlo_cost.py:7-25``), mapped onto aten ops:

- FLOPs (``_op_flops``): a matmul-family op counts the formula
  ``torch.utils.flop_counter`` registers for it (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions: 2·|result|·Π(contracting), as
  hlo_cost's dots); the kernels' custom ops count their registered
  formulas (``kernels.flash_attention.k5_cost``,
  ``kernels.selective_scan.k6_cost``); every other op that computes
  counts |result|, hlo_cost's vector-op floor.  Views, allocations and
  copies into place count 0 (hlo_cost's ``_SKIP``).
- Bytes (``_op_bytes``): hlo_cost's ideal-fusion model.  A materializing
  op bills 2 × its result bytes (write + later read); a same-shape
  elementwise op or a dtype cast bills 0 (fused); an in-place copy bills
  2 × the bytes it writes (hlo_cost's dynamic-update-slice: the update,
  not the buffer); a step argument (parameters, optimizer state, batch,
  caches) bills its bytes once per step, at first use; a kernel's custom
  op bills its formula's bytes (each input read once, each output written
  once).
- Collectives: none on one device (``coll_bytes`` 0).
- Loops: a torch step runs its loops in Python, so every trip dispatches
  and is counted; hlo_cost's trip-count scaling is built in.

Everything is per device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import selective_scan as _ss

# ops that materialize their result even when it has as many elements as
# their largest operand: hlo_cost's ``_MATERIALIZE`` (dot, sort, gather,
# scatter, dynamic-slice/update, concatenate, pad, copy), by aten name;
# every op with a flop formula joins them.  A reduction materializes by
# its shape (fewer elements than its operand; hlo_cost's ``reduce``).  A
# softmax is left out: XLA lowers it to two row reductions (results 1/S of
# the input) and elementwise ops it fuses into the consumer
_MATERIALIZE = {
    "sort", "topk", "argsort", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index", "index_select", "index_put", "index_add",
    "_index_put_impl", "embedding", "embedding_dense_backward", "cat",
    "stack", "constant_pad_nd", "clone", "repeat", "masked_scatter",
    "nonzero", "unique", "_unique2", "cumsum", "cumprod", "searchsorted",
    "select_backward", "slice_backward", "_unsafe_index", "one_hot",
}
# reads that fetch rows of an operand: hlo_cost clamps every source read
# to the consumer's result size because there a dynamic-slice of a
# stacked weight names the whole stack; in a torch step that slice is a
# view already, so a view's own bytes are what it reads, and only these
# ops read less than their operand
_GATHER = {"embedding", "index_select", "index", "gather", "_unsafe_index"}
# allocations: a result with no computed value (hlo_cost's constant /
# iota / parameter)
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
          "ones_like", "new_ones", "full", "full_like", "new_full",
          "scalar_tensor", "arange", "linspace", "detach", "alias",
          "lift_fresh", "lift_fresh_copy", "_local_scalar_dense"}
# the kernels' custom ops: their (FLOPs, bytes) formulas
_KERNELS: Dict[Any, Callable] = {
    torch.ops.repro_torch.flash_attention: _fa.flash_attention_cost,
    torch.ops.repro_torch.selective_scan: _ss.selective_scan_cost,
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_per_kind: Dict[str, float] = dataclasses.field(default_factory=dict)


def tensors(tree) -> list:
    """The tensors among a tree's leaves (dicts, lists, tuples)."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _extent(t: torch.Tensor) -> Tuple[int, int]:
    """[first, last + 1) byte of the storage a view spans."""
    es = t.element_size()
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride())) \
        if t.numel() else 0
    return t.storage_offset() * es, (t.storage_offset() + span) * es


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _is_view(func) -> bool:
    return func.is_view or func._overloadpacket.__name__ in (
        "_unsafe_view", "view", "reshape", "expand", "as_strided")


def _op_flops(func, args, kwargs, out) -> float:
    """hlo_cost's FLOPs for one aten op (see the module docstring)."""
    packet = func._overloadpacket
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    name = packet.__name__
    if _is_view(func) or name in _ALLOC or name == "copy_":
        return 0.0
    return float(sum(t.numel() for t in tensors(out)))


def _op_bytes(func, args, kwargs, out, read_args: Callable) -> float:
    """hlo_cost's ideal-fusion bytes for one aten op.

    - a kernel's custom op: its formula's bytes (inputs read once,
      outputs written once);
    - views and allocations: 0 (layout ops and constants);
    - every other op first bills the step arguments it reads for the
      first time (``read_args``: parameter / loop-carried reads, once per
      buffer); then a materializing op (a flop formula, ``_MATERIALIZE``)
      or one whose result has more or fewer elements than its largest
      operand (a broadcast, a reduction) bills 2 × its result bytes, or,
      in place (an aten name ending in ``_``: ``copy_``, ``index_put_``),
      2 × the bytes of its operands but the buffer it writes
      (dynamic-update-slice bills the update, not the buffer); a
      same-shape elementwise op or a cast bills nothing more (fused)."""
    packet = func._overloadpacket
    if packet in _KERNELS:
        return float(_KERNELS[packet](*args, **kwargs)[1])
    name = packet.__name__
    if _is_view(func) or name in _ALLOC:
        return 0.0
    outs = tensors(out)
    res_bytes = sum(_nbytes(t) for t in outs)
    ins = tensors((args, kwargs))
    b = float(read_args(ins, res_bytes if name in _GATHER else None))
    res_elems = sum(t.numel() for t in outs)
    moe = max((t.numel() for t in ins), default=0)
    if not (packet in flop_registry or name.rstrip("_") in _MATERIALIZE
            or name == "copy_" or res_elems != moe):
        return b                        # fused elementwise or cast
    if name.endswith("_"):
        # in place (a cache or state update): the update, not the buffer
        return b + 2.0 * sum(_nbytes(t) for t in ins[1:])
    return b + 2.0 * res_bytes


class StepCounter(TorchDispatchMode):
    """Counts the ``Cost`` of every aten op dispatched inside it.

    ``arguments`` are the step's argument trees (parameters, optimizer
    state, batch, caches): their bytes are billed once each, at first use.
    ``by_op`` holds {op name: [calls, FLOPs, bytes]}."""

    def __init__(self, *arguments):
        super().__init__()
        self.cost = Cost()
        self.by_op: Dict[str, list] = {}
        # argument storages -> byte ranges already billed
        self._unread: Dict[int, list] = {
            _storage(t): [] for t in tensors(arguments)}

    def _read_args(self, ins, clamp) -> int:
        b = 0
        for t in ins:
            billed = self._unread.get(_storage(t))
            if billed is None:
                continue
            if clamp is not None:       # a gather: the rows it fetched
                b += min(_nbytes(t), clamp)
                continue
            lo, hi = _extent(t)
            new = hi - lo
            for a, z in billed:
                new -= max(0, min(hi, z) - max(lo, a))
            if new > 0:
                billed.append((lo, hi))
                b += min(new, _nbytes(t))
        return b

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func._overloadpacket not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        f = _op_flops(func, args, kwargs, out)
        b = _op_bytes(func, args, kwargs, out, self._read_args)
        self.cost.flops += f
        self.cost.bytes += b
        rec = self.by_op.setdefault(func._overloadpacket.__name__,
                                    [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += f
        rec[2] += b
        return out


def count_step(fn: Callable, *arguments) -> Tuple[Any, Cost]:
    """(``fn()``, its ``Cost``), with ``arguments`` the step's argument
    trees."""
    with StepCounter(*arguments) as c:
        out = fn()
    return out, c.cost
