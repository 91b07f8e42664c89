"""The collectives a sharded step issues: counted, and on gloo with CUDA
tensors run as eager c10d calls.

DTensor moves data through ``torch.distributed``'s functional collectives
(``_c10d_functional.all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``all_to_all_single``, ...).  Over a gloo group with CUDA
tensors those hang on the card (PyTorch 2.11, NVIDIA H100), while gloo's
eager collectives take the same CUDA tensors (gloo copies them through
host memory itself).  ``CollectiveMode`` is a dispatch mode that sees
every collective issued inside it:

- it counts the calls and the payload bytes (each call's input tensors)
  by op name, functional and eager alike, and each call's result bytes
  by the reference's kind and weight (``roofline.collective_bytes``: an
  all-reduce 2×, an all-gather, reduce-scatter or all-to-all 1×), the
  per-device collective bytes of the roofline (``CollectiveLog``);
- ``gloo_cuda_collective`` runs a functional collective as the eager
  c10d call with the same semantics, when and only when its group's
  backend is gloo and its tensor is on CUDA (``"avg"`` as a sum and a
  division: gloo has no average); its bytes are counted apart
  (``CollectiveLog.eager_bytes``).

Groups with one rank per card run NCCL, where the mode only counts.
``on_mesh(x)`` gives the mode where a tree's DTensors need it and a
no-op context elsewhere; the train step, the checkpoint's gather and
restore, and ``sharding.local_tree`` run under it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass
class CollectiveLog:
    """Calls and payload bytes by op name; ``eager_bytes`` for the
    functional collectives run by ``gloo_cuda_collective``; ``per_kind``
    the weighted result bytes by the reference's kind."""
    calls: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    bytes: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    eager_bytes: int = 0
    per_kind: Dict[str, float] = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def weighted_bytes(self) -> float:
        """The reference's ``collective_bytes``: per-device result bytes,
        an all-reduce counted twice."""
        return sum(self.per_kind.values())


# op name (functional, eager c10d, DTensor's own) -> the reference's HLO
# kind; its weight is roofline's (all-reduce 2x: a ring's reduce-scatter
# and all-gather phases)
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "gather_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast", "reduce_": "reduce",
    "scatter_": "scatter",
}
_WEIGHT = {"all-reduce": 2.0}


# the input position of each c10d (eager) op's payload
_C10D_INPUT = {"allreduce_": 0, "broadcast_": 0, "allgather_": 1,
               "_allgather_base_": 1, "allgather_into_tensor_coalesced_": 1,
               "reduce_scatter_": 1, "_reduce_scatter_base_": 1,
               "reduce_scatter_tensor_coalesced_": 1, "alltoall_base_": 1,
               "alltoall_": 1, "allreduce_coalesced_": 0, "reduce_": 0,
               "gather_": 1, "scatter_": 1}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)) and x:
        return _first_tensor(x[0])
    return None


def _group(name):
    if isinstance(name, dist.ProcessGroup):
        return name
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}


def _reduce(op: str):
    if op not in _OPS:
        raise NotImplementedError(f"reduce op {op!r}")
    return _OPS[op]


def _is_gloo(pg) -> bool:
    return dist.get_backend(pg) == "gloo"


def gloo_cuda_collective(name: str, args) -> object:
    """The functional collective ``name`` on ``args`` as eager c10d
    calls on the same CUDA tensors (for gloo groups)."""
    if name in ("all_gather_into_tensor_coalesced",
                "reduce_scatter_tensor_coalesced", "all_reduce_coalesced"):
        single = name.replace("_coalesced", "")
        return [gloo_cuda_collective(single, (t,) + tuple(args[1:]))
                for t in args[0]]
    x = args[0].contiguous()
    if name == "all_gather_into_tensor":
        n, pg = args[1], _group(args[2])
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pg)
        return out
    if name == "reduce_scatter_tensor":
        op, n, pg = args[1], args[2], _group(args[3])
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=_reduce(op), group=pg)
        return out / n if op == "avg" else out
    if name in ("all_reduce", "all_reduce_"):
        op, pg = args[1], _group(args[2])
        out = args[0] if name == "all_reduce_" else x.clone()
        dist.all_reduce(out, op=_reduce(op), group=pg)
        if op == "avg":
            out.div_(dist.get_world_size(pg))
        return out
    if name == "all_to_all_single":
        outs, ins, pg = list(args[1]), list(args[2]), _group(args[3])
        out = x.new_empty((sum(outs),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, outs, ins, group=pg)
        return out
    if name == "broadcast":
        src, pg = args[1], _group(args[2])
        out = x.clone()
        dist.broadcast(out, dist.get_global_rank(pg, src), group=pg)
        return out
    raise NotImplementedError(f"functional collective {name!r}")


_FUNCTIONAL = ("_c10d_functional", "_c10d_functional_autograd")
_PASS = ("wait_tensor", "_wrap_tensor_autograd")
# the group argument's position in each functional op (the autograd
# namespace's ops take the same arguments)
_GROUP_ARG = {"all_gather_into_tensor": 2, "reduce_scatter_tensor": 3,
              "all_reduce": 2, "all_reduce_": 2, "all_to_all_single": 3,
              "broadcast": 2, "all_gather_into_tensor_coalesced": 2,
              "reduce_scatter_tensor_coalesced": 3,
              "all_reduce_coalesced": 2}


def collective_name(func) -> Optional[str]:
    """The op name of a collective this module counts (functional, eager
    c10d, DTensor's all-to-all), else None."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ((ns in _FUNCTIONAL and name in _GROUP_ARG)
            or (ns == "_dtensor" and name == "shard_dim_alltoall")
            or (ns == "c10d" and name in _C10D_INPUT)):
        return name
    return None


def record(log: CollectiveLog, func, args, out) -> None:
    """Bill collective ``func``'s call, payload and weighted result bytes
    to ``log`` (an eager c10d op's result is its first argument)."""
    name = collective_name(func)
    eager = func.namespace == "c10d"
    log.calls[name] += 1
    log.bytes[name] += _nbytes(args[_C10D_INPUT[name]] if eager else args[0])
    kind = _KIND[name]
    log.per_kind[kind] += (_nbytes(args[0] if eager else out)
                           * _WEIGHT.get(kind, 1.0))


class CollectiveMode(TorchDispatchMode):
    """Counts the collectives issued inside it into ``log`` and runs the
    functional ones on CUDA tensors of gloo groups eagerly."""

    def __init__(self, log: Optional[CollectiveLog] = None):
        super().__init__()
        self.log = log if log is not None else CollectiveLog()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar the op first: its collectives then come
            # back through this mode on plain tensors
            return NotImplemented
        kwargs = kwargs or {}
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if collective_name(func) is not None:
            t = _first_tensor(args[0])
            if (ns in _FUNCTIONAL and t is not None and t.is_cuda
                    and _is_gloo(_group(args[_GROUP_ARG[name]]))):
                self.log.eager_bytes += _nbytes(args[0])
                out = gloo_cuda_collective(name, args)
            else:
                out = func(*args, **kwargs)
            record(self.log, func, args, out)
            return out
        if (ns in _FUNCTIONAL and name not in _PASS
                and any(isinstance(a, torch.Tensor) and a.is_cuda
                        for a in args) and _is_gloo(None)):
            # never hand gloo a functional collective on CUDA tensors
            raise NotImplementedError(
                f"{ns}.{name} on CUDA tensors over gloo has no eager form")
        return func(*args, **kwargs)


# the logs of the open ``counting`` contexts, innermost last: a nested
# ``on_mesh`` leaves the collectives to the open mode, which counts them
_ACTIVE: list = []


@contextlib.contextmanager
def counting(log: Optional[CollectiveLog] = None):
    """Count every collective issued inside (and run the gloo + CUDA ones
    eagerly); yields the ``CollectiveLog``."""
    log = log if log is not None else CollectiveLog()
    _ACTIVE.append(log)
    try:
        with CollectiveMode(log):
            yield log
    finally:
        _ACTIVE.pop()


def on_mesh(x):
    """``counting()`` where DTensor ``x`` needs it (on CUDA over a gloo
    default group) and no counting context is open; a no-op context
    elsewhere."""
    from torch.distributed.tensor import DTensor
    if (not _ACTIVE and isinstance(x, DTensor) and x.device.type == "cuda"
            and dist.is_initialized() and _is_gloo(None)):
        return counting()
    return contextlib.nullcontext()
