"""Declarative parameters, their initialisation, the logical-axis
sharding rules and their layout on a mesh of ranks (twin of
``repro.distributed.sharding``).

A ``Param`` carries a shape, the logical axis names the JAX package shards
by, an init recipe and a dtype.  ``Rules`` maps each logical name to its
prioritized candidate mesh axes, as pure data: the same table as the
reference's (``DEFAULT_RULES``, ``with_overrides``, ``candidates``).
``init_tree`` draws every leaf from one ``torch.Generator`` on the target
device, leaf by leaf in sorted key order, so the same seed gives the same
parameters on the same device.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the reference's
axis names (one process, one device per rank), or a ``MeshShape``, its
names and sizes with no processes behind it (the reference's
``AbstractMesh``).  ``resolve_spec`` maps logical axes to mesh axes by the
reference's greedy, divisibility-checked, no-reuse walk and returns a
``PartitionSpec``-like tuple; ``placements`` turns a spec into DTensor
placements, ``tree_shardings`` gives a tree of ``Sharding(mesh,
placements)``, ``distribute_tree`` / ``local_tree`` lay a tree of tensors
out as DTensors and gather it back.  ``ensemble_mesh`` factors the ranks
into the simulator ensemble's ``("e", "n")`` mesh.  ``gather_last`` and
``local_rows`` run the training forward's ops that DTensor cannot place
on each rank's own rows; ``reshape`` replicates the splits a view
cannot keep.

``tree_sds`` is the dry run's currency (the reference's sharded
``ShapeDtypeStruct``s): a tree of meta DTensors, each rank's local shard
of the resolved spec, no memory behind them.  ``constrain`` /
``constrain_pref`` are the reference's activation constraints: a
redistribute of a DTensor to the placements its logical axes resolve to
on the mesh of the open ``activation_sharding`` context, and the
argument untouched outside one, on a mesh of one rank, or on a plain
tensor.  Inside the pod route (a DTensor on the mesh's non-pod submesh,
the reference's ``shard_map`` manual over ``"pod"``) the constraint
resolves on that submesh, the manual axes excluded (``_effective_mesh``,
``_manual_axes``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Param:
    """Declarative parameter: shape + logical axes + init recipe."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"
    # ^ fan_in | fan_last | zeros | ones | embed | small | s4d | dt
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    def stack(self, n: int) -> "Param":
        """Add a leading (unsharded) layer-stack dimension."""
        return dataclasses.replace(
            self, shape=(n, *self.shape), axes=(None, *self.axes))


# logical axis -> candidate mesh-axis tuples, first fit wins.
# () means "replicate" and always fits.  The reference's table.
DEFAULT_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    # data-parallel / fsdp family ("fsdp" excludes the "pod" axis: params
    # and optimizer state shard within a pod and replicate across pods)
    "batch":   (("pod", "data"), ("data",), ()),
    "fsdp":    (("data",), ()),
    # tensor-parallel family
    "tp":      (("model",), ()),
    "vocab":   (("model",), ("data",), ()),   # embedding rows
    "experts": (("model",), ()),
    # activations
    "seq":     ((),),                          # train-time sequence (replicated)
    "sp_seq":  (("model",), ()),               # sequence-parallel residual stream
    "kv_seq":  (("model",), ("data",), ()),    # decode KV-cache sequence dim
    "kv_heads": (("model",), ()),
    "heads":   (("model",), ()),
    "d_model": ((),),
    "ssm_inner": (("model",), ()),
    "state":   ((),),
}


@dataclasses.dataclass(frozen=True)
class Rules:
    table: Dict[str, Tuple[Tuple[str, ...], ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **kw) -> "Rules":
        t = dict(self.table)
        t.update(kw)
        return Rules(t)

    def candidates(self, name: str):
        if name is None:
            return ((),)
        cands = self.table.get(name, ((),))
        # Always allow full replication as terminal fallback.
        return tuple(cands) + ((),) if () not in cands else tuple(cands)


# ---------------------------------------------------------------------------
# Meshes and specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes with no processes behind it (the
    reference's ``AbstractMesh``): what ``resolve_spec`` needs, for mesh
    shapes no machine here has (the (16, 16) production pod)."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.names) != len(self.sizes):
            raise ValueError(f"names {self.names} vs sizes {self.sizes}")

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


Spec = Tuple[Any, ...]      # per dim: None, one axis name, or a tuple


def resolve_spec(shape: Sequence[int],
                 axes: Sequence[Optional[str]],
                 mesh,
                 rules: Rules = Rules(),
                 exclude: frozenset = frozenset()) -> Spec:
    """Resolve logical axes -> a spec for this mesh, greedily, with
    divisibility and no-reuse constraints, in the reference's order.
    ``exclude`` removes mesh axes from consideration.  Each entry is
    ``None`` (replicated), one mesh axis name, or a tuple of names (the
    dim split over several axes, the first outermost)."""
    sizes = mesh_axis_sizes(mesh)
    used: set = set(exclude)
    out = []
    for dim, name in zip(shape, axes):
        chosen: Tuple[str, ...] = ()
        for cand in rules.candidates(name):
            cand = tuple(a for a in cand if a in sizes)
            if not cand:
                if name is None or not rules.candidates(name):
                    break
                continue
            if any(a in used for a in cand):
                continue
            n = math.prod(sizes[a] for a in cand)
            if n > 1 and dim % n != 0:
                continue
            chosen = cand
            break
        used.update(chosen)
        if len(chosen) == 0:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(chosen)
    return tuple(out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: for each mesh dimension,
    ``Shard(d)`` where tensor dim ``d`` names it and the axis has more
    than one rank, else ``Replicate()``.  A dim split over several axes
    nests in mesh order, the earlier mesh axis outermost: the reference's
    order for ``("pod", "data")``."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} splits over {entry}, not in the "
                             f"mesh's axis order {tuple(names)}")
        for i in idx:
            # a size-1 axis splits nothing: replicated, the same layout
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """Each rank's local shape of a tensor laid out by ``spec`` (the
    reference's ``NamedSharding.shard_shape``; ``resolve_spec`` only
    picks splits that divide)."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(d // math.prod(sizes[a] for a in spec_axes(e))
                 for d, e in zip(shape, spec))


class Sharding(NamedTuple):
    """A leaf's layout: its mesh and DTensor placements (the reference's
    ``NamedSharding``)."""
    mesh: Any
    placements: tuple


def _is_param(x) -> bool:
    return isinstance(x, Param)


def tree_specs(template, mesh, rules: Rules = Rules()):
    return tree_map(lambda p: resolve_spec(p.shape, p.axes, mesh, rules),
                    template)


def tree_shardings(template, mesh, rules: Rules = Rules()):
    return tree_map(
        lambda p: Sharding(mesh, placements(
            resolve_spec(p.shape, p.axes, mesh, rules), mesh)), template)


def meta_dtensor(shape: Sequence[int], dtype: torch.dtype, mesh,
                 spec: Spec):
    """A meta DTensor of global ``shape`` laid out by ``spec`` on the
    ``DeviceMesh`` ``mesh``: this rank's local shard, no memory."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(shard_shape(shape, spec, mesh), dtype=dtype,
                        device="meta")
    glob = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              shape=glob.shape, stride=glob.stride(),
                              run_check=False)


def tree_sds(template, mesh, rules: Rules = Rules()):
    """Meta DTensors with shardings: the dry-run currency (no memory).
    Each leaf's local shard has the reference's per-device shape."""
    return tree_map(lambda p: meta_dtensor(
        p.shape, p.dtype, mesh, resolve_spec(p.shape, p.axes, mesh, rules)),
        template)


def distribute_tree(tree, shardings, *, src_rank: Optional[int] = 0):
    """Lay a tree of full tensors out as DTensors by a same-structure tree
    of ``Sharding`` (a ``None`` sharding keeps the leaf as it is).  The
    values are rank ``src_rank``'s (scattered from it); ``src_rank=None``
    takes each rank's own tensor without communication, for trees every
    rank drew from one seed."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh):
        if sh is None:
            return t
        return distribute_tensor(t, sh.mesh, list(sh.placements),
                                 src_data_rank=src_rank)
    return tree_map(one, tree, shardings)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated_local(x: torch.Tensor) -> torch.Tensor:
    """The full value of a DTensor as a plain tensor on every rank of its
    mesh (a redistribute to ``Replicate()`` on every mesh dimension); a
    plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.collectives import on_mesh
    with on_mesh(x):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim).to_local()


def local_tree(tree):
    """The full values of a tree of DTensors as plain tensors on every rank
    (``distribute_tree`` the other way); plain leaves pass through."""
    return tree_map(replicated_local, tree)


# the mesh axes a parameter is stored split over but used whole (the
# "fsdp" family of DEFAULT_RULES and the batch axes)
_FSDP_AXES = ("pod", "data")


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, pl):
        ctx.mesh, ctx.pl = p.device_mesh, tuple(p.placements)
        if list(pl) == list(p.placements):
            return p.view_as(p)
        return p.redistribute(p.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.pl:
            g = g.float().redistribute(ctx.mesh, ctx.pl).to(g.dtype)
        return g, None


def unshard_fsdp(p: torch.Tensor) -> torch.Tensor:
    """A parameter as a step uses it: its splits over ``data`` (and
    ``pod``) gathered, those over ``model`` kept (a plain tensor as it
    is); ``Model`` applies it to every parameter it is given.  Gathering
    at use is FSDP's plan.  The gradient's pending
    sums come back here unreduced (``matmul`` and ``whole_local`` leave a
    weight's gradient as a partial sum) and are reduced once, in f32, to
    the parameter's placements: a reduce-scatter for a split parameter,
    an all-reduce for a replicated one, as the reference syncs its f32
    gradients.  Left to itself DTensor's matmul rule splits the
    activation's contracted dim instead and carries partial sums into
    the logits."""
    if not is_dtensor(p):
        return p
    from torch.distributed.tensor import Replicate, Shard
    names = p.device_mesh.mesh_dim_names
    pl = [Replicate() if isinstance(q, Shard) and n in _FSDP_AXES else q
          for n, q in zip(names, p.placements)]
    return _Unshard.apply(p, pl)


def gather_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index]`` for one index per row: ``torch.gather`` along the
    last dim.  On a DTensor it runs as a local op: ``x``'s last dim and
    any pending sums are replicated, ``index`` takes ``x``'s row
    placements, and each rank gathers its own rows (DTensor's own gather
    rule mishandles rows split over two mesh axes)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, index[..., None].long())[..., 0]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim % x.ndim != x.ndim - 1
          else Replicate() for p in x.placements]
    x = x.redistribute(mesh, pl)
    if not is_dtensor(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    index = index.redistribute(mesh, pl)
    out = torch.gather(x.to_local(), -1,
                       index.to_local()[..., None].long())[..., 0]
    return DTensor.from_local(out, mesh, pl, shape=index.shape,
                              stride=index.stride(), run_check=False)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., D) and a weight w (D, F).  DTensor runs a
    batched matmul as a matmul of x flattened to (rows, D), and its
    backward flattens the output's gradient the same way, which torch
    2.11 refuses when a middle dim is split (the sequence split of
    sequence parallelism, on top of the batch split; a constraint
    downstream can split the gradient so).  A DTensor x of 3 or more
    dims is multiplied here as local shards instead: per mesh dim, rows
    of x split against w whole give rows split; x whole against w's
    columns split gives columns split; x's contracted dim against w's
    rows split alike (either one split for free) gives a partial sum,
    reduced at once.  The gradients of the shards are declared to match
    (a weight's gradient from split rows is a partial sum), and the
    output's gradient comes back to the output's placements first."""
    if not (is_dtensor(x) and x.ndim >= 3):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, nd = x.device_mesh, x.ndim
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    xp, wp, op, gx, gw = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        a_dim = a.dim % nd if isinstance(a, Shard) else None
        b_dim = b.dim % 2 if isinstance(b, Shard) else None
        if a_dim is not None and a_dim < nd - 1:
            # rows split: w whole; w's gradient a partial sum
            pl = (Shard(a_dim), Replicate(), Shard(a_dim), Shard(a_dim),
                  Partial())
        elif b_dim == 1 and a_dim is None:
            # w's columns split, x whole: x's gradient a partial sum
            pl = (Replicate(), Shard(1), Shard(nd - 1), Partial(),
                  Shard(1))
        elif a_dim == nd - 1 or b_dim == 0:
            # the contracted dim split alike: a partial sum
            pl = (Shard(nd - 1), Shard(0), Partial(), Shard(nd - 1),
                  Shard(0))
        else:
            pl = (Replicate(),) * 5
        for lst, q in zip((xp, wp, op, gx, gw), pl):
            lst.append(q)
    x = x.redistribute(mesh, xp)
    if list(w.placements) != wp:
        # (left out where w is already so: its gradient's partial sum
        # then goes back unreduced, to be reduced by ``unshard_fsdp``)
        w = w.redistribute(mesh, wp)
    out = x.to_local(grad_placements=gx) @ w.to_local(grad_placements=gw)
    glob = torch.empty(tuple(x.shape[:-1]) + (w.shape[1],), device="meta")
    out = DTensor.from_local(out, mesh, op, shape=glob.shape,
                             stride=glob.stride(), run_check=False)
    if any(isinstance(q, Partial) for q in op):
        # the partial sum reduced once, here (Megatron's row-parallel
        # all-reduce), not again by each op that reads it
        out = out.redistribute(mesh, [Replicate() if isinstance(q, Partial)
                                      else q for q in op])
    return out


def lookup_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for a DTensor table (an embedding lookup): the
    table gathered whole, each rank looking up its own index rows, the
    result split as the index is.  The gradient of the whole table is a
    partial sum over the axes that split the index, reduced back to the
    table's placements.  (DTensor's own index rule refuses a batch-split
    index on torch 2.11, and its embedding rule's masked partial sum
    cannot be reduce-scattered.)"""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = table.device_mesh
    if not is_dtensor(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    out = whole_local(table, index)[index.to_local()]
    return DTensor.from_local(out, mesh, index.placements, run_check=False)


def whole_local(t: torch.Tensor, used_by: torch.Tensor) -> torch.Tensor:
    """DTensor ``t`` gathered whole as this rank's plain tensor, for use
    with ``used_by``'s local shard (a weight read by each rank's rows):
    its gradient is a partial sum over the mesh dims that split
    ``used_by``, reduced back to ``t``'s placements where ``t`` is split
    and left pending for ``unshard_fsdp`` where it is whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = t.device_mesh
    grads = [Partial() if isinstance(p, Shard) else Replicate()
             for p in used_by.placements]
    whole = [Replicate()] * mesh.ndim
    if list(t.placements) != whole:
        t = t.redistribute(mesh, whole)
    return t.to_local(grad_placements=grads)


def write_rows(cache: torch.Tensor, slot: torch.Tensor,
               value: torch.Tensor) -> None:
    """``cache[b, slot[b]] = value[b]`` for every row b, in place: a
    decode step's KV-cache write.  On a DTensor cache (rows and cache
    positions split) each rank writes the entries it holds, as the owner
    of a node buffer applies a scatter; ``value`` (B, ...) and ``slot``
    (B,) are taken whole."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    if not is_dtensor(cache):
        cache[rows, slot] = value
        return
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local = cache.to_local()
    shape, off = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    if is_dtensor(value):
        value = value.full_tensor()
    if is_dtensor(slot):
        slot = slot.full_tensor()
    r = torch.arange(shape[0], device=local.device)
    pos = slot[off[0]:off[0] + shape[0]] - off[1]
    own = (pos >= 0) & (pos < shape[1])
    cur = local[r, pos.clamp(0, shape[1] - 1)]
    new = value[off[0]:off[0] + shape[0]]
    new = new[(slice(None),) + tuple(slice(o, o + n) for o, n in
                                     zip(off[2:], shape[2:]))]
    local[r, pos.clamp(0, shape[1] - 1)] = torch.where(
        own.view((-1,) + (1,) * (cur.dim() - 1)), new.to(local.dtype), cur)


def _placeable_view(x, shape):
    if not x.is_contiguous():
        # DTensor runs a reshape as a view of the local shard
        x = x.contiguous()
    try:
        return x.reshape(shape)
    except RuntimeError:        # DTensor's view rule refused this layout
        from torch.distributed.tensor import Replicate, Shard
        first = 0
        while (first < min(len(shape), x.ndim)
               and shape[first] == x.shape[first]):
            first += 1
        pl = [Replicate() if isinstance(p, Shard) and p.dim >= first else p
              for p in x.placements]
        return x.redistribute(x.device_mesh, pl).reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _placeable_view(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _placeable_view(g, ctx.in_shape), None


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``.  On a DTensor whose split dims the view
    cannot keep (a dim split 16 ways unflattened into 8 heads), forward
    and backward alike, those splits are replicated first, as XLA gathers
    where the reference's reshape meets a layout it cannot keep."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, tuple(shape))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local shard's
    gradient goes back into a DTensor, whose later views are views of
    the local shard (an einsum's gradient comes back permuted)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_rows(fn: Callable, *xs, dims: Tuple[int, ...] = (0,),
               rows_only: Tuple[int, ...] = ()):
    """``fn(*xs)`` run on each rank's rows.  With DTensor arguments, each
    keeps only the first one's splits of the ``dims`` (dim 0, the rows, by
    default; a split is kept where it divides that dim of every argument)
    and every other dim and any pending sum replicated, by name; ``fn``
    runs on the local tensors, and its tensor result (or each of a
    tuple's) comes back split the same way.  For code independent across
    those dims whose ops DTensor cannot always place (attention's batched
    products flatten (batch, head) into one dim; the kernels' custom ops
    have no DTensor rule).  The arguments at the positions ``rows_only``
    keep only the rows' split, every other dim whole (an operand that the
    other ``dims`` do not index, as SSD's B and C beside its heads): each
    rank's gradient of such an argument is a partial sum over the mesh
    dims that split the other ``dims``."""
    lead = next((x for x in xs if is_dtensor(x)), None)
    if lead is None:
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = lead.device_mesh
    ds = [x for j, x in enumerate(xs) if is_dtensor(x)
          and j not in rows_only]
    pl, split = [], {}
    for i, p in enumerate(lead.placements):
        n = split.get(p.dim, 1) * mesh.size(i) if isinstance(p, Shard) else 0
        if (isinstance(p, Shard) and p.dim in dims
                and all(x.shape[p.dim] % n == 0 for x in ds)):
            split[p.dim] = n
            pl.append(p)
        else:
            pl.append(Replicate())
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    sums = [r if r == p else Partial() for r, p in zip(rows, pl)]

    def local(j, x):
        if not is_dtensor(x):
            return x
        if j in rows_only:
            x = x.redistribute(mesh, rows).to_local(grad_placements=sums)
        else:
            x = x.redistribute(mesh, pl).to_local()
        return _ContiguousGrad.apply(x)

    out = fn(*(local(j, x) for j, x in enumerate(xs)))
    # contiguous: DTensor runs later views as views of the local shards
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o.contiguous(), mesh, pl,
                                        run_check=False) for o in out)
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False)


def pod_split(mesh):
    """(pod group, the mesh's other axes as a submesh or None, their
    names): the pod route, the reference's ``shard_map`` manual over
    ``"pod"``."""
    names = tuple(mesh.mesh_dim_names)
    rest = tuple(a for a in names if a != "pod")
    return mesh.get_group("pod"), (mesh[rest] if rest else None), rest


def to_submesh(x, sub, rest, *, batch: bool):
    """A full-mesh leaf as the same rank's values on the non-pod submesh:
    a parameter (replicated over pod) keeps its other placements; a batch
    leaf becomes this pod's rows, split over the submesh as before."""
    from torch.distributed.tensor import DTensor, Replicate
    names = tuple(x.device_mesh.mesh_dim_names)
    pl = dict(zip(names, x.placements))
    if not batch and not isinstance(pl["pod"], Replicate):
        raise ValueError(f"a parameter sharded over 'pod' ({x.placements});"
                         " the pod sync needs it replicated there")
    if sub is None:
        return x.to_local()
    return DTensor.from_local(x.to_local(), sub, [pl[a] for a in rest],
                              run_check=False)


def _world_size() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def ensemble_mesh(n_lanes: int, n_nodes: int, devices=None, *,
                  device_type: Optional[str] = None):
    """2D ``("e", "n")`` mesh for the fleet-ensemble simulator.

    Factors the device count greedily, as the reference does: ``e`` (the
    lane axis) takes the largest divisor of ``n_lanes`` that fits (lanes
    are independent trajectories, so every rank spent there is
    communication-free), and ``n`` (the fleet node axis) the largest
    divisor of ``n_nodes`` from what is left.  ``devices`` is a rank
    count or a list of devices; by default the ranks of the default
    process group.  Returns a ``DeviceMesh`` over the first ``e * n``
    ranks (``device_type``: the ranks' device, the card unless told
    otherwise), or a ``MeshShape`` when no process group is up.  One rank
    gives a 1x1 mesh ("do not shard")."""
    if devices is None:
        nd = _world_size()
    elif isinstance(devices, int):
        nd = devices
    else:
        nd = len(devices)
    ne = max((d for d in range(1, nd + 1) if n_lanes % d == 0), default=1)
    nn = max((d for d in range(1, nd // ne + 1) if n_nodes % d == 0),
             default=1)
    if not (dist.is_available() and dist.is_initialized()):
        return MeshShape(("e", "n"), (ne, nn))
    if ne * nn > dist.get_world_size():
        raise ValueError(f"an ({ne}, {nn}) ensemble mesh needs {ne * nn} "
                         f"ranks; the world has {dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh
    dtype = device_type or resolve_device(None).type
    return DeviceMesh(dtype, torch.arange(ne * nn).reshape(ne, nn),
                      mesh_dim_names=("e", "n"))


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (the parameter trees), with
    any further trees of the same structure passed alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted key order (``jax.tree.flatten``'s dict order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def stack_trees(trees: list) -> Dict[str, Any]:
    """Stack a list of same-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


# the largest block drawn from the generator at once: a larger leaf is
# drawn in flat blocks of this many values, so the f32 draw never holds a
# whole multi-GB leaf (falcon-mamba-7b's in_proj is 4.3e9 values,
# moonshot-v1-16b-a3b's expert weights 8.9e9 a leaf)
_DRAW_BLOCK = 1 << 26


def _normal(shape, std: float, gen: torch.Generator, dtype, device):
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _DRAW_BLOCK):
        draw = torch.randn(min(_DRAW_BLOCK, flat.numel() - i), generator=gen,
                           dtype=torch.float32, device=device)
        flat[i:i + draw.numel()] = draw.mul_(std)
    return out


def _init_one(p: Param, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init == "s4d":
        # S4D-real A_log: decay rates log-spaced 1..n along the last axis,
        # so each state channel owns a distinct timescale
        n = p.shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                     device=device) * p.scale)
        return row.expand(p.shape).to(p.dtype).contiguous()
    if p.init == "dt":
        # Mamba dt_bias: softplus(bias) log-uniform in [1e-3, 0.1]·scale
        lo, hi = math.log(1e-3), math.log(0.1)
        u = torch.rand(p.shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(lo + u * (hi - lo)) * p.scale
        return (dt + torch.log(-torch.expm1(-dt))).to(p.dtype)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    if p.init == "embed":
        std = p.scale
    elif p.init == "small":
        std = 0.02 * p.scale
    elif p.init == "fan_last":
        # (channels, taps) weights whose reduction axis is last
        # (depthwise conv): fan is the tap count
        std = p.scale / math.sqrt(max(p.shape[-1], 1))
    elif p.init == "fan_in":
        std = p.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init recipe {p.init!r}")
    return _normal(p.shape, std, gen, p.dtype, device)


def init_tree(template, seed: int = 0, *, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> Any:
    """Initialize a parameter tree from a template on ``device`` (the card
    unless told otherwise).  Deterministic in ``seed``, or draws from the
    given ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    out: Dict[str, Any] = {}

    def fill(node, dst):
        for k in sorted(node):
            if isinstance(node[k], dict):
                dst[k] = {}
                fill(node[k], dst[k])
            else:
                dst[k] = _init_one(node[k], generator, dev)

    fill(template, out)
    return out


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------
# Model code calls ``constrain(x, axes)``; it is a no-op unless the step
# runs inside ``activation_sharding(mesh, rules)``.  This is how the
# "optimized" dry-run mode pins activation layouts (batch->data/pod,
# heads/d_ff->model) without threading a mesh through every layer.


def _effective_mesh(mesh, x):
    """The mesh a constraint on ``x`` resolves on: ``x``'s own mesh (the
    pod route's submesh inside it, the reference's ambient abstract mesh
    of a ``shard_map`` region), else the context's."""
    return x.device_mesh if is_dtensor(x) else mesh


def _manual_axes(mesh, eff) -> frozenset:
    """The context mesh's axes that ``eff`` lacks: manual in the pod
    route (the reference's ``AxisType.Manual`` axes)."""
    if eff is mesh:
        return frozenset()
    return frozenset(mesh_axis_sizes(mesh)) - frozenset(mesh_axis_sizes(eff))


def _redistribute(x, spec, mesh):
    pl = placements(spec, mesh)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def logical_constraint(x: torch.Tensor, axes: Sequence[Optional[str]],
                       mesh, rules: Rules = Rules()) -> torch.Tensor:
    """``x`` redistributed to the placements its logical ``axes`` resolve
    to (no-op without a mesh, on a mesh of one rank, or on a plain
    tensor)."""
    if (mesh is None or math.prod(mesh_axis_sizes(mesh).values()) == 1
            or not is_dtensor(x)):
        return x
    eff = _effective_mesh(mesh, x)
    spec = resolve_spec(x.shape, tuple(axes), eff, rules,
                        exclude=_manual_axes(mesh, eff))
    return _redistribute(x, spec, eff)


_ACT_CTX: list = []


class activation_sharding:
    """Context in which ``constrain`` / ``constrain_pref`` pin layouts.
    ``moved`` counts the redistributes they issued in it (a constraint
    on a tensor already laid out so issues none)."""

    def __init__(self, mesh, rules: Rules = Rules()):
        self.mesh, self.rules, self.moved = mesh, rules, 0

    def __enter__(self):
        _ACT_CTX.append(self)
        return self

    def __exit__(self, *exc):
        _ACT_CTX.pop()
        return False


def current_activation_ctx():
    """(mesh, rules) inside ``activation_sharding``, else None."""
    return (_ACT_CTX[-1].mesh, _ACT_CTX[-1].rules) if _ACT_CTX else None


def _counted(ctx, x, y):
    if y is not x:
        ctx.moved += 1
    return y


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    if not _ACT_CTX:
        return x
    ctx = _ACT_CTX[-1]
    return _counted(ctx, x, logical_constraint(x, axes, ctx.mesh,
                                               ctx.rules))


def constrain_pref(x: torch.Tensor,
                   *options: Tuple[Optional[str], ...]) -> torch.Tensor:
    """Constrain with the most-sharded of several axis layouts (the first
    of equals): attention prefers heads over ``model`` but falls back to
    splitting query rows when the head count does not divide the TP
    degree (llama's 24 heads on 16)."""
    if not _ACT_CTX:
        return x
    ctx = _ACT_CTX[-1]
    mesh, rules = ctx.mesh, ctx.rules
    if (mesh is None or math.prod(mesh_axis_sizes(mesh).values()) == 1
            or not is_dtensor(x)):
        return x
    eff = _effective_mesh(mesh, x)
    manual = _manual_axes(mesh, eff)
    sizes = mesh_axis_sizes(eff)
    best, best_n = None, -1
    for axes in options:
        spec = resolve_spec(x.shape, tuple(axes), eff, rules, exclude=manual)
        n = math.prod(sizes[a] for e in spec for a in spec_axes(e))
        if n > best_n:
            best, best_n = spec, n
    return _counted(ctx, x, _redistribute(x, best, eff))
