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
on each rank's own rows.  ``tree_sds`` and the
activation constraints (``constrain``, ``activation_sharding``) are
ROADMAP Queue 1 item 1(b), slice (C).
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


def local_rows(fn: Callable, *xs):
    """``fn(*xs)`` run on each rank's rows.  With DTensor arguments, each
    keeps only the first one's splits of dim 0 (every other dim and any
    pending sum replicated, by name), ``fn`` runs on the local tensors,
    and its tensor result comes back as rows split the same way.  For row-
    independent code whose ops DTensor cannot always place (attention's
    batched products flatten (batch, head) into one dim)."""
    lead = next((x for x in xs if is_dtensor(x)), None)
    if lead is None:
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = lead.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in lead.placements]
    out = fn(*(x.redistribute(mesh, pl).to_local() if is_dtensor(x) else x
               for x in xs))
    return DTensor.from_local(out, mesh, pl, run_check=False)


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
