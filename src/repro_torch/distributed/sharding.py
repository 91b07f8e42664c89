"""Declarative parameters, their initialisation and the logical-axis
sharding rules (twin of the ``Param`` / ``_init_one`` / ``init_tree`` /
``Rules`` part of ``repro.distributed.sharding``).

A ``Param`` carries a shape, the logical axis names the JAX package shards
by, an init recipe and a dtype.  ``Rules`` maps each logical name to its
prioritized candidate mesh axes, as pure data: the same table as the
reference's (``DEFAULT_RULES``, ``with_overrides``, ``candidates``).  On
one device every candidate resolves to replication, so the rules and the
logical axes change nothing in a one-card step; ``resolve_spec``,
``tree_specs``, ``ensemble_mesh`` and ``constrain`` need a mesh of more
than one device and wait for ROADMAP Queue 1 item 1(b).  ``init_tree``
draws every leaf from one ``torch.Generator`` on the target device, leaf
by leaf in sorted key order, so the same seed gives the same parameters
on the same device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

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
