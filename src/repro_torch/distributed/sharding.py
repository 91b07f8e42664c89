"""Declarative parameters and their initialisation (twin of the
``Param`` / ``_init_one`` / ``init_tree`` part of
``repro.distributed.sharding``).

A ``Param`` carries a shape, the logical axis names the JAX package shards
by, an init recipe and a dtype.  On one card every sharding rule is the
identity, so the logical axes are kept only as documentation of the layout;
the mesh rules and ``constrain`` come with the launch layer (ROADMAP
Queue 1 item 5).  ``init_tree`` draws every leaf from one
``torch.Generator`` on the target device, leaf by leaf in sorted key order,
so the same seed gives the same parameters on the same device.
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
