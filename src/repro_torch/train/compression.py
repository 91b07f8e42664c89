"""Compressed gradient mean over the pod axis (twin of
``repro.train.compression``).

Multi-pod layout: params and optimizer state shard *within* a pod and
replicate *across* pods, so the per-step cross-pod traffic is one
gradient mean over the slow links between pods.  Each function takes a
tree of gradients and the pod axis's process group
(``mesh.get_group("pod")``) and returns the mean over the group's ranks.

- ``compressed_psum_mean``: per-rank symmetric int8 quantization (one
  scale per tensor, ``max|g| / 127`` floored at 1e-20, round half to
  even, clip to +-127), an ``all_gather_into_tensor`` of the **int8**
  payload and of the f32 scales, then each rank dequantizes and sums the
  gathered rows in rank order and divides by n.  Error <= max|g| / 127
  per element.
- ``int16_psum_mean``: one scale shared by the ranks (``all_reduce(MAX)``
  of theirs), int16 values summed exactly (127 x 256 < 2^15: exact for up
  to 256 ranks).  Neither gloo nor NCCL reduces int16, so the sum is
  written out as a reduce-scatter and an all-gather with 2-byte elements
  on the wire: the int16 payload travels as bytes (``.view(torch.uint8)``)
  through ``all_to_all_single`` (rank j receives every rank's block j),
  each rank sums its block in int32 and casts back to int16, and an
  ``all_gather_into_tensor`` of the summed blocks, again as bytes, gives
  every rank the whole sum.  Widening to int32 or f32 would lose the
  halving against f32 the function exists for.
- ``psum_mean``: the uncompressed f32 ``all_reduce`` / n.

A DTensor leaf (a gradient sharded over the pod's data / model axes) is
quantized with the scale of the whole tensor, as the reference's per-pod
``max`` over its auto axes is; the pod collectives then move each rank's
local shard, and the result keeps the leaf's placements.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import is_dtensor, tree_map


def _local(g: torch.Tensor):
    """(plain f32 local values, rewrap) of a leaf."""
    if not is_dtensor(g):
        return g.float(), lambda x: x.to(g.dtype)
    from torch.distributed.tensor import DTensor

    def rewrap(x):
        return DTensor.from_local(x.to(g.dtype), g.device_mesh,
                                  g.placements, shape=g.shape,
                                  stride=g.stride(), run_check=False)
    return g.to_local().float(), rewrap


def _amax(g: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """max|g| over the whole tensor (over its mesh for a DTensor), f32."""
    if local.numel() == 0:
        m = torch.zeros((), dtype=torch.float32, device=local.device)
    else:
        m = torch.amax(torch.abs(local))
    if is_dtensor(g):
        for d in range(g.device_mesh.ndim):
            dist.all_reduce(m, op=dist.ReduceOp.MAX,
                            group=g.device_mesh.get_group(d))
    return m


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax / 127.0, 1e-20)


def _quantize(gf: torch.Tensor, scale: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    return torch.clamp(torch.round(gf / scale), -127, 127).to(dtype)


def compressed_psum_mean(tree, group=None):
    """Mean-reduce a tree over ``group``'s ranks with an int8 wire
    format."""
    n = dist.get_world_size(group)

    def one(g):
        gf, rewrap = _local(g)
        scale = _scale(_amax(g, gf))
        q = _quantize(gf, scale, torch.int8)
        qs = torch.empty(n * q.numel(), dtype=torch.int8, device=q.device)
        dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)
        qs = qs.view((n,) + tuple(q.shape))
        ss = torch.empty((n,), dtype=torch.float32, device=q.device)
        dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
        acc = qs[0].float() * ss[0]
        for i in range(1, n):
            acc = acc + qs[i].float() * ss[i]
        return rewrap(acc / n)

    return tree_map(one, tree)


def _sum_int16(q: torch.Tensor, group, n: int) -> torch.Tensor:
    """Exact sum over the group of an int16 tensor, 2 bytes an element on
    the wire: a reduce-scatter by ``all_to_all_single`` of row blocks and
    an ``all_gather_into_tensor`` of the summed blocks, both moving the
    int16 values as bytes."""
    flat = q.reshape(-1)
    size = flat.numel()
    block = -(-size // n)
    if block * n != size:
        flat = torch.cat([flat, flat.new_zeros(block * n - size)])
    recv = torch.empty(n * block * 2, dtype=torch.uint8, device=q.device)
    dist.all_to_all_single(recv, flat.contiguous().view(torch.uint8),
                           group=group)
    mine = recv.view(torch.int16).reshape(n, block)
    part = mine[0].to(torch.int32)
    for i in range(1, n):
        part = part + mine[i].to(torch.int32)
    part = part.to(torch.int16)
    out = torch.empty(n * block * 2, dtype=torch.uint8, device=q.device)
    dist.all_gather_into_tensor(out, part.view(torch.uint8), group=group)
    return out.view(torch.int16)[:size].reshape(q.shape)


def int16_psum_mean(tree, group=None):
    """Quantized mean with int16 accumulation and one shared scale."""
    n = dist.get_world_size(group)

    def one(g):
        gf, rewrap = _local(g)
        scale = _scale(_amax(g, gf))
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _quantize(gf, scale, torch.int16)
        s = _sum_int16(q, group, n)
        return rewrap(s.float() * scale / n)

    return tree_map(one, tree)


def psum_mean(tree, group=None):
    """Uncompressed f32 mean over ``group``."""
    n = dist.get_world_size(group)

    def one(g):
        gf, rewrap = _local(g)
        s = gf.clone()
        dist.all_reduce(s, group=group)
        return rewrap(s / n)

    return tree_map(one, tree)
