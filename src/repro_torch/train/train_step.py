"""The training step: grads (+ microbatching) -> cross-pod sync -> AdamW
(twin of ``repro.train.train_step``).

``make_train_step`` builds a (state, batch) -> (state, metrics) function.
The state's tensors are plain (one device) or DTensors laid out on a
``DeviceMesh`` by ``distributed.sharding.tree_shardings``; the batch is
laid out the same way (``("batch", None)``).  Options:

- ``microbatches``: gradient accumulation over batch slices, summed in
  f32 (activation memory ∝ batch / microbatches under remat);
- ``grad_sync``: ``"auto"`` — DTensor's sharding propagation places the
  collectives, as GSPMD does in the reference: the model's forward and
  backward run on the DTensors as on local tensors, and each gradient
  comes back at its parameter's placements, reduced once over the batch
  axes in f32 (``sharding.unshard_fsdp``, which ``Model`` applies);
  ``"int8"`` / ``"int16"`` / ``"fp32"`` — the reference's explicit pod
  reduction (its ``shard_map`` over ``"pod"``): the grads are computed on
  the pod-local batch over the mesh's other axes, then mean-reduced over
  the pod group by ``train.compression``, and the metrics are averaged
  over the pod group.  These need a mesh with a ``"pod"`` axis, as the
  reference asserts.

Training runs no kernel (as the reference trains through plain jnp), so
the missing DTensor rules of K5 / K6 never come up.  Where DTensor cannot
place an op of the training forward, the model runs it on each rank's own
rows after a redistribute by name (``sharding.gather_last``: the gold
logit; ``sharding.local_rows``: attention's batched products).  On CUDA
over gloo (ranks sharing one card) the step runs under
``distributed.collectives``' mode.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.collectives import on_mesh
from repro_torch.distributed.sharding import (is_dtensor, pod_split,
                                              replicated_local, to_submesh,
                                              tree_leaves, tree_map)
from repro_torch.models.model import Model
from repro_torch.train.compression import (compressed_psum_mean,
                                           int16_psum_mean, psum_mean)
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt

GRAD_SYNCS = ("auto", "int8", "int16", "fp32")


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor          # () int32, on the parameters' device

    @staticmethod
    def create(params) -> "TrainState":
        dev = tree_leaves(params)[0].device
        return TrainState(params=params, opt=init_opt(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int):
    """``m`` slices of every batch entry along its leading axis."""
    def r(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} "
                             "microbatches")
        return x.reshape((m, b // m) + tuple(x.shape[1:]))
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(m)]


def _value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads in the parameters' dtypes) by autograd."""
    leaves = tree_leaves(params)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    # _fill walks the keys in sorted order, as tree_leaves does
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _fill(params, grads))


def _fill(tree, it):
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    return next(it)


def make_grad_fn(model: Model, microbatches: int = 1) -> Callable:
    """(params, batch) -> (grads, metrics); grads in f32."""
    if microbatches == 1:
        def grad_fn(params, batch):
            loss, metrics, grads = _value_and_grad(model, params, batch)
            grads = tree_map(lambda g: g.float(), grads)
            return grads, {"loss": loss, **metrics}
        return grad_fn

    def grad_fn(params, batch):
        g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        l_acc = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(params)[0].device)
        for mb in _split_microbatches(batch, microbatches):
            loss, _, grads = _value_and_grad(model, params, mb)
            tree_map(lambda a, g: a.add_(g.float()), g_acc, grads)
            l_acc = l_acc + loss
        inv = 1.0 / microbatches
        grads = tree_map(lambda a: a.mul_(inv), g_acc)
        return grads, {"loss": l_acc * inv, "ce": l_acc * inv,
                       "aux": torch.zeros_like(l_acc)}
    return grad_fn


def _dtensor_context():
    """Plain tensors made inside the model (position ids, masks) meet the
    DTensors as replicated values; DTensor's notes on multi-step
    redistributes are silenced."""
    from torch.distributed.tensor.experimental import implicit_replication
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    return implicit_replication()


def _local_metrics(metrics):
    return {k: replicated_local(v) for k, v in metrics.items()}


def _to_full_mesh(g, p):
    """A gradient on the submesh, after the pod mean, as a DTensor on the
    parameter's mesh and placements."""
    from torch.distributed.tensor import DTensor
    local = g.to_local() if is_dtensor(g) else g
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              shape=p.shape, stride=p.stride(),
                              run_check=False)


def _pod_grads(grad_fn, sync, params, batch):
    """Grads and metrics of the pod-local batch on the mesh's other axes,
    then their mean over the pod group by ``sync``."""
    mesh = tree_leaves(params)[0].device_mesh
    group, sub, rest = pod_split(mesh)
    p_sub = tree_map(lambda p: to_submesh(p, sub, rest, batch=False),
                     params)
    b_sub = {k: to_submesh(v, sub, rest, batch=True)
             for k, v in batch.items()}
    grads, metrics = grad_fn(p_sub, b_sub)
    grads = sync(grads, group)
    metrics = psum_mean(_local_metrics(metrics), group)
    return tree_map(_to_full_mesh, grads, params), metrics


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1,
                    grad_sync: str = "auto",
                    mesh=None) -> Callable:
    """(state, batch) -> (new state, metrics: loss, ce, aux, grad_norm,
    lr, as plain tensors on every rank).  The new state holds the state's
    own tensors, updated in place (``adamw_update``): the state passed in
    is consumed, as a JAX step with donated arguments consumes it.
    ``grad_sync`` other than ``"auto"`` needs ``mesh``, a ``DeviceMesh``
    with a ``"pod"`` axis, and the state and batch laid out on it.

    ``"auto"`` on a mesh with a ``"pod"`` axis takes the pod route with
    the f32 mean: the parameters replicate over pods (``fsdp`` excludes
    ``pod``), so the only cross-pod collective is that gradient mean, the
    one GSPMD places in the reference; the rest of the step runs on the
    (data, model) submesh, where no tensor dim is split over two axes."""
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync={grad_sync!r}; one of {GRAD_SYNCS}")
    if grad_sync != "auto" and (mesh is None or "pod" not in (
            mesh.mesh_dim_names or ())):
        raise ValueError(f"grad_sync={grad_sync!r} needs a mesh with a "
                         f"'pod' axis, got {mesh}")
    grad_fn = make_grad_fn(model, microbatches)
    sync = {"int8": compressed_psum_mean,
            "int16": int16_psum_mean}.get(grad_sync, psum_mean)

    def grads_and_metrics(params, batch):
        lead = tree_leaves(params)[0]
        if is_dtensor(lead) and "pod" in lead.device_mesh.mesh_dim_names:
            return _pod_grads(grad_fn, sync, params, batch)
        grads, metrics = grad_fn(params, batch)
        return grads, _local_metrics(metrics)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        lead = tree_leaves(state.params)[0]
        with (_dtensor_context() if is_dtensor(lead)
              else contextlib.nullcontext()), on_mesh(lead):
            grads, metrics = grads_and_metrics(state.params, batch)
            params, opt, om = adamw_update(opt_cfg, state.params, grads,
                                           state.opt, state.step)
            del grads
            om = _local_metrics(om)
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {**metrics, **om})

    return train_step
