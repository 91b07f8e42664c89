"""The training step: grads (+ microbatching) -> AdamW (twin of
``repro.train.train_step``).

``make_train_step`` builds a (state, batch) -> (state, metrics) function.
Options:

- ``microbatches``: gradient accumulation over batch slices, summed in
  f32 (activation memory ∝ batch / microbatches under remat);
- ``grad_sync``: ``"auto"`` — one device, nothing to synchronise.  The
  JAX package's ``"int8"`` / ``"int16"`` compressed cross-pod reduction
  needs a pod axis of processes: ROADMAP Queue 1 item 1(b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distributed.sharding import tree_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt


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
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
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


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1,
                    grad_sync: str = "auto") -> Callable:
    """(state, batch) -> (new state, metrics: loss, ce, aux, grad_norm,
    lr).  The new state holds the state's own tensors, updated in place
    (``adamw_update``): the state passed in is consumed, as a JAX step
    with donated arguments consumes it."""
    if grad_sync != "auto":
        raise NotImplementedError(
            f"grad_sync={grad_sync!r} needs a pod axis of processes: "
            "ROADMAP Queue 1 item 1(b) (more than one device)")
    grad_fn = make_grad_fn(model, microbatches)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = grad_fn(state.params, batch)
        params, opt, om = adamw_update(opt_cfg, state.params, grads,
                                       state.opt, state.step)
        del grads
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {**metrics, **om})

    return train_step
