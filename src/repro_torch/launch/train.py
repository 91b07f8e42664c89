"""Training launcher: MAIZX-placed, fault-tolerant, checkpointed (twin of
``repro.launch.train``).

1. MAIZX ranks the available pods (Eq. 1 over a 64-pod synthetic fleet)
   and places the job on the best one;
2. the loop runs train steps, checkpointing every ``ckpt_every`` steps
   (atomic, with the data-pipeline state in the manifest, in the JAX
   package's format);
3. a ``FailureInjector`` / real ``NodeFailure`` triggers an elastic
   restart: the mesh is rebuilt on the surviving ranks, the latest
   checkpoint restored onto it, and the data order resumes from the
   pipeline state it carries.

``data_mesh`` / ``model_mesh`` above 1 train on a ``("data", "model")``
``DeviceMesh`` over the first ranks of the default process group (one
process per rank; every rank calls ``train_loop`` with the same
arguments): the parameters, the AdamW moments and the batch
(``("batch", None)``) are laid out by ``tree_shardings`` with
``Rules()``, and the step runs on DTensors.  After a failure the mesh
shrinks to ``max(1, data_mesh // 2)`` on the data axis over the first
ranks; the ranks left out wait, and every rank returns the same
``TrainRun`` (``final_state`` is None on the ranks left out).  A mesh of
one rank trains on plain tensors on rank 0.

``python -m repro_torch.launch.train --arch granite-3-2b --steps 30
[--full] [--device cpu]`` trains the reduced config (``--full``: the
published widths) on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.fleet import synthetic_fleet
from repro_torch.data.pipeline import DataConfig, PipelineState, device_batch
from repro_torch.distributed.sharding import (Param, Rules, distribute_tree,
                                              local_tree, tree_shardings)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import ModelFlags, build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (FailureInjector, HealthMonitor,
                                               NodeFailure)
from repro_torch.train.optimizer import AdamWConfig, opt_template
from repro_torch.train.train_step import TrainState, make_train_step


@dataclasses.dataclass
class TrainRun:
    losses: list
    steps_done: int
    restarts: int
    migrations: int
    final_state: Any
    grad_norms: list            # per completed step, as losses
    step_s: list                # wall seconds per completed step


def make_step(cfg: ArchConfig, *, seq: int, steps: int, lr: float,
              microbatches: int = 1):
    """The launcher's model (attention chunks of min(512, seq), scan
    chunks of 32) and its train step (AdamW, warmup over a tenth of
    ``steps``, at least 2, then cosine decay to ``steps``)."""
    model = build_model(cfg, ModelFlags(attn_chunk=min(512, seq),
                                        ssm_chunk=32))
    opt_cfg = AdamWConfig(lr_peak=lr, warmup_steps=max(2, steps // 10),
                          total_steps=steps)
    return model, make_train_step(model, opt_cfg, microbatches=microbatches)


def train_loop(arch: Union[str, ArchConfig], *, steps: int, batch: int,
               seq: int, reduced: bool = True,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
               data_mesh: int = 1, model_mesh: int = 1,
               injector: Optional[FailureInjector] = None,
               task: str = "copy", microbatches: int = 1,
               lr: Optional[float] = None, log_every: int = 10,
               maizx_place: bool = False, seed: int = 0,
               device: DeviceLike = None, log=print) -> TrainRun:
    """Train ``arch`` (a config name, or a config as is) for ``steps``
    steps on ``device`` (the card unless told otherwise; with a mesh, each
    rank's device) from parameters drawn with ``seed``; ``reduced`` takes
    the config's reduced form."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank:
        log = _quiet        # one rank speaks
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    if lr is None:
        # the JAX launcher's width scaling: the 3e-4 production peak is
        # tuned for d_model ~ 4096; at the reduced width (d = 128) that
        # step is below bf16 resolution against fan-in-scaled weights
        lr = 3e-3 if reduced else 3e-4
    model, step_fn = make_step(cfg, seq=seq, steps=steps, lr=lr,
                               microbatches=microbatches)
    dcfg = DataConfig(cfg, batch, seq, task=task, seed=seed)
    monitor = HealthMonitor()
    injector = injector or FailureInjector()

    if maizx_place:
        fleet = synthetic_fleet(64, seed=seed, device=dev)
        scores = fleet.rank()
        pod = int(torch.argmin(scores))
        log(f"[maizx] placed job on pod {pod} "
            f"(score {float(scores[pod]):.4f}, "
            f"ci {float(fleet.ci_now[pod]):.0f} gCO2/kWh)")

    losses: list = []
    gnorms: list = []
    step_s: list = []
    restarts = 0
    pstate = PipelineState(seed, 0)
    mesh = _mesh(data_mesh, model_mesh, dev)
    member = rank < data_mesh * model_mesh
    # every rank draws the same parameters from the seed, then keeps its
    # shards: no traffic, and the same model as one device's
    tpl = _state_template(model)
    state = None
    if member:
        state = _place(_to_tree(TrainState.create(
            model.init(seed, device=dev))), tpl, mesh)
    batch_sh = _shardings(_batch_template(batch, seq), mesh)
    start = 0

    if member and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start, pstate = _restore(ckpt_dir, tpl, mesh, dev)
        log(f"[ckpt] resumed from step {start}")

    s = start
    while member and s < steps:
        try:
            t0 = time.monotonic()
            injector.check(s)
            time.sleep(injector.straggle_s(s))
            pstate, b = device_batch(dcfg, pstate, dev)
            if batch_sh is not None:
                b = distribute_tree(b, batch_sh, src_rank=None)
            state, metrics = step_fn(state, b)
            loss = float(metrics["loss"])
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            step_s.append(time.monotonic() - t0)
            monitor.record_step("local", step_s[-1])
            if s % log_every == 0 or s == steps - 1:
                log(f"step {s:5d} loss {loss:.4f} gnorm {gnorms[-1]:.3f}")
            s += 1
            if ckpt_dir and (s % ckpt_every == 0 or s == steps):
                ckpt.save(ckpt_dir, _to_tree(state), s,
                          extra={"pipeline": pstate.as_dict()})
        except NodeFailure as e:
            restarts += 1
            log(f"[fault] {e}; elastic restart on the surviving mesh")
            # consume the failure BEFORE restore resets s, or the replayed
            # step re-raises forever
            injector.schedule.pop(s, None)
            resume = ckpt_dir and ckpt.latest_step(ckpt_dir) is not None
            if not resume:
                # no checkpoint: carry the live state over (every rank of
                # the old mesh takes part in the gather)
                state = _gather(state)
            # elastic restart: shrink the data axis if possible
            data_mesh = max(1, data_mesh // 2)
            mesh = _mesh(data_mesh, model_mesh, dev)
            batch_sh = _shardings(_batch_template(batch, seq), mesh)
            _, step_fn = make_step(cfg, seq=seq, steps=steps, lr=lr,
                                   microbatches=microbatches)
            member = rank < data_mesh * model_mesh
            if not member:
                break
            if resume:
                state, s, pstate = _restore(ckpt_dir, tpl, mesh, dev)
            else:
                state = _place(state, tpl, mesh)

    run = TrainRun(losses=losses, steps_done=s, restarts=restarts,
                   migrations=0, final_state=state if member else None,
                   grad_norms=gnorms, step_s=step_s)
    if world > 1:
        # the ranks left out by a shrink take rank 0's record
        box = [None if rank else {k: getattr(run, k) for k in (
            "losses", "steps_done", "restarts", "migrations", "grad_norms",
            "step_s")}]
        dist.broadcast_object_list(box, src=0)
        for k, v in box[0].items():
            setattr(run, k, v)
    return run


def _quiet(*_args, **_kw) -> None:
    return None


def _to_tree(state: TrainState):
    return {"params": state.params, "opt": state.opt, "step": state.step}


def _from_tree(tree) -> TrainState:
    return TrainState(params=tree["params"], opt=tree["opt"],
                      step=tree["step"])


def _mesh(data: int, model: int, dev: torch.device):
    """The training mesh over the first ranks, or None for one rank (the
    one-device path; rank 0 runs it)."""
    if data * model == 1:
        return None
    return make_host_mesh(data=data, model=model, device=dev)


def _state_template(model) -> dict:
    tpl = model.template()
    return {"params": tpl, "opt": opt_template(tpl), "step": None}


def _batch_template(batch: int, seq: int) -> dict:
    return {k: Param((batch, seq), ("batch", None), dtype=torch.int32)
            for k in ("tokens", "labels")}


def _shardings(tpl, mesh):
    """``tree_shardings`` of a template on ``mesh`` (the ``step`` leaf, a
    ``None`` in the template, stays a plain tensor on every rank); None
    without a mesh."""
    if mesh is None:
        return None
    return {k: None if v is None else tree_shardings(v, mesh, Rules())
            for k, v in tpl.items()}


def _place(tree, tpl, mesh) -> TrainState:
    """A state tree of full tensors laid out on ``mesh`` (every rank holds
    the same values)."""
    sh = _shardings(tpl, mesh)
    if sh is not None:
        tree = {k: tree[k] if sh[k] is None
                else distribute_tree(tree[k], sh[k], src_rank=None)
                for k in tree}
    return _from_tree(tree)


def _gather(state: TrainState):
    return local_tree(_to_tree(state))


def _restore(ckpt_dir: str, tpl, mesh, dev: torch.device):
    tree, step, extra = ckpt.restore(ckpt_dir, tpl, _shardings(tpl, mesh),
                                     device=dev)
    return _from_tree(tree), step, PipelineState.from_dict(extra["pipeline"])


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--task", default="copy")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--maizx-place", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    run = train_loop(args.arch, steps=args.steps, batch=args.batch,
                     seq=args.seq, reduced=args.reduced,
                     ckpt_dir=args.ckpt_dir, task=args.task,
                     microbatches=args.microbatches,
                     maizx_place=args.maizx_place, device=args.device)
    print(f"done: {run.steps_done} steps, restarts={run.restarts}, "
          f"loss {run.losses[0]:.3f} -> {run.losses[-1]:.3f}")
    return run


if __name__ == "__main__":
    main()
