"""Rank bodies for ``tests/test_torch_multirank.py``: top-level functions a
spawned gloo rank imports by name (no JAX, no reference).  ``world_tasks``
runs a list of tasks in order on every rank of one world and returns
their results by task name; each task decides which ranks take part."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import ModelFlags, build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, opt_template
from repro_torch.train.train_step import TrainState, make_train_step

WIRE = ("all_gather_into_tensor", "all_to_all_single", "all_reduce")
CFG = dict(arch="granite-3-2b", attn_chunk=32)


def world_tasks(rank, world, tasks):
    return {name: globals()[fn](rank, world, **kw) for name, fn, kw in tasks}


# ---------------------------------------------------------------------------
# compressed pod syncs
# ---------------------------------------------------------------------------


def _record_wire(log: list) -> dict:
    """Wrap the collectives ``train.compression`` calls to log (name,
    dtype, bytes) of each payload; returns the originals."""
    saved = {n: getattr(dist, n) for n in WIRE}
    for n in WIRE:
        def wrapped(*a, _o=saved[n], _n=n, **k):
            t = a[0] if _n == "all_reduce" else a[1]
            log.append((_n, str(t.dtype).split(".")[-1],
                        t.numel() * t.element_size()))
            return _o(*a, **k)
        setattr(dist, n, wrapped)
    return saved


def syncs(rank, world, trees):
    """The three pod means of this rank's tree (``trees[rank]``, numpy)
    over the world's ranks, with each one's wire log."""
    tree = {k: torch.from_numpy(v) for k, v in trees[rank].items()}
    out = {}
    for kind, fn in (("int8", compression.compressed_psum_mean),
                     ("int16", compression.int16_psum_mean),
                     ("fp32", compression.psum_mean)):
        log: list = []
        saved = _record_wire(log)
        try:
            res = fn(tree, None)
        finally:
            for n, f in saved.items():
                setattr(dist, n, f)
        out[kind] = ({k: v.numpy() for k, v in res.items()}, log)
    return out


# ---------------------------------------------------------------------------
# train steps on meshes
# ---------------------------------------------------------------------------


def _model():
    cfg = get_config(CFG["arch"]).reduced()
    return build_model(cfg, ModelFlags(attn_chunk=CFG["attn_chunk"])), cfg


def _params(model, params_np, dtype):
    tpl = model.template()
    return sh.tree_map(
        lambda p, a: torch.from_numpy(np.array(a)).to(
            getattr(torch, dtype) if p.dtype == torch.bfloat16 else p.dtype),
        tpl, params_np)


def steps(rank, world, shape, params_np, batches, sync="auto",
          dtype="float32"):
    """``len(batches)`` train steps on a ``make_host_mesh(*shape)`` mesh
    (``shape`` = (data, model, pod)) from ``params_np``: per-step loss and
    grad norm, and on rank 0 the final parameters and every leaf's
    placements."""
    data, model_n, pod = shape
    mesh = make_host_mesh(data, model_n, pod, device="cpu")
    if rank >= data * model_n * pod:
        return None
    model, cfg = _model()
    tpl = model.template()
    shard = sh.tree_shardings(tpl, mesh)
    params = sh.distribute_tree(_params(model, params_np, dtype), shard,
                                src_rank=None)
    state = TrainState.create(params)
    bsh = sh.tree_shardings(
        {k: sh.Param(v.shape, ("batch", None), dtype=torch.int32)
         for k, v in batches[0].items()}, mesh)
    step = make_train_step(model, AdamWConfig(), grad_sync=sync,
                           mesh=mesh if sync != "auto" else None)
    losses, gnorms = [], []
    for b in batches:
        b = sh.distribute_tree({k: torch.from_numpy(v)
                                for k, v in b.items()}, bsh, src_rank=None)
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    pl_ok = all(tuple(p.placements) == tuple(s.placements)
                for p, s in zip(sh.tree_leaves(state.params),
                                sh.tree_leaves(shard)))
    mu_ok = all(tuple(m.placements) == tuple(s.placements)
                for m, s in zip(sh.tree_leaves(state.opt["mu"]),
                                sh.tree_leaves(shard)))
    full = sh.local_tree(state.params)
    return dict(losses=losses, gnorms=gnorms, placements_ok=pl_ok,
                moments_ok=mu_ok,
                params=sh.tree_map(lambda t: t.float().numpy(), full)
                if rank == 0 else None)


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------


def checkpoints(rank, world, root, params_np):
    """Save a (4, 2)-mesh train state, restore it onto (2, 4); rank 0
    also saves the same values from one device."""
    model, _ = _model()
    tpl = model.template()
    full_tpl = {"params": tpl, "opt": opt_template(tpl)}
    values = TrainState.create(_params(model, params_np, "bfloat16"))
    # moments with values, so the f32 leaves carry bits too
    sh.tree_map(lambda m, p: m.copy_(p.float() * 0.5), values.opt["mu"],
                values.params)
    sh.tree_map(lambda m, p: m.copy_(p.float() ** 2), values.opt["nu"],
                values.params)
    values.step.fill_(7)
    tree = {"params": values.params, "opt": values.opt, "step": values.step}
    m1 = make_host_mesh(4, 2, device="cpu")
    m2 = make_host_mesh(2, 4, device="cpu")
    s1 = {k: sh.tree_shardings(v, m1) for k, v in full_tpl.items()}
    s2 = {k: sh.tree_shardings(v, m2) for k, v in full_tpl.items()}
    state = {k: sh.distribute_tree(tree[k], s1[k], src_rank=None)
             for k in s1}
    state["step"] = values.step
    ckpt.save(f"{root}/mesh", state, 7, extra={"pipeline": {"step": 7}})
    if rank == 0:
        ckpt.save(f"{root}/one", tree, 7, extra={"pipeline": {"step": 7}})
    restored, step, extra = ckpt.restore(
        f"{root}/mesh", dict(full_tpl, step=None), dict(s2, step=None),
        device="cpu")
    got = sh.tree_leaves({k: restored[k] for k in s2})
    want = sh.tree_leaves({k: tree[k] for k in s2})
    equal = all(torch.equal(sh.replicated_local(g), w)
                for g, w in zip(got, want))
    placed = all(tuple(g.placements) == tuple(s.placements) and
                 g.device_mesh is m2 for g, s in zip(
                     got, sh.tree_leaves(s2)))
    local_shapes = [tuple(g.to_local().shape) for g in got]
    return dict(step=step, extra=extra, equal=equal, placed=placed,
                step_leaf=int(restored["step"]), local_shapes=local_shapes)


# ---------------------------------------------------------------------------
# the launcher and the ensemble
# ---------------------------------------------------------------------------


def loop(rank, world, ckpt_dir, kw, fault_at):
    from repro_torch.launch.train import train_loop
    from repro_torch.train.fault_tolerance import FailureInjector
    inj = FailureInjector(schedule={fault_at: "node_failure"})
    run = train_loop(CFG["arch"], ckpt_dir=ckpt_dir, injector=inj,
                     device="cpu", log=lambda m: None, **kw)
    return dict(losses=run.losses, restarts=run.restarts,
                steps_done=run.steps_done,
                has_state=run.final_state is not None)


def ensemble(rank, world, cfgs, n, chips):
    from repro_torch.core import simulator as S
    runs = []
    for c in cfgs:
        f, t, r = S.synthetic_lifecycle_fleet(n, c, chips_per_node=chips,
                                              device="cpu")
        runs.append((f, t, r, c, S.generate_jobs(c)))
    return S.simulate_fleet_ensemble(runs, shard=True)


def ensemble_meshes(rank, world):
    """``ensemble_mesh`` over the world's ranks: (names, shape, whether
    this rank sits in it) for 8 lanes x 64 nodes and 2 x 64."""
    out = []
    for e, n in ((8, 64), (2, 64)):
        m = sh.ensemble_mesh(e, n, device_type="cpu")
        out.append([list(m.mesh_dim_names), list(m.shape),
                    m.get_coordinate() is not None])
    return out
