"""Rank bodies for ``tests/test_torch_multirank.py``: top-level functions a
spawned gloo rank imports by name (no JAX, no reference).  ``world_tasks``
runs a list of tasks in order on every rank of one world and returns
their results by task name; each task decides which ranks take part."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import on_mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.settings import cell_settings
from repro_torch.models import ssm
from repro_torch.models.model import ModelFlags, build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, opt_template
from repro_torch.train.train_step import (TrainState, make_grad_fn,
                                          make_train_step)

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
          dtype="float32", sequence_parallel=False):
    """``len(batches)`` train steps on a ``make_host_mesh(*shape)`` mesh
    (``shape`` = (data, model, pod)) from ``params_np``: per-step loss and
    grad norm, and on rank 0 the final parameters and every leaf's
    placements.  ``sequence_parallel``: the parameters laid out by, and
    the steps run under ``activation_sharding`` with, the rules of the
    optimized llama3.2-3b train cell (the sequence split over ``model``);
    ``moved`` counts the redistributes the constraints issued."""
    data, model_n, pod = shape
    mesh = make_host_mesh(data, model_n, pod, device="cpu")
    if rank >= data * model_n * pod:
        return None
    model, cfg = _model()
    tpl = model.template()
    rules, ctx = sh.Rules(), contextlib.nullcontext()
    if sequence_parallel:
        rules = cell_settings(get_config("llama3.2-3b"),
                              get_shape("train_4k"), "optimized").rules
        ctx = sh.activation_sharding(mesh, rules)
    shard = sh.tree_shardings(tpl, mesh, rules)
    params = sh.distribute_tree(_params(model, params_np, dtype), shard,
                                src_rank=None)
    state = TrainState.create(params)
    bsh = sh.tree_shardings(
        {k: sh.Param(v.shape, ("batch", None), dtype=torch.int32)
         for k, v in batches[0].items()}, mesh, rules)
    step = make_train_step(model, AdamWConfig(), grad_sync=sync,
                           mesh=mesh if sync != "auto" else None)
    losses, gnorms = [], []
    for b in batches:
        b = sh.distribute_tree({k: torch.from_numpy(v)
                                for k, v in b.items()}, bsh, src_rank=None)
        with ctx:
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
                moments_ok=mu_ok, moved=getattr(ctx, "moved", 0),
                params=sh.tree_map(lambda t: t.float().numpy(), full)
                if rank == 0 else None)


def ssd_model():
    """Reduced zamba2-1.2b with the optimized train cell's settings (the
    SSD route, the activation constraints, the default rules: rows over
    ``data``, Mamba-2 heads over ``model``), SSD chunks of 8 so a row of
    32 tokens runs 4 of them: (model, config, settings)."""
    cfg = get_config("zamba2-1.2b").reduced()
    st = cell_settings(cfg, get_shape("train_4k"), "optimized")
    flags = dataclasses.replace(st.flags, ssm_chunk=8, attn_chunk=32)
    return build_model(cfg, flags), cfg, st


def ssd_steps(rank, world, params_np, batches):
    """``ssd_model``'s gradient at ``batches[0]`` and ``len(batches)``
    train steps on a (data 2, model 2) mesh under
    ``activation_sharding``, from ``params_np`` (f32): the gradients and
    final parameters whole (rank 0), per-step loss and grad norm, and the
    placements of ``local_rows``' DTensor arguments in the SSD route
    (dtx, a_log, B, C) at each call."""
    mesh = make_host_mesh(2, 2, 1, device="cpu")
    if rank >= 4:
        return None
    model, _, st = ssd_model()
    ctx = sh.activation_sharding(mesh, st.rules)
    shard = sh.tree_shardings(model.template(), mesh, st.rules)
    params = sh.distribute_tree(_params(model, params_np, "float32"), shard,
                                src_rank=None)
    bsh = sh.tree_shardings(
        {k: sh.Param(v.shape, ("batch", None), dtype=torch.int32)
         for k, v in batches[0].items()}, mesh, st.rules)
    bs = [sh.distribute_tree({k: torch.from_numpy(v) for k, v in b.items()},
                             bsh, src_rank=None) for b in batches]
    seen, real = [], ssm.local_rows

    def spy(fn, *xs, **kw):
        seen.append([[str(p) for p in x.placements] for x in xs
                     if sh.is_dtensor(x)])
        return real(fn, *xs, **kw)
    ssm.local_rows = spy
    try:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with ctx, implicit_replication(), on_mesh(sh.tree_leaves(params)[0]):
            grads, _ = make_grad_fn(model)(params, bs[0])
        grads = sh.local_tree(grads)
        state = TrainState.create(params)
        step = make_train_step(model, AdamWConfig())
        losses, gnorms = [], []
        for b in bs:
            with ctx:
                state, met = step(state, b)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
    finally:
        ssm.local_rows = real
    full = sh.local_tree(state.params)
    np_tree = (lambda t: sh.tree_map(lambda x: x.float().numpy(), t)
               if rank == 0 else None)
    return dict(losses=losses, gnorms=gnorms, seen=seen,
                grads=np_tree(grads), params=np_tree(full))


def decode(rank, world, params_np, tokens):
    """Decode steps of the reduced granite on a (data 2, model 2) mesh
    from empty caches laid out by their template (positions over
    ``model``): each step's logits, whole, on every rank.  Parameters
    are used with their fsdp splits gathered, as the dry run does."""
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = make_host_mesh(2, 2, device="cpu")
    model, _ = _model()
    params = sh.distribute_tree(
        _params(model, params_np, "float32"),
        sh.tree_shardings(model.template(), mesh), src_rank=None)
    B, T = tokens.shape
    tpl = model.cache_template(B, T)
    caches = sh.distribute_tree(sh.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32), tpl),
        sh.tree_shardings(tpl, mesh), src_rank=None)
    bsh = sh.tree_shardings({k: sh.Param((B,), ("batch",), dtype=torch.int64)
                             for k in ("token", "positions")}, mesh)
    out = []
    with implicit_replication():
        for t in range(T):
            b = sh.distribute_tree(
                {"token": torch.from_numpy(tokens[:, t]),
                 "positions": torch.full((B,), t, dtype=torch.int64)},
                bsh, src_rank=None)
            logits, caches = model.decode_step(params, caches, b)
            out.append(sh.replicated_local(logits).numpy())
    return out


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


def ensemble(rank, world, cfgs, n, chips, shard=True):
    from repro_torch.core import simulator as S
    runs = []
    for c in cfgs:
        f, t, r = S.synthetic_lifecycle_fleet(n, c, chips_per_node=chips,
                                              device="cpu")
        runs.append((f, t, r, c, S.generate_jobs(c)))
    return S.simulate_fleet_ensemble(runs, shard=shard)


def ensemble_en(rank, world, cfgs, n, chips):
    """``shard="en"``: the lanes over the ensemble mesh's e axis, each
    lane block's placement engine over its n-axis ranks by nodes."""
    return ensemble(rank, world, cfgs, n, chips, shard="en")


def sweep_en(rank, world, cfg, n):
    """``sweep_policies(shard="en")``: one reactive lane, its engine split
    over the world's ranks by nodes."""
    from repro_torch.core import simulator as S
    from repro_torch.core.policy import PolicyConfig
    return S.sweep_policies(cfg, {"r": PolicyConfig()}, n=n, device="cpu",
                            shard="en")


def ensemble_meshes(rank, world):
    """``ensemble_mesh`` over the world's ranks: (names, shape, whether
    this rank sits in it) for 8 lanes x 64 nodes and 2 x 64."""
    out = []
    for e, n in ((8, 64), (2, 64)):
        m = sh.ensemble_mesh(e, n, device_type="cpu")
        out.append([list(m.mesh_dim_names), list(m.shape),
                    m.get_coordinate() is not None])
    return out
