"""The port on more than one rank: gloo processes on the CPU, one
``torch.distributed`` world per size (2, 4 and 8 ranks, spawned once per
module through ``repro_torch.distributed.ranks.run_ranks``, one torch
thread each, a file rendezvous), against the one-process port and the
JAX reference.

- the three pod syncs at 2 ranks == the reference's ``compressed_psum_mean``
  / ``int16_psum_mean`` / ``psum_mean`` inside ``shard_map`` over 2 forced
  host devices, bit for bit, and their wire formats (int8 gather; int16
  as 2-byte elements through an all-to-all and a gather);
- train steps of reduced granite-3-2b (f32, batch 8 x seq 32) on (1,1),
  (2,2) and (2,2,2) meshes == the one-process step (loss rel 1e-5,
  parameters within 1e-5 x max|p|) and within the reference's bars
  (``tests/test_multidevice.py``); the (2,2) step against the JAX
  one-device step from the same state at ``tests/test_torch_train.py``'s
  bar; bf16 on (2,2) within the reference's bars;
- the int8 / int16 pod syncs over 3 steps within 5e-2 of "auto";
- a checkpoint from a (4,2) mesh restored onto (2,4) and onto one
  process, leaf-equal, its files byte-equal to a one-device save;
- ``train_loop(data_mesh=2, model_mesh=2)`` with a node failure: one
  elastic restart onto (1,2), the one-process run's losses;
- the ensemble with ``shard=True`` on 2 and 4 ranks (4 and 3 lanes) ==
  the one-process ensemble, bit for bit.
"""
from __future__ import annotations

import dataclasses
import filecmp
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models.model import ModelFlags as JaxFlags
from repro.models.model import build_model as jax_build
from repro.train import optimizer as jopt
from repro.train.train_step import TrainState as JaxState
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.configs import get_config
from repro_torch.core import simulator as S
from repro_torch.data.pipeline import DataConfig, PipelineState, host_batch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.ranks import run_ranks
from repro_torch.models.model import ModelFlags, build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainState, make_train_step
from test_torch_scan import BASE, assert_same

import _multirank_ranks as R

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "granite-3-2b"
SHAPE = (8, 32)                  # batch x seq of the step cases
N_STEPS = 3
SYNC_BAR = 5e-2                  # tests/test_multidevice.py:185
LOOP = dict(steps=8, batch=4, seq=16, reduced=True, task="copy",
            ckpt_every=2, log_every=100)
FAULT_AT = 5
ENS_N, ENS_CHIPS = 16, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread here too (the ranks take one each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params_np(seed: int = 0) -> dict:
    """Reduced granite's parameters in f32 with a seeded head (a
    zero-init head gives every mesh the same ln V loss)."""
    cfg = get_config(ARCH).reduced()
    p = build_model(cfg).init(seed, device="cpu")
    out = sh.tree_map(lambda t: t.float().numpy(), p)
    rng = np.random.default_rng(seed + 1)
    out["lm_head"] = (0.02 * rng.standard_normal(
        out["lm_head"].shape)).astype(np.float32)
    return out


def _batches(n: int = N_STEPS) -> list:
    cfg = get_config(ARCH).reduced()
    dcfg, ps, out = DataConfig(cfg, *SHAPE, task="copy"), \
        PipelineState(0, 0), []
    for _ in range(n):
        ps, b = host_batch(dcfg, ps)
        out.append(b)
    return out


def _sync_trees() -> list:
    rng = np.random.default_rng(0)
    return [{"g": rng.standard_normal((2, 64, 32)).astype(np.float32),
             "h": (3.0 * rng.standard_normal((5, 7))).astype(np.float32)}
            for _ in range(2)]


def _ens_cfgs(n_lanes: int) -> list:
    return [S.SimConfig(**dict(BASE, epochs=12, seed=3 + i))
            for i in range(n_lanes)]


@pytest.fixture(scope="module")
def worlds():
    """Every multi-rank task, one spawn per world size."""
    params, batches = _params_np(), _batches()
    root = tempfile.mkdtemp(prefix="multirank_")
    step = dict(params_np=params, batches=batches)
    w2 = [("syncs", "syncs", dict(trees=_sync_trees())),
          ("ens4", "ensemble", dict(cfgs=_ens_cfgs(4), n=ENS_N,
                                    chips=ENS_CHIPS)),
          ("ens3", "ensemble", dict(cfgs=_ens_cfgs(3), n=ENS_N,
                                    chips=ENS_CHIPS))]
    w4 = [("22", "steps", dict(step, shape=(2, 2, 1))),
          ("22_bf16", "steps", dict(step, shape=(2, 2, 1),
                                    dtype="bfloat16")),
          ("loop", "loop", dict(ckpt_dir=f"{root}/loop", kw=dict(
              LOOP, data_mesh=2, model_mesh=2), fault_at=FAULT_AT)),
          ("ens4", "ensemble", dict(cfgs=_ens_cfgs(4), n=ENS_N,
                                    chips=ENS_CHIPS)),
          ("ens3", "ensemble", dict(cfgs=_ens_cfgs(3), n=ENS_N,
                                    chips=ENS_CHIPS)),
          ("emesh", "ensemble_meshes", {})]
    w8 = [("11", "steps", dict(step, shape=(1, 1, 1))),
          ("222", "steps", dict(step, shape=(2, 2, 2)))]
    w8 += [(f"222_{s}", "steps", dict(step, shape=(2, 2, 2), sync=s))
           for s in ("int8", "int16")]
    w8 += [("ckpt", "checkpoints", dict(root=f"{root}/ckpt",
                                        params_np=params))]
    out = {"root": root, "params": params, "batches": batches}
    for world, tasks in ((2, w2), (4, w4), (8, w8)):
        out[world] = run_ranks(R.world_tasks, world, tasks, timeout=240)
    return out


@pytest.fixture(scope="module")
def one_process(worlds):
    """The same steps in this process on plain tensors (f32 and bf16)."""
    out = {}
    cfg = get_config(ARCH).reduced()
    for dtype in ("float32", "bfloat16"):
        model = build_model(cfg, ModelFlags(attn_chunk=R.CFG["attn_chunk"]))
        state = TrainState.create(R._params(model, worlds["params"], dtype))
        step = make_train_step(model, AdamWConfig())
        losses, gnorms = [], []
        for b in worlds["batches"]:
            state, met = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
        out[dtype] = dict(losses=losses, gnorms=gnorms, params=sh.tree_map(
            lambda t: t.float().numpy(), state.params))
    return out


# ---------------------------------------------------------------------------
# the pod syncs
# ---------------------------------------------------------------------------

_JAX_SYNC = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.train.compression import (compressed_psum_mean, int16_psum_mean,
                                     psum_mean)
d = np.load(sys.argv[1])
trees = [{k: d[f"{k}{r}"] for k in ("g", "h")} for r in range(2)]
glob = {k: np.concatenate([t[k] for t in trees]) for k in ("g", "h")}
mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))
out = {}
for kind, fn in (("int8", compressed_psum_mean), ("int16", int16_psum_mean),
                 ("fp32", psum_mean)):
    f = jax.jit(jax.shard_map(lambda t: fn(t, "pod"), mesh=mesh,
                              in_specs=P("pod"), out_specs=P("pod"),
                              check_vma=False))
    res = f({k: jnp.asarray(v) for k, v in glob.items()})
    for k, v in res.items():
        v = np.asarray(v)
        n = trees[0][k].shape[0]
        for r in range(2):
            out[f"{kind}_{k}{r}"] = v[r * n:(r + 1) * n]
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_syncs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jaxsync")
    trees = _sync_trees()
    np.savez(d / "in.npz", **{f"{k}{r}": t[k] for r, t in enumerate(trees)
                              for k in t})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SYNC), str(d / "in.npz"),
         str(d / "out.npz")], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return dict(np.load(d / "out.npz"))


def _first_diff(a: np.ndarray, b: np.ndarray) -> str:
    i = np.flatnonzero(a.view(np.uint32) != b.view(np.uint32))
    if not len(i):
        return ""
    j = np.unravel_index(i[0], a.shape)
    return (f"{len(i)} values differ; first at {j}: {a[j]!r} "
            f"(0x{a.view(np.uint32)[j]:08x}) vs {b[j]!r} "
            f"(0x{b.view(np.uint32)[j]:08x})")


def _unfused_int8_mean(trees, k):
    """The int8 mean as the port computes it, in numpy: per-rank scale
    and rounding, each dequantized product rounded, summed in rank order,
    divided by n."""
    gs = [t[k] for t in trees]
    sc = [np.maximum(np.abs(g).max() / np.float32(127.0), np.float32(1e-20))
          for g in gs]
    qs = [np.clip(np.round(g / s), -127, 127).astype(np.float32)
          for g, s in zip(gs, sc)]
    return (qs[0] * sc[0] + qs[1] * sc[1]) / np.float32(2), qs, sc


@pytest.mark.parametrize("kind", ["int8", "int16", "fp32"])
def test_pod_syncs_match_reference_bitwise(worlds, jax_syncs, kind):
    """Every rank's mean == the reference's on its pod, bit for bit, and
    within the reference's bound of the exact mean.  int8: the reference's
    XLA CPU program contracts the dequantize-and-sum into a fused
    multiply-add, ``fma(q1, s1, q0 * s0) / 2``, and differs from the
    port's separately rounded ``(q0 * s0 + q1 * s1) / 2`` by one ulp in
    about a quarter of the values (the first:
    ``g[0, 0, 0]`` -0.071331345 (0xbd92162b) vs the reference's
    -0.07133134 (0xbd92162a)); the port rounds each step so the card and
    the CPU agree bit for bit.  So int8 holds the port to the unfused
    numpy formula and the reference to the fused one, bit for bit each,
    the gap to an ulp of the larger term, and both to the bound."""
    trees = _sync_trees()
    for r in range(2):
        got, _ = worlds[2][r]["syncs"][kind]
        exact, _ = worlds[2][r]["syncs"]["fp32"]
        for k in ("g", "h"):
            want = jax_syncs[f"{kind}_{k}{r}"]
            assert got[k].dtype == want.dtype == np.float32
            if kind == "int8":
                unfused, qs, sc = _unfused_int8_mean(trees, k)
                fused = (qs[1].astype(np.float64) * np.float64(sc[1])
                         + (qs[0] * sc[0])).astype(np.float32) / 2
                assert not _first_diff(got[k], unfused)
                assert not _first_diff(want, fused)
                # one rounding apart: within an ulp of the larger term
                term = np.maximum(np.abs(qs[0] * sc[0]),
                                  np.abs(qs[1] * sc[1]))
                assert np.all(np.abs(got[k] - want) <= np.spacing(term))
            else:
                assert not _first_diff(got[k], want), \
                    _first_diff(got[k], want)
            bound = max(np.abs(t[k]).max() for t in trees) / 127.0
            assert np.abs(got[k] - exact[k]).max() <= bound + 1e-6
            assert np.abs(want - exact[k]).max() <= bound + 1e-6


def test_pod_sync_wire_formats(worlds):
    """int8: the payload gathered as int8, the scales as one f32 each;
    int16: a shared f32 scale, then the int16 values as 2-byte elements
    through an all-to-all and a gather (uint8 views), never widened;
    fp32: one f32 all-reduce."""
    trees = _sync_trees()
    sizes = {k: v.size for k, v in trees[0].items()}
    for r in range(2):
        logs = {k: v[1] for k, v in worlds[2][r]["syncs"].items()}
        assert logs["int8"] == [
            x for k in ("g", "h") for x in (
                ("all_gather_into_tensor", "int8", sizes[k]),
                ("all_gather_into_tensor", "float32", 4))]
        want16 = []
        for k in ("g", "h"):
            pad = -(-sizes[k] // 2) * 2
            want16 += [("all_reduce", "float32", 4),
                       ("all_to_all_single", "uint8", 2 * pad),
                       ("all_gather_into_tensor", "uint8", pad)]
        assert logs["int16"] == want16
        assert logs["fp32"] == [("all_reduce", "float32", 4 * sizes[k])
                                for k in ("g", "h")]


# ---------------------------------------------------------------------------
# train steps across meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(8, "11"), (4, "22"), (8, "222")],
                         ids=["1x1", "2x2", "2x2x2"])
def test_train_steps_match_one_process(worlds, one_process, mesh):
    """Every step's loss rel 1e-5 and the parameters after the steps
    within 1e-5 x max|p| of the one-process port (f32), and within the
    reference's bars (loss 5e-3, grad norm 5 % relative); every rank of
    the mesh reports the same metrics; parameters and moments keep
    their placements."""
    world, key = mesh
    ref = one_process["float32"]
    res = [r[key] for r in worlds[world] if r[key] is not None]
    assert len(res) == {"11": 1, "22": 4, "222": 8}[key]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        assert r["placements_ok"] and r["moments_ok"]
    got = res[0]
    for a, b in zip(got["losses"], ref["losses"]):
        assert a == pytest.approx(b, rel=1e-5)
        assert abs(a - b) < 5e-3
    for a, b in zip(got["gnorms"], ref["gnorms"]):
        assert abs(a - b) / b < 5e-2
    for a, b in zip(sh.tree_leaves(got["params"]),
                    sh.tree_leaves(ref["params"])):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_train_step_2x2_matches_jax_one_device(worlds):
    """The (2,2) steps against the JAX one-device step from the same
    state (``tests/test_torch_train.py``'s bar: loss and grad norm rel
    1e-4 each step, parameters within 1e-4 of each leaf's L2 norm)."""
    jmodel = jax_build(JAX_ARCHS[ARCH].reduced(),
                       JaxFlags(attn_chunk=R.CFG["attn_chunk"]))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, worlds["params"]))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt.AdamWConfig()))
    got = worlds[4][0]["22"]
    for i, b in enumerate(worlds["batches"]):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        assert got["losses"][i] == pytest.approx(float(jmet["loss"]),
                                                 rel=1e-4)
        assert got["gnorms"][i] == pytest.approx(float(jmet["grad_norm"]),
                                                 rel=1e-4)
    want = jax.tree.leaves(jstate.params)
    for a, b in zip(sh.tree_leaves(got["params"]), want):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)


def test_train_step_2x2_bf16_within_reference_bars(worlds, one_process):
    ref = one_process["bfloat16"]
    got = worlds[4][0]["22_bf16"]
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) < 5e-3
    for a, b in zip(got["gnorms"], ref["gnorms"]):
        assert abs(a - b) / b < 5e-2


@pytest.mark.parametrize("sync", ["int8", "int16"])
def test_pod_sync_trains_like_auto(worlds, sync):
    """``tests/test_multidevice.py:159-188``: 3 steps on (2,2,2) with the
    pod sync, the last loss within 5e-2 of "auto"'s (which takes the f32
    pod mean on a mesh with a pod axis)."""
    auto = worlds[8][0]["222"]
    got = worlds[8][0][f"222_{sync}"]
    for r in worlds[8]:
        assert r[f"222_{sync}"]["losses"] == got["losses"]
    assert abs(got["losses"][-1] - auto["losses"][-1]) < SYNC_BAR


def test_ensemble_mesh_over_ranks(worlds):
    """With a process group up, ``ensemble_mesh`` is a ``("e", "n")``
    ``DeviceMesh`` over the first e * n ranks, factored as without one."""
    for r in worlds[4]:
        assert r["emesh"] == [[["e", "n"], [4, 1], True],
                              [["e", "n"], [2, 2], True]]


# ---------------------------------------------------------------------------
# checkpoints, the launcher, the ensemble
# ---------------------------------------------------------------------------


def test_checkpoint_crosses_mesh_shapes(worlds):
    """Saved from (4,2), restored onto (2,4) on every rank (leaf-equal,
    the target's placements and local shapes), its files byte-equal to a
    one-device save, and restored onto one process leaf-equal."""
    root = f"{worlds['root']}/ckpt"
    for r in worlds[8]:
        c = r["ckpt"]
        assert c["equal"] and c["placed"] and c["step"] == 7
        assert c["step_leaf"] == 7 and c["extra"] == {"pipeline": {"step": 7}}
    mesh_dir, one_dir = f"{root}/mesh/step_00000007", f"{root}/one/step_00000007"
    names = sorted(os.listdir(one_dir))
    assert names == sorted(os.listdir(mesh_dir)) and len(names) > 10
    match, mismatch, errors = filecmp.cmpfiles(one_dir, mesh_dir, names,
                                               shallow=False)
    assert not mismatch and not errors
    model = build_model(get_config(ARCH).reduced())
    tpl = model.template()
    from repro_torch.train.optimizer import opt_template
    full = {"params": tpl, "opt": opt_template(tpl), "step": None}
    got, step, _ = ckpt.restore(f"{root}/mesh", full, device="cpu")
    want, _, _ = ckpt.restore(f"{root}/one", full, device="cpu")
    assert step == 7
    for a, b in zip(sh.tree_leaves(got), sh.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the (2,4) local shapes: rank 0 holds 1/2 of fsdp dims, 1/4 of tp
    shapes = worlds[8][0]["ckpt"]["local_shapes"]
    specs = sh.tree_leaves(sh.tree_specs(
        {"params": tpl, "opt": opt_template(tpl)},
        sh.MeshShape(("data", "model"), (2, 4))))
    leaves = sh.tree_leaves({"params": tpl, "opt": opt_template(tpl)})
    for s, spec, p in zip(shapes, specs, leaves):
        div = [1 if e is None else {"data": 2, "model": 4}[e]
               if isinstance(e, str) else 8 for e in spec]
        assert s == tuple(d // k for d, k in zip(p.shape, div))


def test_train_loop_elastic_restart_matches_one_process(worlds):
    """``train_loop(data_mesh=2, model_mesh=2)``, a node failure at step
    5: one restart from the step-4 checkpoint onto (1,2), the ranks left
    out return the same run; the losses == the one-process run with the
    same failure: every step within the reference's bar (5e-3,
    ``tests/test_multidevice.py:152``) and the last within rel 1e-4.  In
    bf16 the sharded step rounds each rank's partial gradient sums to
    bf16 before the reduction, so single steps differ from one process
    by up to 1.15e-4 relative (measured)."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.fault_tolerance import FailureInjector
    with tempfile.TemporaryDirectory() as d:
        one = train_loop(ARCH, ckpt_dir=d, device="cpu", log=lambda m: None,
                         injector=FailureInjector(
                             schedule={FAULT_AT: "node_failure"}), **LOOP)
    runs = [r["loop"] for r in worlds[4]]
    for r in runs:
        assert r["restarts"] == one.restarts == 1
        assert r["steps_done"] == one.steps_done == LOOP["steps"]
        assert r["losses"] == runs[0]["losses"]
    assert [r["has_state"] for r in runs] == [True, True, False, False]
    assert len(runs[0]["losses"]) == len(one.losses)
    for a, b in zip(runs[0]["losses"], one.losses):
        assert abs(a - b) < 5e-3
    assert runs[0]["losses"][-1] == pytest.approx(one.losses[-1], rel=1e-4)


@pytest.mark.parametrize("world,lanes", [(2, 4), (2, 3), (4, 4), (4, 3)])
def test_sharded_ensemble_equals_one_process(worlds, world, lanes):
    """``shard=True`` over the world's ranks (the largest divisor of the
    lane count <= the world size: 2, 1, 4 and 3 ranks) == the one-process
    ensemble, lane by lane, bit for bit, on every rank."""
    runs = []
    for c in _ens_cfgs(lanes):
        f, t, r = S.synthetic_lifecycle_fleet(ENS_N, c,
                                              chips_per_node=ENS_CHIPS,
                                              device="cpu")
        runs.append((f, t, r, c, S.generate_jobs(c)))
    want = S.simulate_fleet_ensemble(runs)
    for rank in range(world):
        got = worlds[world][rank][f"ens{lanes}"]
        assert len(got) == lanes
        for a, b in zip(got, want):
            assert_same(a, b, emissions_rel=0)
