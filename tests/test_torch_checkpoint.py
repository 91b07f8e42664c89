"""The port's data pipeline, checkpoints, fault tolerance and training
launcher on the CPU.

The pipeline's batches are byte-equal to the reference's; a checkpoint
written by either package is the same files byte for byte and restores in
the other bit for bit (bf16 and f32 leaves); versioning and ``latest`` as
in ``tests/test_fault_tolerance.py``; the health monitor and migration
policy on that file's cases; the launcher's fault restart against the
clean run (``tests/test_fault_tolerance.py:111-126``), its three families
and its CLI on the CPU.
"""
from __future__ import annotations

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import pipeline as jpipe
from repro.models.model import build_model as jax_build
from repro.train import checkpoint as jckpt
from repro.train.train_step import TrainState as JaxState
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data import pipeline as ppipe
from repro_torch.launch import train as launch
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (FailureInjector, HealthMonitor,
                                               MigrationPolicy)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainState, make_train_step



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are small: on one intra-op thread they run
    as fast, and the test workers running beside this file (pytest-xdist)
    do not wait on each other's thread barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["copy", "random"])
@pytest.mark.parametrize("arch,batch,seq,seed,step", [
    ("granite-3-2b", 4, 33, 7, 0), ("llama3.2-3b", 3, 64, 1234, 11),
    ("falcon-mamba-7b", 2, 128, 0, 5)])
def test_batches_byte_equal_reference(task, arch, batch, seq, seed, step):
    jcfg = jpipe.DataConfig(JAX_ARCHS[arch], batch, seq, task=task,
                            seed=seed)
    pcfg = ppipe.DataConfig(get_config(arch), batch, seq, task=task,
                            seed=seed)
    js, jb = jpipe.host_batch(jcfg, jpipe.PipelineState(seed, step))
    ps, pb = ppipe.host_batch(pcfg, ppipe.PipelineState(seed, step))
    ds, db = ppipe.device_batch(pcfg, ppipe.PipelineState(seed, step),
                                "cpu")
    assert js.as_dict() == ps.as_dict() == ds.as_dict()
    for k in ("tokens", "labels"):
        assert pb[k].dtype == jb[k].dtype == np.int32
        assert pb[k].tobytes() == jb[k].tobytes()
        assert db[k].dtype == torch.int32
        assert db[k].numpy().tobytes() == jb[k].tobytes()


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def _jax_state(seed=0):
    """A reduced granite JAX TrainState: bf16 and f32 parameters, moments
    drawn non-zero, step 12."""
    cfg = JAX_ARCHS["granite-3-2b"].reduced()
    params = jax_build(cfg).init(jax.random.key(seed))
    st = JaxState.create(params)
    rng = np.random.default_rng(seed)
    opt = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), st.opt)
    return {"params": st.params, "opt": opt,
            "step": jnp.asarray(12, jnp.int32)}


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16).tobytes()
    return x.tobytes()


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def test_checkpoint_written_by_either_package_restores_in_the_other(
        tmp_path):
    jstate = _jax_state()
    pcfg = get_config("granite-3-2b").reduced()
    pstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), pcfg,
                                    device="cpu")
    ptree = {"params": pstate.params, "opt": pstate.opt,
             "step": pstate.step}
    extra = {"pipeline": {"seed": 3, "step": 12}}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jdir, jstate, 12, extra=extra)
    ckpt.save(pdir, ptree, 12, extra=extra)
    # the same files, byte for byte (manifest included)
    _same_files(os.path.join(jdir, "step_00000012"),
                os.path.join(pdir, "step_00000012"))
    assert os.readlink(os.path.join(pdir, "latest")) == "step_00000012"
    # the port restores the JAX checkpoint, the JAX package the port's
    got, step, ex = ckpt.restore(jdir, ptree, device="cpu")
    assert step == 12 and ex == extra
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["params"]["ln_f"].dtype == torch.float32
    assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
    want, jstep, jex = jckpt.restore(pdir, jstate)
    assert jstep == 12 and jex == extra
    for a, b, c in zip(_flat(got), jax.tree.leaves(jstate),
                       jax.tree.leaves(want)):
        assert _bits(a) == _bits(b) == _bits(c)


def test_checkpoint_roundtrip_and_shape_check(tmp_path):
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
             "step": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), state, 7, extra={"pipeline": {"seed": 1,
                                                           "step": 7}})
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, step, extra = ckpt.restore(str(tmp_path), state, device="cpu")
    assert step == 7 and extra["pipeline"]["seed"] == 1
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    bad = {"params": {"w": torch.zeros(4, 3)}, "step": state["step"]}
    with pytest.raises(ValueError, match="params/w"):
        ckpt.restore(str(tmp_path), bad, device="cpu")


def test_checkpoint_versioning_keeps_latest(tmp_path):
    state = {"w": torch.zeros(3)}
    ckpt.save(str(tmp_path), state, 1)
    ckpt.save(str(tmp_path), {"w": torch.ones(3)}, 2)
    restored, step, _ = ckpt.restore(str(tmp_path), state, device="cpu")
    assert step == 2
    assert torch.equal(restored["w"], torch.ones(3))
    # older version restorable explicitly
    r1, s1, _ = ckpt.restore(str(tmp_path), state, step=1, device="cpu")
    assert s1 == 1
    assert torch.equal(r1["w"], torch.zeros(3))
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_train_state_numpy_roundtrip():
    jstate = _jax_state(1)
    pcfg = get_config("granite-3-2b").reduced()
    pstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), pcfg,
                                    device="cpu")
    back = train_state_to_numpy(pstate)
    for a, b in zip(_flat(back), jax.tree.leaves(jstate)):
        assert a.dtype != np.dtype("O")
        np.testing.assert_array_equal(a, np.asarray(b, np.float32)
                                      if a.dtype == np.float32 else b)
    assert int(back["step"]) == 12


# ---------------------------------------------------------------------------
# the health monitor and the migration policy (test_fault_tolerance.py's)
# ---------------------------------------------------------------------------


def test_health_monitor_flags_stragglers():
    mon = HealthMonitor(straggler_factor=1.5, ewma_alpha=1.0)
    for node in "abcd":
        mon.record_step(node, 1.0)
    mon.record_step("d", 2.0)
    assert mon.is_straggler("d")
    assert not mon.is_straggler("a")
    assert mon.straggler_score("d") > 0.5
    assert mon.straggler_score("a") == 0.0


def test_health_monitor_detects_dead_nodes():
    mon = HealthMonitor(heartbeat_timeout_s=10.0)
    mon.record_step("a", 1.0, now=100.0)
    mon.record_step("b", 1.0, now=105.0)
    assert mon.failed_nodes(now=112.0) == ["a"]


def test_health_monitor_injected_clock_is_deterministic():
    def make():
        ticks = iter(range(0, 10_000, 5))
        return HealthMonitor(heartbeat_timeout_s=12.0,
                             clock=lambda: float(next(ticks)))

    runs = []
    for _ in range(2):
        mon = make()
        for step, node in enumerate("abcabca"):
            mon.record_step(node, 1.0 + 0.1 * step)
        runs.append((mon.failed_nodes(), sorted(mon._ewma.items())))
    assert runs[0] == runs[1]
    assert runs[0][0] == ["b"]


def test_health_monitor_explicit_now_overrides_clock():
    boom = HealthMonitor(clock=lambda: 1 / 0, heartbeat_timeout_s=10.0)
    boom.record_step("a", 1.0, now=100.0)
    assert boom.failed_nodes(now=115.0) == ["a"]
    assert boom.failed_nodes(now=105.0) == []


def test_migration_policy_hysteresis():
    pol = MigrationPolicy(min_rank_advantage=0.2, cooldown_steps=100)
    d = pol.decide(step=1000, current_node=0,
                   scores=np.array([0.5, 0.45, 0.9]), remaining_steps=10_000)
    assert not d.migrate and "advantage" in d.reason
    d = pol.decide(step=1000, current_node=0,
                   scores=np.array([0.5, 0.1, 0.9]), remaining_steps=10_000)
    assert d.migrate and d.target == 1
    d2 = pol.decide(step=1050, current_node=1,
                    scores=np.array([0.0, 0.5, 0.9]), remaining_steps=10_000)
    assert not d2.migrate and d2.reason == "cooldown"


def test_migration_policy_respects_remaining_runtime():
    pol = MigrationPolicy(migration_cost_steps=50)
    d = pol.decide(step=0, current_node=0, scores=np.array([0.9, 0.1]),
                   remaining_steps=60)
    assert not d.migrate


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_failure_injection_recovers_and_matches_clean_run(tmp_path):
    """16 steps with a node failure at step 9 and a restart from the step
    8 checkpoint: the final loss equals the uninterrupted run's (rel 1e-4;
    the data order resumes from the pipeline state in the checkpoint)."""
    common = dict(steps=16, batch=4, seq=32, reduced=True, task="copy",
                  ckpt_every=4, log_every=100, device="cpu",
                  log=lambda m: None)
    clean = launch.train_loop("granite-3-2b",
                              ckpt_dir=str(tmp_path / "clean"), **common)
    inj = FailureInjector(schedule={9: "node_failure"})
    faulty = launch.train_loop("granite-3-2b",
                               ckpt_dir=str(tmp_path / "faulty"),
                               injector=inj, **common)
    assert faulty.restarts == 1 and clean.restarts == 0
    assert faulty.steps_done == clean.steps_done == 16
    assert len(faulty.losses) == 17          # step 8 replayed
    assert faulty.losses[-1] == pytest.approx(clean.losses[-1], rel=1e-4)
    assert int(faulty.final_state.step) == 16
    assert ckpt.latest_step(str(tmp_path / "faulty")) == 16


def test_launcher_resumes_from_an_existing_checkpoint(tmp_path):
    """A run started on a directory whose ``latest`` is another run's
    step-4 checkpoint resumes there and gives that run's losses."""
    common = dict(steps=6, batch=2, seq=16, ckpt_every=2, log_every=100,
                  device="cpu", log=lambda m: None)
    full = launch.train_loop("falcon-mamba-7b",
                             ckpt_dir=str(tmp_path / "a"), **common)
    shutil.copytree(tmp_path / "a" / "step_00000004",
                    tmp_path / "b" / "step_00000004")
    os.symlink("step_00000004", tmp_path / "b" / "latest")
    logs = []
    rest = launch.train_loop("falcon-mamba-7b", ckpt_dir=str(tmp_path / "b"),
                             **{**common, "log": logs.append})
    assert logs[0] == "[ckpt] resumed from step 4"
    assert rest.steps_done == 6 and rest.losses == full.losses[4:]


@pytest.mark.parametrize("arch", ["granite-3-2b", "falcon-mamba-7b",
                                  "h2o-danube-3-4b"])
def test_train_loop_trains_each_family_on_the_cpu(arch):
    """MAIZX places the job, the step-0 loss is ln V (the zero-init head),
    every loss and grad norm is finite, and the parameters moved."""
    logs = []
    run = launch.train_loop(arch, steps=4, batch=2, seq=72, device="cpu",
                            maizx_place=True, log=logs.append)
    assert logs[0].startswith("[maizx] placed job on pod")
    cfg = get_config(arch).reduced()
    assert run.losses[0] == pytest.approx(math.log(cfg.vocab), rel=1e-6)
    assert len(run.losses) == len(run.grad_norms) == len(run.step_s) == 4
    assert all(math.isfinite(x) for x in run.losses + run.grad_norms)
    assert int(run.final_state.step) == 4
    start = build_model(cfg).init(0, device="cpu")
    assert not torch.equal(run.final_state.params["lm_head"],
                           start["lm_head"])


def test_launcher_cli_on_the_cpu(capsys):
    run = launch.main(["--device", "cpu", "--steps", "3"])
    assert run.steps_done == 3 and len(run.losses) == 3
    assert all(math.isfinite(x) for x in run.losses)
    assert "done: 3 steps, restarts=0" in capsys.readouterr().out


def test_launcher_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--steps", "1"])


def test_meshes_and_compressed_sync_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 1\\(b\\)"):
        launch.train_loop("granite-3-2b", steps=1, batch=2, seq=8,
                          data_mesh=2, device="cpu")
    model = build_model(get_config("granite-3-2b").reduced())
    for sync in ("int8", "int16"):
        with pytest.raises(NotImplementedError, match="item 1\\(b\\)"):
            make_train_step(model, AdamWConfig(), grad_sync=sync)
    state = TrainState.create(model.init(0, device="cpu"))
    assert state.step.dtype == torch.int32 and int(state.step) == 0
