"""The dry run of a mesh against the reference's, in one process over a
world of the ``"fake"`` backend (``launch.mesh.make_fake_mesh``):
``tree_sds``' local shards == the reference's ``NamedSharding.shard_shape``
for every arch's inputs on both production meshes at full width; the
placements ``constrain`` / ``constrain_pref`` give under
``activation_sharding`` == the reference's ``resolve_spec`` (manual axes
excluded in the pod route); the bytes a known redistribute bills per
kind; a reduced cell on the (16, 16) and (2, 16, 16) meshes; the
collective bytes per device of a reduced train cell against the
reference's dry run of the same cell (``hlo_cost``), compiled in a
subprocess with forced host devices: within 1 % under pure data
parallelism, printed side by side with the default rules."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import (AbstractMesh, AxisType, NamedSharding,
                          PartitionSpec as P)

from repro.configs import ARCHS as REF_ARCHS
from repro.distributed import sharding as ref_sh
from repro.launch import settings as rsettings
from repro.models.model import build_model as ref_build
from repro.train.optimizer import opt_template as ref_opt_template

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.settings import cell_settings
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import opt_template

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
POD = MeshShape(("data", "model"), (16, 16))
MULTIPOD = MeshShape(("pod", "data", "model"), (2, 16, 16))


@pytest.fixture(scope="module")
def fake():
    """A fake world of 512 ranks for the module (this process is rank
    0), ended after it; one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    port_mesh.make_fake_mesh(MULTIPOD)
    yield
    port_mesh.close_fake_world()
    torch.set_num_threads(n)
    assert not torch.distributed.is_initialized()


def ref_abstract(shape: MeshShape):
    return AbstractMesh(shape.sizes, shape.names,
                        axis_types=(AxisType.Auto,) * len(shape.names))


def _ref_param(p):
    return ref_sh.Param(p.shape, p.axes)


def _inputs(arch: str, shape: ShapeSpec):
    """(port templates, reference templates) of a cell's inputs by name."""
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    model, rmodel = build_model(cfg), ref_build(rcfg)
    port = {"batch": dryrun.batch_template(cfg, shape),
            "params": model.template()}
    ref = {"batch": sh.tree_map(_ref_param, port["batch"]),
           "params": rmodel.template()}
    if shape.kind == "train":
        port["opt"], ref["opt"] = (opt_template(port["params"]),
                                   ref_opt_template(ref["params"]))
    if shape.kind == "decode":
        port["caches"] = model.cache_template(shape.global_batch,
                                              shape.seq_len)
        ref["caches"] = rmodel.cache_template(shape.global_batch,
                                              shape.seq_len)
    return port, ref


def _ref_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _ref_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("mesh_shape", [POD, MULTIPOD],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_tree_sds_local_shards_are_the_references_shard_shapes(
        fake, arch, mesh_shape):
    """Every input of every shape of the arch, in both modes' rules: each
    meta DTensor's local shard has the reference's per-device shape, its
    global shape and dtype the template's."""
    mesh = port_mesh.make_fake_mesh(mesh_shape)
    rmesh = ref_abstract(mesh_shape)
    for sname, shape in SHAPES.items():
        if not ARCHS[arch].supports_shape(shape):
            continue
        port, ref = _inputs(arch, shape)
        for mode in ("baseline", "optimized"):
            rules = cell_settings(ARCHS[arch], shape, mode).rules
            rrules = rsettings.cell_settings(REF_ARCHS[arch], shape,
                                             mode).rules
            for k in port:
                sds = sh.tree_leaves(sh.tree_sds(port[k], mesh, rules))
                tpl = sh.tree_leaves(port[k])
                rps = _ref_leaves(ref[k])
                assert len(sds) == len(rps) == len(tpl)
                for x, p, rp in zip(sds, tpl, rps):
                    want = NamedSharding(rmesh, ref_sh.resolve_spec(
                        rp.shape, rp.axes, rmesh, rrules)).shard_shape(
                            rp.shape)
                    assert tuple(x.to_local().shape) == want, (
                        arch, sname, mode, k, rp.shape, rp.axes)
                    assert tuple(x.shape) == p.shape and x.dtype == p.dtype
                    assert x.to_local().device.type == "meta"


CONSTRAINED = [  # (shape, axes) of the reference's constraint sites
    ((8, 16, 32), ("batch", "seq", None)),
    ((8, 16, 64), ("batch", "seq", "tp")),
    ((8, 16, 12), ("batch", "seq", "vocab")),
    ((8, 16, 4, 2, 8), ("batch", "seq", "kv_heads", None, None)),
    ((8, 16, 3, 8), ("batch", "seq", "kv_heads", None)),
    ((8, 4, 6, 16), ("batch", "experts", None, "tp")),
    ((8, 16, 4, 2), ("batch", None, "ssm_inner", None)),
    ((6, 16, 32), ("batch", "seq", "ssm_inner")),
]
PREF = (("batch", None, "heads", None), ("batch", "sp_seq", None, None))


def _ref_placements(shape, axes, rmesh, mesh, exclude=frozenset()):
    spec = tuple(ref_sh.resolve_spec(shape, axes, rmesh, ref_sh.Rules(),
                                     exclude=exclude))
    spec = tuple(None if e is None else e for e in spec)
    return sh.placements(spec, mesh)


def _ref_pref(shape, rmesh, mesh, exclude=frozenset()):
    """The reference's ``constrain_pref`` choice: the first option whose
    spec splits over the most ranks."""
    sizes = dict(zip(rmesh.axis_names, rmesh.axis_sizes))
    best, best_n = None, -1
    for axes in PREF:
        spec = ref_sh.resolve_spec(shape, axes, rmesh, ref_sh.Rules(),
                                   exclude=exclude)
        n = 1
        for e in spec:
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                n *= sizes[a]
        if n > best_n:
            best, best_n = tuple(spec), n
    return sh.placements(best, mesh)


def test_constraints_place_as_the_references_resolve_spec(fake):
    """On a (2, 2, 2) mesh: outside ``activation_sharding`` a constraint
    returns its argument; inside, its placements are the reference's
    spec's; in the pod route (a DTensor on the (data, model) submesh)
    the manual ``pod`` axis is excluded, as the reference's ``shard_map``
    region excludes it."""
    from torch.distributed.tensor import Replicate
    mesh = port_mesh.make_fake_mesh(MeshShape(("pod", "data", "model"),
                                              (2, 2, 2)))
    rmesh = ref_abstract(MeshShape(("pod", "data", "model"), (2, 2, 2)))
    _, sub, rest = sh.pod_split(mesh)
    for shape, axes in CONSTRAINED:
        x = sh.meta_dtensor(shape, torch.float32, mesh, (None,) * len(shape))
        assert sh.constrain(x, *axes) is x
        with sh.activation_sharding(mesh):
            got = sh.constrain(x, *axes)
            assert tuple(got.placements) == _ref_placements(shape, axes,
                                                            rmesh, mesh)
            xs = sh.meta_dtensor(shape, torch.float32, sub,
                                 (None,) * len(shape))
            got = sh.constrain(xs, *axes)
            assert got.device_mesh is sub
            assert tuple(got.placements) == _ref_placements(
                shape, axes, rmesh, sub, exclude=frozenset({"pod"}))
            plain = torch.empty(shape, device="meta")
            assert sh.constrain(plain, *axes) is plain
    for shape in ((8, 16, 4, 8), (8, 16, 3, 8)):   # heads divide, or not
        x = sh.meta_dtensor(shape, torch.float32, mesh, (None,) * 4)
        assert sh.constrain_pref(x, *PREF) is x
        with sh.activation_sharding(mesh):
            got = sh.constrain_pref(x, *PREF)
            assert tuple(got.placements) == _ref_pref(shape, rmesh, mesh)
            xs = sh.meta_dtensor(shape, torch.float32, sub, (None,) * 4)
            assert tuple(sh.constrain_pref(xs, *PREF).placements) == \
                _ref_pref(shape, rmesh, sub, exclude=frozenset({"pod"}))
    one = port_mesh.make_fake_mesh(MeshShape(("data",), (1,)))
    x = sh.meta_dtensor((8, 4), torch.float32, one, (None, None))
    with sh.activation_sharding(one):
        assert sh.constrain(x, "batch", None) is x
    assert tuple(x.placements) == (Replicate(),)


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all"])
def test_step_counter_bills_a_known_redistribute(fake, kind):
    """Each collective a redistribute issues is billed at this rank's
    result bytes, weighted as the reference's ``collective_bytes`` (an
    all-reduce 2x), and at least 2x its result bytes to the memory
    term."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch.step_cost import StepCounter
    mesh = port_mesh.make_fake_mesh(MeshShape(("data", "model"), (4, 2)))
    src, dst, result = {
        "all-gather": ([Shard(0), Replicate()], [Replicate()] * 2,
                       64 * 32 * 4),
        "all-reduce": ([Partial(), Replicate()], [Replicate()] * 2,
                       64 * 32 * 4),
        "reduce-scatter": ([Partial(), Replicate()],
                           [Shard(0), Replicate()], 16 * 32 * 4),
        "all-to-all": ([Shard(0), Replicate()], [Shard(1), Replicate()],
                       64 * 8 * 4)}[kind]
    from torch.distributed.tensor import DTensor
    local = torch.empty((16 if isinstance(src[0], Shard) else 64, 32),
                        device="meta")
    x = DTensor.from_local(local, mesh, src, shape=(64, 32),
                           stride=(32, 1), run_check=False)
    with StepCounter() as c:
        y = x.redistribute(mesh, dst)
    assert tuple(y.placements) == tuple(dst)
    weight = 2.0 if kind == "all-reduce" else 1.0
    assert dict(c.cost.coll_per_kind) == {kind: weight * result}
    assert c.cost.coll_bytes == weight * result
    # the local copies DTensor makes around it (a chunk, a cat) bill too
    assert c.cost.bytes >= 2.0 * result


REDUCED = dict(d_model=256, n_heads=16, n_kv_heads=4, head_dim=16,
               d_ff=512, vocab=512, n_layers=2)


def _reduced_cell(mesh, shape, mode="baseline", replicate=(), layers=2):
    """The reduced granite cell (of ``layers`` layers) counted on
    ``mesh``; the logical axes in ``replicate`` resolve to replication."""
    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              **dict(REDUCED, n_layers=layers))
    st = cell_settings(cfg, shape, mode)
    model = build_model(cfg, st.flags)
    rules = st.rules.with_overrides(**{a: ((),) for a in replicate})
    return dryrun.count_cell(cfg, shape, model, st.microbatches, mesh=mesh,
                             rules=rules, grad_sync=st.grad_sync,
                             constrain_acts=st.constrain_acts)


@pytest.mark.parametrize("mesh_shape", [POD, MULTIPOD],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("mode", ["baseline", "optimized"])
def test_reduced_cell_dry_runs_on_the_production_meshes(fake, mesh_shape,
                                                        mode):
    """A train cell whose widths divide the mesh (d_model 256, 16 heads,
    d_ff 512, vocab 512, 2 layers) runs on the fake (16, 16) and (2, 16,
    16) meshes, with and without the activation constraints, and bills
    collective bytes per device; every input's local bytes are the
    reference's per-device shard."""
    mesh = port_mesh.make_fake_mesh(mesh_shape)
    shape = ShapeSpec("train_4k", "train", 64, 32)
    specs, out, c = _reduced_cell(mesh, shape, mode)
    assert c.cost.coll_bytes > 0 and c.cost.flops > 0
    assert c.cost.coll_bytes == sum(c.cost.coll_per_kind.values())
    state, metrics = out
    assert set(metrics) >= {"loss", "grad_norm"}
    lead = sh.tree_leaves(state.params)[0]
    assert lead.device_mesh is mesh


# the reduced MoE and hybrid train cells on the production meshes: widths
# that divide 16 (zamba2: d_inner 512 in 16 heads of 32, the tied
# attention block after each pair of Mamba-2 blocks; moonshot: 16 experts,
# top 2)
FAMILY_REDUCED = {
    "zamba2-1.2b": dict(REDUCED, n_kv_heads=16, ssm_state=16,
                        ssm_head_dim=32, attn_every=2),
    "moonshot-v1-16b-a3b": dict(REDUCED, n_kv_heads=16, n_experts=16,
                                top_k=2),
}


@pytest.mark.parametrize("mesh_shape", [POD, MULTIPOD],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch,mode", [("zamba2-1.2b", "optimized"),
                                       ("moonshot-v1-16b-a3b", "baseline")],
                         ids=["zamba2-ssd", "moonshot"])
def test_reduced_family_cell_dry_runs_on_the_production_meshes(
        fake, mesh_shape, arch, mode):
    """Cases of ``test_reduced_cell_dry_runs_on_the_production_meshes``
    for the hybrid (zamba2's optimized setting: the SSD route, whose
    chunks each rank runs on its own rows and heads) and the MoE: the
    train cell runs on the fake (16, 16) and (2, 16, 16) meshes and bills
    collective bytes per device."""
    mesh = port_mesh.make_fake_mesh(mesh_shape)
    cfg = dataclasses.replace(get_config(arch), **FAMILY_REDUCED[arch])
    shape = ShapeSpec("train_4k", "train", 64, 32)
    st = cell_settings(cfg, shape, mode)
    assert st.flags.ssm_algo == ("ssd" if arch == "zamba2-1.2b" else "scan")
    model = build_model(cfg, st.flags)
    _, out, c = dryrun.count_cell(cfg, shape, model, st.microbatches,
                                  mesh=mesh, rules=st.rules,
                                  grad_sync=st.grad_sync,
                                  constrain_acts=st.constrain_acts)
    assert c.cost.coll_bytes > 0 and c.cost.flops > 0
    assert c.cost.coll_bytes == sum(c.cost.coll_per_kind.values())
    state, metrics = out
    assert set(metrics) >= {"loss", "grad_norm"}
    assert sh.tree_leaves(state.params)[0].device_mesh is mesh


REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    n = int(sys.argv[1]); axes = json.loads(sys.argv[2])
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    import dataclasses, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.sharding import tree_sds, Param, Rules
    from repro.launch import hlo_cost, roofline as rl
    from repro.models.model import build_model
    from repro.train.optimizer import AdamWConfig, opt_template
    from repro.train.train_step import make_train_step, TrainState
    cfg = dataclasses.replace(get_config("granite-3-2b"), **json.loads(
        sys.argv[3]))
    rules = Rules().with_overrides(**{a: ((),) for a in json.loads(
        sys.argv[4])})
    B, S = 8, 64
    model = build_model(cfg)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(
        [s for _, s in axes]), tuple(a for a, _ in axes))
    bt = {k: Param((B, S), ("batch", None), dtype=jnp.int32)
          for k in ("tokens", "labels")}
    tpl = model.template()
    args = (tree_sds(tpl, mesh, rules),
            tree_sds(opt_template(tpl), mesh, rules),
            jax.ShapeDtypeStruct((), jnp.int32), tree_sds(bt, mesh, rules))
    step = make_train_step(model, AdamWConfig(), mesh=mesh)
    def fn(params, opt, t, batch):
        s, m = step(TrainState(params=params, opt=opt, step=t), batch)
        return s.params, s.opt, s.step, m
    sh = tuple(jax.tree.map(lambda s: s.sharding, a) for a in args)
    c = jax.jit(fn, out_shardings=(sh[0], sh[1], None, None)).lower(
        *args).compile()
    cost = hlo_cost.analyze(c.as_text())
    once, _ = rl.collective_bytes(c.as_text())
    print(json.dumps({"total": cost.coll_bytes,
                      "per_kind": cost.coll_per_kind, "loop_once": once}))
""")


def _reference_collectives(axes, replicate=(), layers=2):
    """The reference's collective bytes per device for the reduced train
    cell (batch 8 x 64) on a mesh of ``axes``, compiled for as many host
    devices in a subprocess: ``hlo_cost``'s loop-scaled count, which its
    dry run reports (``loop_once``: ``roofline.collective_bytes``, which
    reads the scanned layer's collectives once)."""
    n = 1
    for _, s in axes:
        n *= s
    out = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(n), json.dumps(axes),
         json.dumps(dict(REDUCED, n_layers=layers)),
         json.dumps(list(replicate))],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_collectives(axes, replicate=(), layers=2):
    mesh = port_mesh.make_fake_mesh(MeshShape(tuple(a for a, _ in axes),
                                              tuple(s for _, s in axes)))
    shape = ShapeSpec("train_4k", "train", 64, 8)
    specs, _, c = _reduced_cell(mesh, shape, replicate=replicate,
                                layers=layers)
    return specs, {"total": c.cost.coll_bytes,
                   "per_kind": dict(c.cost.coll_per_kind)}


@pytest.mark.parametrize("layers", [1, 2])
def test_collective_bytes_of_pure_data_parallel_match_the_references(
        fake, layers):
    """Pure data parallelism on (data 4): every parameter replicated
    (``fsdp`` and ``vocab`` resolve to replication), the batch split.
    Both plans then do the same work: one all-reduce of the f32 gradient
    of every parameter, and the loss's scalars.  The port's collective
    bytes per device are within 1 % of the reference's dry run's for the
    same cell (and all-reduce is the only kind); at one layer, where its
    scanned stack runs once, also of ``roofline.collective_bytes``."""
    axes, rep = (("data", 4),), ("fsdp", "vocab")
    ref = _reference_collectives(axes, rep, layers)
    specs, port = _port_collectives(axes, rep, layers)
    print(f"\npure data parallel, data 4, {layers} layer(s): port {port}"
          f"\nreference {ref}")
    assert set(port["per_kind"]) == set(ref["per_kind"]) == {"all-reduce"}
    assert abs(port["total"] - ref["total"]) <= 0.01 * ref["total"]
    if layers == 1:
        assert abs(port["total"] - ref["loop_once"]) \
            <= 0.01 * ref["loop_once"]
    # the f32 gradient of every parameter, all-reduced (2x) once
    grads = sum(4 * p.numel() for p in sh.tree_leaves(specs["params"]))
    assert 2 * grads <= port["total"] <= 2 * grads + 64


@pytest.mark.parametrize("axes", [(("data", 4),),
                                  (("data", 2), ("model", 2))],
                         ids=["data4", "data2-model2"])
def test_collective_bytes_beside_the_references(fake, axes):
    """The reduced train cell (batch 8 x 64) with the default rules on
    (data 4) and on (data 2, model 2): the port's collective bytes per
    device, by kind, printed beside the reference's dry run's (PERF.md
    §7 names the gaps: XLA's CPU partitioner all-reduces batch-replicated
    activations where the port's plan gathers each fsdp-split parameter
    at use and reduce-scatters its gradient).  On (data 4) the port's
    plan is FSDP's: its all-gathers are each data-split parameter once,
    whole, in its own dtype, and its reduce-scatters each one's f32
    gradient shard once."""
    ref = _reference_collectives(axes)
    specs, port = _port_collectives(axes)
    print(f"\n{dict(axes)}: port {port}\n{dict(axes)}: reference {ref}")
    assert port["total"] > 0 and ref["total"] > 0
    if len(axes) == 1:
        split = [p for p in sh.tree_leaves(specs["params"])
                 if p.to_local().numel() < p.numel()]
        assert port["per_kind"]["all-gather"] == sum(
            p.numel() * p.element_size() for p in split)
        assert port["per_kind"]["reduce-scatter"] == sum(
            4 * p.to_local().numel() for p in split)
