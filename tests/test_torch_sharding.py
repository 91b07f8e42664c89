"""The port's sharding rules and meshes against the reference's, in one
process (no ranks): ``resolve_spec`` on the reference's named cases and a
property over its dims and names, ``tree_specs`` of every arch on the
production shapes, ``ensemble_mesh``'s factorisation, the production and
host mesh shapes, and the DTensor placements of a spec against the
reference's ``NamedSharding.devices_indices_map`` (8 forced host devices,
in a subprocess, as ``tests/test_multidevice.py`` runs them)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # property tests skip; unit tests still run
    from _hypothesis_stub import given, settings, st
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.distributed import sharding as ref_sh
from repro.launch import mesh as ref_mesh
from repro.models.model import build_model as ref_build

from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import mesh as port_mesh
from repro_torch.models.model import build_model

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def ref_mesh2(data=16, model=16):
    return AbstractMesh((data, model), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)


def ref_mesh3():
    return AbstractMesh((2, 16, 16), ("pod", "data", "model"),
                        axis_types=(AxisType.Auto,) * 3)


MESH2 = MeshShape(("data", "model"), (16, 16))
MESH3 = MeshShape(("pod", "data", "model"), (2, 16, 16))


def as_tuple(spec: P) -> tuple:
    return tuple(spec)


NAMED = [  # tests/test_sharding_rules.py's five cases
    ((49155, 2048), ("vocab", "fsdp"), "2", P(None, "data")),
    ((163840, 2048), ("vocab", "fsdp"), "2", P("model", "data")),
    ((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", None), "2",
     P("data", "model", None, None)),
    ((256, 4096), ("batch", None), "3", P(("pod", "data"), None)),
    ((4096, 8192), ("fsdp", "tp"), "3", P("data", "model")),
]


@pytest.mark.parametrize("shape,axes,which,want", NAMED,
                         ids=["granite_vocab", "divisible_vocab", "kv_cache",
                              "batch_pod_data", "fsdp_excludes_pod"])
def test_resolve_spec_named_cases(shape, axes, which, want):
    ref = ref_sh.resolve_spec(shape, axes,
                              ref_mesh2() if which == "2" else ref_mesh3())
    port = sh.resolve_spec(shape, axes, MESH2 if which == "2" else MESH3)
    assert as_tuple(ref) == as_tuple(want)
    assert port == as_tuple(ref)


@settings(max_examples=100, deadline=None)
@given(dims=st.lists(st.sampled_from([1, 2, 3, 8, 24, 49155, 2048, 4096]),
                     min_size=1, max_size=4),
       names=st.lists(st.sampled_from(["batch", "fsdp", "tp", "vocab",
                                       "heads", "kv_seq", None]),
                      min_size=4, max_size=4),
       three=st.booleans())
def test_resolve_spec_property(dims, names, three):
    """Equal to the reference's on both production shapes, and valid: no
    mesh axis twice, every split divides its dim."""
    mesh, ref_m = (MESH3, ref_mesh3()) if three else (MESH2, ref_mesh2())
    spec = sh.resolve_spec(dims, names[:len(dims)], mesh)
    assert spec == as_tuple(ref_sh.resolve_spec(dims, names[:len(dims)],
                                                ref_m))
    sizes = dict(zip(mesh.names, mesh.sizes))
    used = [a for e in spec for a in sh.spec_axes(e)]
    assert len(used) == len(set(used))
    for dim, entry in zip(dims, spec):
        n = 1
        for a in sh.spec_axes(entry):
            n *= sizes[a]
        assert dim % n == 0


def test_resolve_spec_exclude_and_overrides():
    rules = sh.Rules().with_overrides(tp=(("data",), ()))
    ref_rules = ref_sh.Rules().with_overrides(tp=(("data",), ()))
    for excl in (frozenset(), frozenset({"model"}), frozenset({"data"})):
        for axes in (("fsdp", "tp"), ("tp", "fsdp"), ("batch", "vocab")):
            for r, rr in ((sh.Rules(), ref_sh.Rules()), (rules, ref_rules)):
                got = sh.resolve_spec((4096, 8192), axes, MESH3, r, excl)
                want = ref_sh.resolve_spec((4096, 8192), axes, ref_mesh3(),
                                           rr, excl)
                assert got == as_tuple(want), (excl, axes)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_tree_specs_every_arch_on_production_meshes(arch):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    ref_tpl = ref_build(REF_ARCHS[arch]).template()
    tpl = build_model(ARCHS[arch]).template()
    for mesh, ref_m in ((MESH2, ref_mesh2()), (MESH3, ref_mesh3())):
        want = jax.tree.leaves(ref_sh.tree_specs(ref_tpl, ref_m),
                               is_leaf=lambda x: isinstance(x, P))
        got = sh.tree_leaves(sh.tree_specs(tpl, mesh))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g == as_tuple(w), arch


def test_production_and_host_mesh_shapes():
    for multi in (False, True):
        m = port_mesh.make_production_mesh(multi_pod=multi)
        want = (("pod", "data", "model"), (2, 16, 16)) if multi else \
            (("data", "model"), (16, 16))
        assert (m.names, m.sizes) == want
        assert m.size == (512 if multi else 256)
    # the reference's rule for a size-1 pod axis (launch/mesh.py:30-36)
    for d, mo, p in ((1, 1, 1), (2, 2, 1), (2, 2, 2), (4, 1, 1), (1, 2, 4)):
        got = port_mesh.host_mesh_shape(d, mo, p)
        names = tuple(a for n, a in ((p, "pod"), (d, "data"), (mo, "model"))
                      if n > 1 or a != "pod")
        assert got.names == names
        assert got.size == d * mo * p
    assert port_mesh.CHIPS_PER_POD == ref_mesh.CHIPS_PER_POD


# ---------------------------------------------------------------------------
# against the reference on 8 forced host devices
# ---------------------------------------------------------------------------

LANES, NODES = (1, 2, 3, 4, 6, 8, 12), (1, 2, 5, 8, 16, 64)
LAYOUTS = [  # (mesh shape, axis names, tensor shape, spec)
    ((2, 2, 2), ("pod", "data", "model"), (8, 6), (("pod", "data"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 6, 4),
     (("pod", "data"), "model", None)),
    ((2, 2, 2), ("pod", "data", "model"), (4, 8), ("data", "model")),
    ((4, 2), ("data", "model"), (8, 16), ("data", "model")),
    ((4, 2), ("data", "model"), (8, 16), ("model", "data")),
    ((2, 4), ("data", "model"), (8, 16), (None, "model")),
    ((2, 4), ("data", "model"), (16, 8), (("data", "model"), None)),
    ((8,), ("e",), (8, 5), ("e", None)),
]

_REF_BODY = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.distributed.sharding import ensemble_mesh
devs = jax.devices()
assert len(devs) == 8
shapes = {}
for k in range(1, 9):
    for e in LANES:
        for n in NODES:
            m = ensemble_mesh(e, n, devs[:k])
            shapes[f"{k},{e},{n}"] = list(m.devices.shape)
index = []
for mshape, names, tshape, spec in LAYOUTS:
    mesh = Mesh(np.array(devs).reshape(mshape), names)
    entries = [tuple(x) if isinstance(x, list) else x for x in spec]
    imap = NamedSharding(mesh, P(*entries)).devices_indices_map(tuple(tshape))
    pos = {d.id: [int(c) for c in np.argwhere(mesh.devices == d)[0]]
           for d in devs}
    index.append([[pos[d.id], [[s.start or 0,
                                s.stop if s.stop is not None else t]
                               for s, t in zip(idx, tshape)]]
                  for d, idx in imap.items()])
print("JSON" + json.dumps({"shapes": shapes, "index": index}))
"""


@pytest.fixture(scope="module")
def ref8():
    code = (f"LANES = {LANES!r}\nNODES = {NODES!r}\nLAYOUTS = "
            f"{json.loads(json.dumps(LAYOUTS))!r}\n"
            + textwrap.dedent(_REF_BODY))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    line = [x for x in out.stdout.splitlines() if x.startswith("JSON")][0]
    return json.loads(line[4:])


def test_ensemble_mesh_factorisation(ref8):
    """(ne, nn) for 1-8 devices x lane and node counts == the reference's;
    without a process group the port gives a ``MeshShape``."""
    for key, want in ref8["shapes"].items():
        k, e, n = map(int, key.split(","))
        m = sh.ensemble_mesh(e, n, k)
        assert isinstance(m, MeshShape) and m.names == ("e", "n")
        assert list(m.sizes) == want, key
    assert sh.ensemble_mesh(8, 64).sizes == (1, 1)   # one rank


@pytest.mark.parametrize("case", range(len(LAYOUTS)))
def test_placements_match_devices_indices_map(ref8, case):
    """Each mesh position's local slice under the port's placements (the
    DTensor rule, ``Shard`` chunks in mesh order) == the index range the
    reference's ``NamedSharding`` gives the device there."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset as local_of)
    mshape, names, tshape, spec = LAYOUTS[case]
    pl = sh.placements(spec, MeshShape(names, mshape))
    seen = 0
    for coord, ranges in ref8["index"][case]:
        shape, offset = local_of(tshape, mshape, coord, pl)
        got = [[o, o + s] for o, s in zip(offset, shape)]
        assert got == ranges, (coord, spec)
        seen += 1
    assert seen == 8


def test_placements_refuse_an_order_against_the_mesh():
    with pytest.raises(ValueError, match="axis order"):
        sh.placements((("data", "pod"), None),
                      MeshShape(("pod", "data", "model"), (2, 2, 2)))
