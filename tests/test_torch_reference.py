"""The JAX reference, loaded for the port's parity tests, and the port's
static contract.

``import repro.core`` fails under jax 0.9: ``placement.py`` asks
``optimization_barrier_p in batching.primitive_batchers`` at import, and
the registry is now a proxy with no ``__contains__``.  ``load_reference``
installs a ``__contains__`` shim on the proxy's type only while it imports
``repro.core.*`` (the barrier rule then counts as registered; jax 0.9
ships one), keeps its own handles to the modules, then takes the shim and
the ``repro.core*`` entries it added back out.  The JAX package's own test
files therefore collect and fail exactly as without this loader.  Code
inside the reference that imports lazily runs under
``reference_imports()``, which puts the saved modules back for the call.

Every port test file imports the loader from here; it runs at test time,
never at collection.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_CORE = ("telemetry", "carbon", "energy", "ranking", "fleet", "placement",
         "scheduler", "forecast", "policy", "simulator", "scenarios", "cpp",
         "faults", "traffic", "router")
_REF: types.SimpleNamespace | None = None


def _proxy_type():
    from jax.interpreters import batching
    return type(batching.primitive_batchers)


def _is_core(name: str) -> bool:
    return name == "repro.core" or name.startswith("repro.core.")


def load_reference() -> types.SimpleNamespace:
    """The reference's modules (``repro.core.<name>`` plus the rank kernel
    modules ``ops``, ``maizx_rank``, ``kref``), imported once per process."""
    global _REF
    if _REF is not None:
        return _REF
    before = set(sys.modules)
    repro_pkg = sys.modules.get("repro")
    had_core_attr = repro_pkg is not None and hasattr(repro_pkg, "core")
    proxy = _proxy_type()
    shimmed = "__contains__" not in proxy.__dict__
    if shimmed:
        proxy.__contains__ = lambda self, key: True
    try:
        mods = {n: importlib.import_module(f"repro.core.{n}") for n in _CORE}
    finally:
        if shimmed:
            del proxy.__contains__
    mods["ops"] = importlib.import_module("repro.kernels.ops")
    mods["maizx_rank"] = importlib.import_module("repro.kernels.maizx_rank")
    mods["kref"] = importlib.import_module("repro.kernels.ref")
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k not in before and _is_core(k)}
    if not had_core_attr and hasattr(sys.modules["repro"], "core"):
        delattr(sys.modules["repro"], "core")
    # a failed ``import repro.core`` (the JAX test files' collection) leaves
    # the submodules it finished in sys.modules; those stay as they were
    _REF = types.SimpleNamespace(
        saved=saved, core_before={k for k in before if _is_core(k)}, **mods)
    return _REF


@contextlib.contextmanager
def reference_imports():
    """Put the reference's ``repro.core*`` modules back into
    ``sys.modules`` (and ``repro.core`` on the package) while a reference
    call that imports lazily runs; take them out again afterwards."""
    ref = load_reference()
    if not ref.saved:                # the reference imported on its own
        yield ref
        return
    pkg = sys.modules["repro"]
    sys.modules.update(ref.saved)
    pkg.core = ref.saved["repro.core"]
    try:
        yield ref
    finally:
        for k in ref.saved:
            sys.modules.pop(k, None)
        del pkg.core


def jnp():
    import jax.numpy
    return jax.numpy


def ref_fleet_arrays(fleet) -> dict:
    """The nine Fleet fields of a reference fleet, as numpy arrays."""
    from repro_torch.core.fleet import FIELDS
    return {f: np.asarray(getattr(fleet, f)) for f in FIELDS}


def port_fleet(ref_fleet, device="cpu"):
    from repro_torch.convert import fleet_from_numpy
    return fleet_from_numpy(ref_fleet_arrays(ref_fleet), device=device)


def ref_sim_config(cp):
    """The reference's ``SimConfig`` for the port's ``cp``: every field
    copied, the nested weights, policy, energy, fault and traffic configs
    rebuilt as the reference's own classes."""
    ref = load_reference()
    kw = {f.name: getattr(cp, f.name) for f in dataclasses.fields(cp)}
    for name, cls in (("weights", ref.ranking.RankWeights),
                      ("policy", ref.policy.PolicyConfig),
                      ("energy", ref.energy.EnergyModel),
                      ("faults", ref.faults.FaultConfig),
                      ("traffic", ref.traffic.TrafficConfig)):
        if kw[name] is not None:
            kw[name] = cls(**{f.name: getattr(kw[name], f.name)
                              for f in dataclasses.fields(kw[name])})
    return ref.simulator.SimConfig(**kw)


def bits(x) -> np.ndarray:
    """f32 values as their int32 bit patterns, for bitwise asserts."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the loader restores state
# ---------------------------------------------------------------------------


def _core_modules() -> set:
    return {k for k in sys.modules if _is_core(k)}


def test_reference_loader_restores_import_state():
    ref = load_reference()
    assert ref.placement.place_lifecycle_shortlist is not None
    assert "__contains__" not in _proxy_type().__dict__
    assert _core_modules() == ref.core_before
    assert not hasattr(sys.modules["repro"], "core")
    with reference_imports():
        assert sys.modules["repro.core.simulator"] is ref.simulator
    assert _core_modules() == ref.core_before
    assert not hasattr(sys.modules["repro"], "core")
    # the JAX package itself still fails to import as before
    with pytest.raises(TypeError):
        importlib.import_module("repro.core")
    for k in _core_modules() - ref.core_before:
        sys.modules.pop(k)


# ---------------------------------------------------------------------------
# the port's static contract
# ---------------------------------------------------------------------------


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_import_check_covers_the_policy_fault_and_cpp_modules():
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for mod in ("cpp", "faults", "policy", "forecast", "simulator",
                "traffic", "router"):
        assert f"src/repro_torch/core/{mod}.py" in names, mod


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("entry", ["synthetic_fleet", "lifecycle",
                                   "paper", "experiment", "calibrate",
                                   "convert", "energy", "sweep",
                                   "model_init", "serve_engine",
                                   "serve_main"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry,
                                                           monkeypatch):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import energy, fleet, scenarios, simulator
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "synthetic_fleet": lambda: fleet.synthetic_fleet(8),
        "lifecycle": lambda: simulator.synthetic_lifecycle_fleet(
            8, simulator.SimConfig(epochs=2, history_h=4, horizon_h=2)),
        "paper": lambda: simulator.paper_scenario_alloc(
            np.ones((3, 4)), np.ones(3), 0.5),
        "experiment": lambda: scenarios.run_paper_experiment(hours=4),
        "calibrate": lambda: scenarios.calibrate_dip_depth(iters=1,
                                                           hours=4),
        "convert": lambda: convert.fleet_from_numpy(
            {f: np.ones(4) for f in fleet.FIELDS}),
        "energy": lambda: energy.DEFAULT_ENERGY.device(),
        "sweep": lambda: simulator.sweep_policies(
            simulator.SimConfig(epochs=2, history_h=4, horizon_h=2),
            {"reactive": simulator.PolicyConfig()}, n=8),
        "model_init": lambda: build_model(
            get_config("granite-3-2b").reduced()).init(0),
        "serve_engine": lambda: ServeEngine(
            build_model(get_config("falcon-mamba-7b").reduced()), {},
            max_seq=8, batch_slots=1),
        "serve_main": lambda: serve.main(["--requests", "1", "--max-new",
                                          "2", "--prompt-len", "4"]),
    }
    with pytest.raises(RuntimeError, match="device="):
        calls[entry]()
