"""A cell of ``BENCHMARK.json`` and the files it names: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<mix>.json``), the
limits of its correctness check (``limits/<cell>.json``), the metrics it
reports, and the modules found by name (``drivers/<driver>.py``,
``reference/<family>.py``, ``costs/<family>.py``, ``metrics/<metric>.py``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the sizes a configuration file states under the port's ArchConfig names;
# each one the file has must equal the port's configuration
SIZE_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
             "head_dim", "d_ff", "vocab", "mlp", "rope", "rope_theta",
             "norm_eps", "tie_embeddings", "ssm_variant", "ssm_state",
             "ssm_conv", "expand", "ssm_head_dim", "attn_every")


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


def module(kind: str, name: str) -> ModuleType:
    """``bench/<kind>/<name>.py``, loaded once as ``bench.<kind>.<name>``."""
    key = f"bench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Optional[Dict]

    def metrics(self, trace: bool) -> List[Dict]:
        """The metrics a run reports: end-to-end with ``--trace 0``,
        per-layer with ``--trace 1``."""
        return self.per_layer if trace else self.end_to_end

    @property
    def family(self) -> str:
        return self.cfg["family"]


def _for_cell(metrics: List[Dict], name: str) -> List[Dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bm = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bm["configs"]}[w["config"]]
    cfg = _json(root / cfg_entry["file"])
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    lim = BENCH / "limits" / f"{name}.json"
    return Cell(name, w["chips"], cfg, traffic,
                _for_cell(bm["end_to_end"], name),
                _for_cell(bm["per_layer"], name),
                _json(lim) if lim.is_file() else None)


def check_arch(cfg: Dict, arch) -> None:
    """Raise unless the port's configuration has every size the file
    states: the benchmark runs the model its file describes."""
    bad = {k: (cfg[k], getattr(arch, k, None)) for k in SIZE_KEYS
           if k in cfg and getattr(arch, k, None) != cfg[k]}
    if bad:
        raise ValueError(f"the port's {cfg['arch']} differs from its "
                         f"configuration file (file, port): {bad}")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device and
    the process's start.  ``arch`` replaces the port's configuration of
    ``cell.cfg["arch"]`` (the tests' small models; its sizes must still
    match ``cell.cfg``); ``fault`` wraps the engine's steps (the tests'
    planted faults, ``bench/faults.py``): ``fault(kind, fn) -> fn``.
    ``control`` runs the check's control: the tokens the float8 reference
    puts first stand in for the served ones (``bench/calibrate.py``; the
    benchmark's own runs do not)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    arch: object = None
    fault: object = None
    control: bool = False
