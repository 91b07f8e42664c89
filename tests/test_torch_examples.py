"""The five examples on the PyTorch port (``examples/torch/``), each run
on the CPU in its own process with one torch thread (green_window_planner
at a month where the script runs a year); ``multicloud_serve``'s
modeled energy line against the reference's ``for_workload`` /
``workload_roofline``."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

from test_torch_reference import ROOT, load_reference, reference_imports

EXAMPLES = ROOT / "examples" / "torch"


def run_example(name: str, timeout: float, call: str = "") -> str:
    """The example's stdout: the script itself, or with ``call`` that
    Python run after importing the script as a module (``DEVICE`` set to
    the CPU)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    if call:
        cmd = ["-c", f"import sys; sys.path.insert(0, {str(EXAMPLES)!r}); "
                     f"import {name} as ex; ex.DEVICE = 'cpu'; {call}"]
    else:
        cmd = [str(EXAMPLES / f"{name}.py"), "--device", "cpu"]
    out = subprocess.run([sys.executable, *cmd], capture_output=True,
                         text=True, timeout=timeout, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_examples_import_no_jax():
    for path in sorted(EXAMPLES.glob("*.py")):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from repro." not in text and "import repro." not in text, \
            path


@pytest.mark.parametrize("name,call,lines", [
    ("quickstart", "", ("MAIZX placed the job on pod", "loss: ",
                        "generated: ")),
    ("carbon_aware_training", "", ("initial placement", "migrations",
                                   "emissions: carbon-aware")),
    ("scenario_replay", "", ("reproduced: -85.68%",
                             "units required            27,686,054",
                             "bit-identical placements")),
    # the script runs scene 1 over a simulated year of a 4,096-node fleet,
    # twice, through the scanned driver: minutes on the CPU; here its
    # scenes run with scene 1 over a month (the year runs on the card, in
    # chip_smoke.py's phase 16 (d))
    ("green_window_planner",
     "ex.scene_migration(epochs=720); ex.scene_deferral()",
     ("== scene 1", "720 simulated hours", "planner:", "== scene 2",
      "into forecast-green")),
], ids=("quickstart", "carbon_aware_training", "scenario_replay",
        "green_window_planner"))
def test_example_runs_on_the_cpu(name, call, lines):
    out = run_example(name, 300, call)
    for line in lines:
        assert line in out, (line, out[-2000:])


def test_multicloud_serve_energy_equals_reference():
    out = run_example("multicloud_serve", 300)
    ref = load_reference()
    from repro.configs import ARCHS
    from repro.configs.base import SHAPES
    with reference_imports():
        cfg = ARCHS["musicgen-medium"].reduced()
        em = ref.energy.DEFAULT_ENERGY.for_workload(cfg, SHAPES["decode_32k"],
                                                    chips=4)
        rf = ref.energy.workload_roofline(cfg, SHAPES["decode_32k"], chips=4)
    service_s = rf.step_s * 4
    per_batch = em.job_energy_kwh(service_s, 1, 4)
    want = (f"workload-calibrated energy: {per_batch * 1e3:.4f} Wh/batch "
            f"({em.chip_power_w:.1f} W/chip at the decode roofline)")
    assert want in out.splitlines(), (want, out[-1500:])
    assert out.count("routed->") == 12 and "total             48" in out
