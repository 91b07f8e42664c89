"""The harness on the CPU: the traffic plan, the window's rate and tail
arithmetic, the result line, the refusal without a card, the trace's
reduction and what the benchmark's process imports."""
import json
import subprocess
import sys

import numpy as np
import pytest

from _bench_small import ROOT, TRAFFIC, context

from bench import cell as cell_mod
from bench import record
from bench import trace as trace_mod
from bench.drivers import serve
from bench.drivers.serve import Batch, ServeRun

# the cells BENCHMARK.json names, whatever they are
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("seed", [0, 17, 2**31 + 5, 2**40 + 3])
def test_plan_is_deterministic_and_cycles_are_permutations(seed):
    lengths = [1024, 2048, 3000]
    a, b = serve.Plan(seed, lengths, 8, 49155), \
        serve.Plan(seed, lengths, 8, 49155)
    got = [a.length(i) for i in range(30)]
    assert got == [b.length(i) for i in range(30)]
    for c in range(10):
        assert sorted(got[3 * c:3 * c + 3]) == lengths
    assert np.array_equal(a.prompts(4), b.prompts(4))
    p = a.prompts(4)
    assert p.shape == (8, a.length(4)) and 0 <= p.min() and p.max() < 49155
    other = serve.Plan(seed + 1, lengths, 8, 49155)
    assert not np.array_equal(other.prompts(0)[:, :16], p[:, :16])


def _run(stall: float = 0.0) -> ServeRun:
    """A synthetic window of 10 batches of 8 rows, P 100, 4 tokens, 1 s
    each (0.4 s prefill, three 0.2 s decode steps); batch 3 stalls
    ``stall`` s before its prefill ends."""
    costs = cell_mod.module("costs", "dense")
    cfg = {"n_layers": 1, "d_model": 4, "n_heads": 1, "n_kv_heads": 1,
           "head_dim": 4, "d_ff": 4, "vocab": 10}
    batches, t = [], 0.0
    for i in range(10):
        d = stall if i == 3 else 0.0
        b = Batch(i, 100, 8, submit=t, prefill_at=t)
        b.decode_at = [t + 0.4 + d, t + 0.6 + d, t + 0.8 + d]
        b.done = t + 1.0 + d
        batches.append(b)
        t = b.done
    return ServeRun("x", cfg, 1.0, attempted=80, costs=costs, t0=0.0, t1=t,
                    batches=batches)


def test_rate_and_tail_are_over_the_whole_window():
    mods = {m: cell_mod.module("metrics", m)
            for m in ("tokens_per_s", "latency_p95_ms")}
    base = _run()
    # 10 whole batches of 8 x (100 + 4) tokens in 10 s
    assert mods["tokens_per_s"].read(base) == pytest.approx(832.0)
    assert mods["latency_p95_ms"].read(base) == pytest.approx(1000.0)
    assert len(base.latencies_s()) == 80
    # a stall of 2 s in one batch: the window is 12 s for the same work,
    # and that batch's 8 requests are the slowest 10 %
    stalled = _run(stall=2.0)
    assert mods["tokens_per_s"].read(stalled) == pytest.approx(8320 / 12)
    assert mods["latency_p95_ms"].read(stalled) == pytest.approx(3000.0)
    _, flops = stalled.work_in_window()
    assert flops == base.work_in_window()[1] > 0


def test_result_line_has_the_contract_keys_checks_last():
    run = _run()
    run.checks = {"gap_max": {"value": 0.1, "limit": 0.2}}
    line = json.loads(record.result_line(run, {}, {"platform": "gpu"}))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    line = json.loads(record.result_line(run, {}, {}, {"device_ops": []}))
    assert list(line)[-2:] == ["breakdown", "checks"]


def test_benchmark_json_names_files_that_exist():
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bm["end_to_end"] + bm["per_layer"]}
    for n in names:
        assert (ROOT / "bench" / "metrics" / f"{n}.py").is_file(), n
    assert CELLS and len(set(CELLS)) == len(CELLS)
    for name in CELLS:
        c = cell_mod.load(name, ROOT)
        assert (ROOT / "bench" / "drivers" /
                f"{c.traffic['driver']}.py").is_file()
        assert (ROOT / "bench" / "reference" / f"{c.family}.py").is_file()
        assert c.limits is not None
        assert "setup_s" in [m["name"] for m in c.end_to_end]
        assert c.per_layer


@pytest.mark.parametrize("name", CELLS)
def test_configuration_files_match_the_port(name):
    from repro_torch.configs import get_config
    c = cell_mod.load(name, ROOT)
    cell_mod.check_arch(c.cfg, get_config(c.cfg["arch"]))


def test_refuses_to_measure_without_a_card():
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_nothing_loads_jax_or_the_jax_package():
    """The harness, its drivers, readers and references load no module
    whose top-level name is jax, jaxlib, flax or repro (compared whole:
    repro_torch is not repro); the references load nothing of
    repro_torch."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "import bench.reference.dense, bench.reference.hybrid\n"
        "tops = {{m.split('.')[0] for m in sys.modules}}\n"
        "assert 'repro_torch' not in tops, 'reference loads the port'\n"
        "import bench.run, bench.calibrate, bench.drivers.serve\n"
        "from bench import cell, record\n"
        "for m in ({metrics}): cell.module('metrics', m)\n"
        "import repro_torch.serve.engine, repro_torch.models.model\n"
        "print(record.forbidden_modules())\n").format(
            root=str(ROOT), src=str(ROOT / "src"),
            metrics=", ".join(repr(p.stem) for p in sorted(
                (ROOT / "bench" / "metrics").glob("[a-z]*.py"))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert record.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    sys.modules.setdefault("repro_torch_x", sys)
    assert "repro_torch_x" not in record.forbidden_modules()


def test_trace_reduction():
    """Busy time is the union of device intervals inside the unit's span;
    each idle gap is named by the innermost host op at its middle."""
    dev = [("k1", 1.0, 2.0), ("k2", 1.5, 3.2), ("k3", 5.0, 6.0),
           ("k1", 6.0, 6.5), ("outside", 20.0, 21.0)]
    host = [(trace_mod.UNIT, 0.5, 8.0), ("bench.decode", 3.0, 5.5),
            ("aten::item", 3.5, 4.9), ("cudaGraphLaunch", 6.6, 7.9)]
    t = trace_mod.reduce(dev, host)
    assert t.window_s == pytest.approx(7.5)
    assert t.busy_s == pytest.approx(2.2 + 1.0 + 0.5)
    assert t.seconds(r"k1") == pytest.approx(1.5)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k2", pytest.approx(1.7)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(1.8)
    assert gaps["(no host op)"] == pytest.approx(0.5)
    assert gaps["cudaGraphLaunch"] == pytest.approx(1.5)


def test_a_small_cell_runs_end_to_end_on_the_cpu():
    """The serve driver and the result's readers at a tiny size: every
    length served, the engine's timings read, the check passes."""
    from bench import run as run_mod
    run = serve.run(context("granite-3-2b", 11, 0.5, seconds=2.0))
    assert run.correct, run.checks
    assert {b.prompt_len for b in run.batches} == {16, 24, 40}
    cell = cell_mod.load(CELLS[0], ROOT)
    _, line = run_mod.report(cell, run, False, "cpu")
    line = json.loads(line)
    assert set(line["metrics"]) == {"tokens_per_s", "latency_p95_ms",
                                    "setup_s"}
    assert line["metrics"]["tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("seconds", [0.0, 1.0])
def test_window_holds_whole_cycles(seconds):
    """The window closes at the end of a cycle: every prompt length is
    served equally often, each cycle in the seed's order."""
    run = serve.run(context("granite-3-2b", 5, 0.5, seconds=seconds))
    lengths = sorted(TRAFFIC["prompt_lengths"])
    got = [b.prompt_len for b in run.batches]
    assert len(got) % 3 == 0 and len(got) >= 3
    for c in range(len(got) // 3):
        assert sorted(got[3 * c:3 * c + 3]) == lengths
    assert run.t1 == run.batches[-1].done


class _FakeProfile:
    """Stands in for ``trace.Profile`` on the CPU: records when it ran."""
    seen = []

    def start(self):
        import time
        self.t_start = time.perf_counter()
        _FakeProfile.seen.append(self)

    def stop(self):
        import time
        self.t_stop = time.perf_counter()

    def reduce(self):
        return trace_mod.reduce([("k", 0.0, 1.0)],
                                [(trace_mod.UNIT, 0.0, 2.0)])


def test_traced_unit_runs_after_the_window(monkeypatch):
    """A traced run profiles ``trace.batches`` more batches once the
    window has closed; the window's batches and engine timings are those
    of an untraced run."""
    monkeypatch.setattr(trace_mod, "Profile", _FakeProfile)
    monkeypatch.setattr(trace_mod, "warm", lambda: None)
    _FakeProfile.seen.clear()
    run = serve.run(context("granite-3-2b", 7, 0.5, trace=True))
    assert len(_FakeProfile.seen) == 1
    p = _FakeProfile.seen[0]
    assert run.t1 <= p.t_start and p.t_stop >= run.traced[-1].done
    n = len(run.batches)
    assert [b.index for b in run.traced] == [n, n + 1, n + 2]
    assert all(b.submit >= run.t1 for b in run.traced)
    assert run.engine_delta("prefills") == n
    assert run.trace.busy_s == pytest.approx(1.0)
    assert run.correct, run.checks
