"""The program's spans in the trace's reduction on the CPU: they are host
ops, so the busy time, the device ops and the gaps' times are those of
the same events without them (a gap under no other host op may carry a
span's name); the readers of the engine's decode counters give values on
a small cell and nothing where the program has none.  On the card, a
captured ``generate`` leaves no device op named after a program span."""
import json
from types import SimpleNamespace

import pytest

from _bench_small import ROOT, TRAFFIC, context

from bench import cell as cell_mod
from bench import trace as trace_mod
from bench.drivers import serve
from bench.drivers.serve import ServeRun

# the readers this file covers; all but ``decode_launch_ms_per_step`` are
# listed in ``BENCHMARK.json``
NEW = ["decode_launch_ms_per_step", "decode_read_ms_per_step",
       "decode_syncs_per_step", "warmup_s"]
PROGRAM = ("serve.", "graph.")
LISTED = NEW[1:]
CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]

# test_bench_harness.test_trace_reduction's events
DEV = [("k1", 1.0, 2.0), ("k2", 1.5, 3.2), ("k3", 5.0, 6.0),
       ("k1", 6.0, 6.5), ("outside", 20.0, 21.0)]
HOST = [(trace_mod.UNIT, 0.5, 8.0), ("bench.decode", 3.0, 5.5),
        ("aten::item", 3.5, 4.9), ("cudaGraphLaunch", 6.6, 7.9)]
# program spans around them, each starting before the host ops it holds
SPANS = [("serve.generate", 0.6, 7.95), ("serve.decode", 2.9, 5.6),
         ("serve.read", 3.4, 5.0), ("graph.step", 6.55, 7.95)]


def _events(rows, device):
    from torch.autograd import DeviceType
    kind = DeviceType.CUDA if device else DeviceType.CPU
    return [SimpleNamespace(name=n, device_type=kind,
                            time_range=SimpleNamespace(start=s * 1e6,
                                                       end=e * 1e6))
            for n, s, e in rows]


def _profile(device, host):
    """``Profile.reduce`` over these events, as the profiler hands them."""
    p = trace_mod.Profile()
    evs = _events(device, True) + _events(host, False)
    p._prof = SimpleNamespace(events=lambda: evs)
    return p.reduce()


def _same(got, want):
    """Rows of a name and numbers, the names equal, the numbers within
    the profiler's microsecond round trip."""
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [x for r in got for x in r[1:]] == pytest.approx(
        [x for r in want for x in r[1:]], abs=1e-9)


def test_program_spans_leave_busy_time_gaps_and_breakdown_as_they_were():
    plain = trace_mod.reduce(DEV, HOST)
    spanned = _profile(DEV, HOST + SPANS)
    assert spanned.busy_s == pytest.approx(plain.busy_s)
    assert spanned.window == pytest.approx(plain.window)
    _same(spanned.device_ops, plain.device_ops)
    assert [d for _, d in spanned.gaps] == pytest.approx(
        [d for _, d in plain.gaps])
    # a gap keeps its host op's name; one under none now names its span
    renamed = [(a, b) for (a, _), (b, _) in zip(plain.gaps, spanned.gaps)
               if a != b]
    assert renamed and all(a == "(no host op)" and b.startswith(PROGRAM)
                           for a, b in renamed)
    _same(spanned.breakdown()["device_ops"], plain.breakdown()["device_ops"])
    idle = lambda t: 1.0 - t.busy_s / t.window_s           # noqa: E731
    assert idle(spanned) == pytest.approx(idle(plain))


class _SpanProfile:
    """Stands in for ``trace.Profile`` on the CPU: the profiler's host
    events, the engine's spans among them, and a device op over the first
    half of each ``graph.step`` span."""

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU])
        self._prof.start()
        self._span = torch.autograd.profiler.record_function(trace_mod.UNIT)
        self._span.__enter__()

    def stop(self):
        self._span.__exit__(None, None, None)
        self._prof.stop()

    def reduce(self):
        host = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in self._prof.events()]
        device = [("k", s, (s + e) / 2) for n, s, e in host
                  if n == "graph.step"]
        return trace_mod.reduce(device, host)


@pytest.fixture(scope="module")
def traced_run():
    mp = pytest.MonkeyPatch()
    mp.setattr(trace_mod, "Profile", _SpanProfile)
    mp.setattr(trace_mod, "warm", lambda: None)
    try:
        yield serve.run(context("granite-3-2b", 2**33 + 9, 0.5, trace=True))
    finally:
        mp.undo()


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_gives_a_value_on_a_small_cell(traced_run, name):
    v = cell_mod.module("metrics", name).read(traced_run)
    assert v is not None and v >= 0
    if name == "decode_syncs_per_step":
        assert v == 3.0
    if name == "warmup_s":
        assert v == 0.0                  # the CPU warms nothing up


def test_listed_readers_are_in_the_result_line(traced_run):
    from bench import run as run_mod
    assert traced_run.correct, traced_run.checks
    cell = cell_mod.load(CELL["name"], ROOT)
    _, line = run_mod.report(cell, traced_run, True, "cpu")
    m = {k: v["value"] for k, v in json.loads(line)["metrics"].items()}
    assert set(LISTED) | {"device_idle_pct"} <= set(m)
    assert "decode_launch_ms_per_step" not in m
    steps = traced_run.engine_delta("decode_steps")
    assert steps == len(traced_run.batches) * (TRAFFIC["new_tokens"] - 1)
    assert m["decode_read_ms_per_step"] == pytest.approx(
        traced_run.engine_delta("decode_read_s") / steps * 1e3)


def test_new_readers_find_nothing_without_the_program_spans_and_counters():
    """A program without the spans and counters (the engine's older
    timings, a trace of device ops alone) gives no value, and no error."""
    timings = dict(prefill_s=1.0, prefills=3, decode_s=2.0, decode_steps=15,
                   captures=0, capture_s=0.0, warmup_prefills=0,
                   pool_bytes=0)
    run = ServeRun("x", {}, 1.0, engine_before={**timings, "decode_steps": 0},
                   engine_after=timings)
    run.trace = trace_mod.reduce(DEV, HOST)
    for name in NEW:
        assert cell_mod.module("metrics", name).read(run) is None, name


@pytest.mark.cuda
def test_profile_reduce_leaves_out_the_program_spans_on_the_card():
    """On the card, a captured ``generate`` under ``trace.Profile``: the
    profile holds both kinds of span as host ops, and no device op of the
    reduction is named after one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from torch.autograd import DeviceType
    from bench import weights
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    dev = torch.device("cuda")
    params = weights.draw(model.template(), 2**33 + 5, dev)
    eng = ServeEngine(model, params, max_seq=64, batch_slots=4, device=dev)
    prompts = torch.randint(2, cfg.vocab, (4, 24),
                            generator=torch.Generator().manual_seed(0))
    eng.generate(prompts.numpy(), 4)            # the captures
    p = trace_mod.Profile()
    p.start()
    eng.generate(prompts.numpy(), 4)
    p.stop()
    t = p.reduce()
    events = p._prof.events()
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    assert {"serve.generate", "serve.decode", "graph.step"} <= host
    assert not any(e.name.startswith(PROGRAM) for e in events
                   if e.device_type == DeviceType.CUDA)
    assert not any(n.startswith(PROGRAM) for n, _, _ in t.device_ops)
    assert t.device_ops and 0 < t.busy_s < t.window_s
