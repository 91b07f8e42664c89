"""The serve engine's and the captured steps' spans and counters on the CPU
(``repro_torch._trace``): reduced granite-3-2b and zamba2-1.2b serve 6
new tokens under ``torch.profiler`` (host activity), which records one
``serve.generate``, ``serve.upload`` and ``serve.prefill`` and a
``serve.decode`` a step, each holding one ``graph.step``, one
``serve.sample`` and three ``serve.read``; the decode counters read 3
reads a step and seconds above 0; the CPU captures nothing and warms
nothing up; the tokens are the same bits with the profiler and without;
the spans are host ops, not user annotations (which would leave marks on
the device's timeline), and ``serve.generate`` carries the call's number,
rows and prompt length; and with no profiler running no span is entered.
The card's form (captures, graph launches) is in
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import _trace
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine

SLOTS, P, NEW = 3, 11, 6
FAMILIES = ["granite-3-2b", "zamba2-1.2b"]


def _engine(name):
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    g = torch.Generator().manual_seed(1)
    params["lm_head"] = (torch.randn(cfg.d_model, cfg.vocab, generator=g)
                         * 0.05).to(params["lm_head"].dtype)
    eng = ServeEngine(model, params, max_seq=P + NEW + 4, batch_slots=SLOTS,
                      device="cpu")
    prompts = np.random.default_rng(3).integers(2, cfg.vocab, (SLOTS, P))
    return eng, prompts


def _profiled(eng, prompts):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = eng.generate(prompts, NEW)
    return [r.tokens for r in out], prof.events()


def _within(ev, name):
    """The events named ``name`` below ``ev`` (its children, theirs...)."""
    out = []
    for c in ev.cpu_children:
        out += [c] if c.name == name else []
        out += _within(c, name)
    return out


def _parent(ev, name):
    p = ev.cpu_parent
    while p is not None and p.name != name:
        p = p.cpu_parent
    return p


@pytest.fixture(scope="module", params=FAMILIES)
def traced(request):
    """(engine, prompts, tokens unprofiled, tokens profiled, events, the
    timings before the profiled call), one engine a family."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng, prompts = _engine(request.param)
        plain = [r.tokens for r in eng.generate(prompts, NEW)]
        before = dict(eng.timings)
        tokens, events = _profiled(eng, prompts)
    finally:
        torch.set_num_threads(threads)
    return eng, prompts, plain, tokens, events, before


def test_one_span_a_call_and_a_decode_span_a_step(traced):
    *_, events, _ = traced
    names = [e.name for e in events]
    for name in (_trace.GENERATE, _trace.UPLOAD, _trace.PREFILL):
        assert names.count(name) == 1, name
    assert names.count(_trace.DECODE) == NEW - 1
    (gen,) = [e for e in events if e.name == _trace.GENERATE]
    assert len(_within(gen, _trace.DECODE)) == NEW - 1
    (up,) = [e for e in events if e.name == _trace.UPLOAD]
    assert _parent(up, _trace.GENERATE) is gen


def test_each_decode_span_holds_a_step_a_sample_and_three_reads(traced):
    *_, events, _ = traced
    for d in (e for e in events if e.name == _trace.DECODE):
        assert len(_within(d, _trace.GRAPH_STEP)) == 1
        assert len(_within(d, _trace.SAMPLE)) == 1
        assert len(_within(d, _trace.READ)) == 3
    (pre,) = [e for e in events if e.name == _trace.PREFILL]
    for name in (_trace.GRAPH_STEP, _trace.SAMPLE, _trace.READ):
        assert len(_within(pre, name)) == 1, name


def test_decode_counters(traced):
    eng, *_, before = traced
    t = eng.timings
    assert t["decode_syncs"] - before["decode_syncs"] == 3 * (NEW - 1)
    assert t["decode_steps"] - before["decode_steps"] == NEW - 1
    for k in ("decode_launch_s", "decode_read_s"):
        assert t[k] > before[k] > 0, k
    assert t["decode_launch_s"] == eng._decode.run_s


def test_no_capture_and_no_warmup_on_the_cpu(traced):
    eng, *_, events, _ = traced
    assert _trace.GRAPH_CAPTURE not in {e.name for e in events}
    assert eng.timings["warmup_s"] == 0.0
    assert eng._prefill.warmup_s == eng._decode.warmup_s == 0.0


def test_tokens_are_the_same_bits_with_the_profiler(traced):
    _, prompts, plain, tokens, _, _ = traced
    assert tokens == plain
    assert all(len(t) == NEW for t in tokens)


def test_spans_are_host_ops_and_no_user_annotations(traced):
    """A user annotation (``record_function``'s kind) leaves a mark on the
    device's timeline that a reading of the device's busy time would
    count; the program's spans are plain host ops."""
    *_, events, _ = traced
    spans = [e for e in events if e.name.startswith(("serve.", "graph."))]
    assert spans
    assert not any(e.is_user_annotation for e in spans)


def test_generate_span_carries_the_call():
    eng, prompts = _engine("granite-3-2b")
    eng.generate(prompts, 2)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        eng.generate(prompts, 2)
    (gen,) = [e for e in prof.events() if e.name == _trace.GENERATE]
    assert gen.kwinputs == dict(call=2, rows=SLOTS, prompt_len=P)


def test_span_enters_nothing_without_a_profiler(monkeypatch):
    """With no profile running, ``span`` hands back one shared no-op and
    ``generate`` enters no span of the profiler's."""
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("a profiler span entered")
    monkeypatch.setattr(_trace, "_RecordFunctionFast", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    assert _trace.span(_trace.GENERATE) is _trace.span(
        _trace.READ, dict(call=1))
    eng, prompts = _engine("granite-3-2b")
    out = eng.generate(prompts, 3)
    assert [len(r.tokens) for r in out] == [3] * SLOTS
    assert eng.timings["decode_syncs"] == 6
