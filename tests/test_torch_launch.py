"""The port's roofline and dry-run layer vs the JAX reference, on the CPU:
``launch/{mesh,roofline,step_cost,settings,dryrun}.py``,
``EnergyModel.for_workload`` / ``workload_roofline``, ``Rules``.

The reference's ``repro.launch.{roofline,hlo_cost,settings}`` import no
``repro.core`` and load directly; its energy model comes through
``load_reference``."""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import ROOT, load_reference, reference_imports

from repro import configs as rconfigs
from repro.launch import hlo_cost as rhlo
from repro.launch import roofline as rroof
from repro.launch import settings as rsettings
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import energy
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, mesh, roofline, settings
from repro_torch.launch.step_cost import StepCounter, count_step
from repro_torch.models.model import ModelFlags, build_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread each, so the test workers running
    beside this file do not wait on each other's thread barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# roofline.py, mesh.py
# ---------------------------------------------------------------------------

# the shape strings of tests/test_hlo_cost.py and a few more
SHAPES = ["bf16[4,8]{1,0}", "(f32[2,2]{1,0}, s8[16]{0})", "f32[]",
          "(bf16[16,4096]{1,0}, bf16[16,4096]{1,0})", "token[]",
          "f8e4m3fn[3,5]", "pred[7]", "c64[2,2]"]

HLO = """
ENTRY %main (p0: bf16[256,512]) -> bf16[256,512] {
  %p0 = bf16[256,512]{1,0} parameter(0)
  %ag = bf16[1024,512]{1,0} all-gather(bf16[256,512]{1,0} %p0), dimensions={0}
  %ars = (f32[64,64]{1,0}, f32[64,64]{1,0}) all-reduce-start(f32[64,64]{1,0} %x), to_apply=%add
  %ard = f32[64,64]{1,0} all-reduce-done((f32[64,64]{1,0}, f32[64,64]{1,0}) %ars)
  %rs = f32[16,64]{1,0} reduce-scatter(f32[64,64]{1,0} %ard), dimensions={0}
  %a2a = bf16[8,128]{1,0} all-to-all(bf16[8,128]{1,0} %y), dimensions={0}
  %cps = bf16[32]{0} collective-permute-start(bf16[32]{0} %z), source_target_pairs={{0,1}}
  %cpd = bf16[32]{0} collective-permute-done(bf16[32]{0} %cps)
  ROOT %r = bf16[256,512]{1,0} copy(%p0)
}
"""


@pytest.mark.parametrize("shape", SHAPES)
def test_shape_bytes_match_reference(shape):
    assert roofline._shape_bytes(shape) == rroof._shape_bytes(shape)


def test_collective_bytes_match_reference():
    got = roofline.collective_bytes(HLO)
    want = rroof.collective_bytes(HLO)
    assert got == want
    # -start counted once (an all-reduce 2x), -done skipped
    assert got[1]["all-reduce"] == 2 * 2 * 64 * 64 * 4
    assert got[1]["collective-permute"] == 64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roofline_terms_bitwise_at_tpu_v5e(seed):
    rng = np.random.default_rng(seed)
    f, b, c = (float(x) for x in rng.random(3) * [1e15, 1e12, 1e9])
    kw = dict(flops_per_device=f, bytes_per_device=b,
              collective_bytes_per_device=c, per_kind={"all-reduce": c},
              chips=int(rng.integers(1, 512)))
    got = roofline.Roofline(**kw).as_dict(1e15)
    want = rroof.Roofline(**kw).as_dict(1e15)
    assert {k: got[k] for k in want} == want
    assert got["hw"] == "tpu-v5e"


def test_hardware_rows():
    v5e = mesh.HARDWARE["tpu-v5e"]
    assert (v5e.peak_flops_bf16, v5e.hbm_bw, v5e.link_bw) == (
        rroof.PEAK_FLOPS_BF16, rroof.HBM_BW, rroof.ICI_BW)
    assert mesh.CHIPS_PER_POD == 256
    assert mesh.hardware_for("NVIDIA H100 80GB HBM3") == "h100-sxm"
    assert mesh.hardware_for("NVIDIA H100 NVL") == "h100-nvl"
    assert mesh.hardware_for("NVIDIA H100 PCIe") == "h100-pcie"
    assert mesh.hardware_for("NVIDIA A100-SXM4-80GB") is None
    r = roofline.Roofline(989e12, 3.35e12, 0.0, {}, 1, hw="h100-sxm")
    assert (r.compute_s, r.memory_s, r.dominant) == (1.0, 1.0, "compute")


# ---------------------------------------------------------------------------
# core/energy.py: workload_roofline, for_workload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_workload_roofline_and_for_workload_bitwise(arch):
    ref = load_reference()
    with reference_imports():
        for s in configs.SHAPES:
            a, ra = configs.ARCHS[arch], rconfigs.ARCHS[arch]
            sh, rsh = configs.SHAPES[s], rconfigs.SHAPES[s]
            for chips, floor in ((8, 0.3), (4, 0.1), (256, 0.5)):
                got = energy.workload_roofline(a, sh, chips=chips)
                want = ref.energy.workload_roofline(ra, rsh, chips=chips)
                gd, wd = got.as_dict(1e12), want.as_dict(1e12)
                assert {k: gd[k] for k in wd} == wd, (s, chips)
                em = energy.EnergyModel(idle_frac=0.2)
                rem = ref.energy.EnergyModel(idle_frac=0.2)
                g = em.for_workload(a, sh, chips=chips, floor=floor)
                w = rem.for_workload(ra, rsh, chips=chips, floor=floor)
                assert g.chip_power_w == w.chip_power_w, (s, chips, floor)
                assert (g.idle_frac, g.dyn_frac, g.host_power_w) == (
                    w.idle_frac, w.dyn_frac, w.host_power_w)


def test_bench_energy_calibration_reproduced():
    """``BENCH_energy.json``'s ``configs[0].calibration_chip_w`` (the
    reference's energy bench), cell by cell after rounding to 0.01."""
    rec = json.loads((ROOT / "BENCH_energy.json").read_text())
    cal = rec["configs"][0]["calibration_chip_w"]
    assert len(cal) == 20
    for key, want in cal.items():
        arch, shape = key.split("/")
        got = energy.DEFAULT_ENERGY.for_workload(configs.ARCHS[arch],
                                                 configs.SHAPES[shape])
        assert round(got.chip_power_w, 2) == want, key


def test_workload_calibration_spans_configs():
    """The reference's ``tests/test_energy.py`` case: roofline-calibrated
    chip power stays inside [floor, 1] x nameplate, and a compute-bound
    train step draws more than a bandwidth-bound decode step."""
    em = energy.EnergyModel()
    for arch in configs.ARCHS.values():
        for shape in configs.SHAPES.values():
            cal = em.for_workload(arch, shape)
            assert 0.3 * em.chip_power_w <= cal.chip_power_w \
                <= em.chip_power_w
    train = em.for_workload(configs.ARCHS["falcon-mamba-7b"],
                            configs.SHAPES["train_4k"])
    decode = em.for_workload(configs.ARCHS["falcon-mamba-7b"],
                             configs.SHAPES["decode_32k"])
    assert train.chip_power_w > decode.chip_power_w


def test_for_workload_on_the_h100_row():
    """``hw=`` moves only the roofline: on the H100 row each cell's chip
    watts follow that row's compute share."""
    em = energy.DEFAULT_ENERGY
    for arch in configs.ARCHS.values():
        for shape in configs.SHAPES.values():
            h = em.for_workload(arch, shape, hw="h100-sxm")
            r = energy.workload_roofline(arch, shape, hw="h100-sxm")
            util = min(1.0, r.compute_s / r.step_s)
            assert h.chip_power_w == em.chip_power_w * (0.3 + 0.7 * util)
            assert r.hw == "h100-sxm"


# ---------------------------------------------------------------------------
# step_cost.py vs hlo_cost on the shared small graphs
# ---------------------------------------------------------------------------


def _hlo_dot_flops(text: str) -> float:
    """hlo_cost's dot FLOPs alone: ``HloCost.comp_flops`` without the
    vector-op floor (dots in fusions, while bodies x trip count)."""
    h = rhlo.HloCost(text)

    def walk(name):
        comp = h.comps.get(name)
        total = 0.0
        for op in (comp.ops if comp else ()):
            inner = sum(walk(c) for c in rhlo._called_comps(op))
            if op.opcode == "dot":
                total += h._dot_flops(comp, op)
            elif op.opcode == "while":
                total += h._trip_count(op) * inner
            else:
                total += inner
        return total

    return walk(h.entry)


def _emitted_hlo(f, *sds, trips=None) -> str:
    """The HLO JAX emits for ``f``, before the CPU compiler's passes, in
    the text form hlo_cost parses: the byte reference.  The compiled CPU
    text is not one: the CPU compiler wraps every bf16 dot in bf16 <-> f32
    convert fusions and every elementwise op in a fusion of its own, which
    hlo_cost bills 2 x result each (15.2 MB on the two-layer graph, which
    moves 3.9 MB at bf16), work a TPU's compiler does not add.  The
    emitted text carries no trip count, so the annotation the compiler
    would add to the while op (``known_trip_count``, which hlo_cost reads
    first) is added here: ``trips``."""
    text = jax.jit(f).lower(*sds).compiler_ir("hlo").as_hlo_module() \
        .to_string()
    if trips is not None:
        text, n = re.subn(
            r"^(.* while\(.*)$",
            lambda m: m.group(1) + ', backend_config={"known_trip_count":'
            '{"n":"%d"}}' % trips, text, flags=re.M)
        assert n == 1
    return text


def _hlo_result_bytes(text: str, opcode: str) -> int:
    """The result bytes of every ``opcode`` op of an HLO text."""
    total = 0
    for line in text.splitlines():
        m = rhlo._OP_LINE.match(line)
        if m and m.group(3) == opcode:
            total += rhlo._shape_elems_bytes(m.group(2))[1]
    return total


def _two_layer(mod):
    return lambda x, w1, w2: mod.tanh(x @ w1) @ w2


def test_counter_dots_match_hlo_cost_loop_free():
    """FLOPs and bytes of ``tanh(x @ w1) @ w2`` against hlo_cost.  Bytes:
    each dot 2 x its result, the tanh fused (0), in both.  The one gap is
    the arguments: hlo_cost's ``source_bytes`` bills an operand only where
    no op of its computation defines it or a get-tuple-element does (a
    loop-carried value), and a ``parameter`` is an op, so an argument read
    outside a loop bills nothing there; the counter bills each argument
    once, at first use, the rule of hlo_cost's docstring
    (``hlo_cost.py:17-19``)."""
    shapes = ((256, 512), (512, 1024), (1024, 512))
    sds = [jax.ShapeDtypeStruct(s, jnp.bfloat16) for s in shapes]
    text = jax.jit(_two_layer(jnp)).lower(*sds).compile().as_text()
    want = rhlo.analyze(text)
    ts = [torch.empty(s, dtype=torch.bfloat16, device="meta")
          for s in shapes]
    with StepCounter(ts) as c:
        _two_layer(torch)(*ts)
    assert c.by_op["mm"][1] == _hlo_dot_flops(text) \
        == 2 * 256 * 512 * 1024 + 2 * 256 * 1024 * 512
    # totals: the CPU compiler's HLO adds bf16 <-> f32 converts around the
    # dots (|result| each), which a bf16 torch matmul does not have
    assert abs(c.cost.flops - want.flops) / want.flops < 0.02
    emitted = rhlo.analyze(_emitted_hlo(_two_layer(jnp), *sds))
    assert c.cost.flops == emitted.flops
    args = sum(t.numel() * 2 for t in ts)
    assert emitted.bytes == 2 * (256 * 1024 + 256 * 512) * 2
    assert c.cost.bytes == emitted.bytes + args


def _scan_graphs(stack: bool):
    """``h = tanh(h @ ws[i])`` over 12 layers, as a ``lax.scan`` and as
    the torch loop; with ``stack`` each layer's input is also written
    into a (12, 256, 512) stack (a dynamic-update-slice, ``copy_`` of a
    row in torch).  Returns (emitted HLO, compiled HLO, counter)."""
    def f(x, ws):
        def body(h, w):
            return jnp.tanh(h @ w), (h if stack else None)
        return jax.lax.scan(body, x, ws)

    sds = (jax.ShapeDtypeStruct((256, 512), jnp.bfloat16),
           jax.ShapeDtypeStruct((12, 512, 512), jnp.bfloat16))
    x = torch.empty(256, 512, dtype=torch.bfloat16, device="meta")
    ws = torch.empty(12, 512, 512, dtype=torch.bfloat16, device="meta")
    with StepCounter(x, ws) as c:
        h = x
        ys = torch.empty(12, 256, 512, dtype=torch.bfloat16, device="meta")
        for i in range(12):
            h_next = torch.tanh(h @ ws[i])
            if stack:
                ys[i].copy_(h)
            h = h_next
    return (_emitted_hlo(f, *sds, trips=12),
            jax.jit(f).lower(*sds).compile().as_text(), c)


# bytes of the scanned graphs: the carry h, one layer's weights w, the
# stack of carries
_H, _W, _YS = 256 * 512 * 2, 512 * 512 * 2, 12 * 256 * 512 * 2


def test_counter_dots_match_hlo_cost_scanned_loop():
    """Bytes, per trip: each dot 2 x |h| in both, and the layer's weights
    read once.  The gaps, each billed by hlo_cost on every trip: its
    dynamic-slice of the stacked weights materializes (2 x |w|) where the
    torch slice ``ws[i]`` is a view; and it reads the loop counter as a
    loop-carried value, 4 B in the body's add and 1 B in the condition's
    compare (clamped to its pred result).  The counter bills the argument
    x once (see the loop-free test)."""
    emitted, text, c = _scan_graphs(stack=False)
    want = rhlo.analyze(text)
    assert c.by_op["mm"][1] == _hlo_dot_flops(text) \
        == 12 * 2 * 256 * 512 * 512
    assert abs(c.cost.flops - want.flops) / want.flops < 0.02
    # each layer's weights billed once, at first use: the whole stack
    assert c.by_op["mm"][2] == 12 * 512 * 512 * 2 + 256 * 512 * 2 \
        + 12 * 2 * 256 * 512 * 2
    got = rhlo.analyze(emitted).bytes
    assert got == 12 * (2 * _H + _W + 2 * _W + 4 + 1)
    assert c.cost.bytes == got - 12 * (2 * _W + 4 + 1) + _H


def test_counter_bytes_match_hlo_cost_scan_with_update():
    """The scan with a stack of its carries: the dynamic-update-slice
    bills 2 x its update in both (hlo_cost's in-place rule; the counter's
    ``copy_``), beside the gaps of the plain scan.  Two more, each trip:
    hlo_cost reads the whole stack as a loop-carried operand of the
    update (clamped to the update's result, which is the stack) and the
    update's operand as one (a get-tuple-element of the body's call), and
    bills the update's three s32 start indices 2 x 4 B each, which the
    torch loop holds as Python ints."""
    emitted, _, c = _scan_graphs(stack=True)
    got = rhlo.analyze(emitted).bytes
    assert got == 12 * (2 * _H + 3 * _W + 4 + 1 + _YS + _H + 2 * (_H + 12))
    assert c.cost.bytes == got - 12 * (2 * _W + 4 + 1 + _YS + _H + 24) + _H
    assert c.by_op["copy_"][2] == 12 * 2 * _H


def test_counter_bytes_match_hlo_cost_scan_pass_gradient():
    """One doubling pass of the chunked selective scan
    (``models.ssm._scan_chunk``) and its gradient: the graph whose bytes
    rule the dry run's SSM training cells.  Each slice's gradient is a
    pad in JAX, a ``slice_backward`` in torch: a zero tensor of the
    sliced operand's size, billed 2 x that size by both, as many of them
    on each side.  The gaps: hlo_cost bills each forward slice 2 x its
    result (a ``slice`` materializes there; a torch slice is a view); the
    gradient JAX emits has neither the two forward concatenates (2 x
    their result each, the counter's ``cat``) nor the loss's sum (2 x
    4 B); and the arguments (see the loop-free test)."""
    B, Q, M, N, d = 2, 16, 8, 4, 4

    def step(mod, cat):
        def f(la, lb):
            a, b = mod.exp(la), mod.tanh(lb)
            nb = cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
            na = cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
            return (na * nb).sum()
        return f

    sds = [jax.ShapeDtypeStruct((B, Q, M, N), jnp.float32)] * 2
    emitted = _emitted_hlo(jax.grad(step(jnp, jnp.concatenate), (0, 1)),
                           *sds)
    want = rhlo.analyze(emitted)
    la, lb = (torch.zeros(B, Q, M, N, requires_grad=True) for _ in "ab")
    with StepCounter(la, lb) as c:
        torch.autograd.grad(step(torch, torch.cat)(la, lb), (la, lb))
    full = B * Q * M * N * 4
    pads = _hlo_result_bytes(emitted, "pad")
    assert pads == c.by_op["slice_backward"][0] * full
    assert c.by_op["slice_backward"][2] == 2 * pads
    slices = _hlo_result_bytes(emitted, "slice")
    assert c.cost.bytes == (want.bytes - 2 * slices + 2 * 2 * full
                            + 2 * full + 2 * 4)


def test_counter_byte_rules():
    """Arguments billed once, at first use; same-shape elementwise ops
    free; a materializing op 2 x its result; an in-place copy 2 x the
    update (and its destination, an argument, read once); a gather the
    rows it fetches.  FLOPs: 2 x M x N x K a matmul, |result| any other
    op that computes, 0 a view or a copy into place."""
    w = torch.ones(64, 32)
    table = torch.ones(1000, 32)
    cache = torch.zeros(8, 32)
    x = torch.ones(4, 64)
    ids = torch.tensor([1, 2, 3, 4])

    def step():
        h = x @ w
        h = torch.relu(h) * 2.0
        h = h + (x @ w)
        e = table[ids]
        cache[:4].copy_(h + e)
        return h.sum()

    _, cost = count_step(step, w, table, cache, x, ids)
    row = 4 * 32 * 4                     # one (4, 32) f32 result
    assert cost.bytes == (
        (4 * 64 * 4 + 64 * 32 * 4 + 2 * row)     # x @ w: x, w, result
        + 2 * row                                 # x @ w again: result
        + (row + 4 * 8 + 2 * row)                 # table[ids]: rows, ids
        + (row + 2 * row)                         # copy_: cache[:4], update
        + 2 * 4)                                  # sum
    assert cost.flops == (2 * 2 * 4 * 64 * 32    # the two matmuls
                          + 4 * 128               # relu, mul, add, add
                          + 128                   # the gather
                          + 1)                    # the sum


def test_counter_bills_bmm_with_out_dtype_as_bmm():
    """``bmm``'s ``out_dtype`` form (decode's scores: bf16 operands, f32
    result), on meta: the matmul's FLOPs and, as a materializing op, 2 x
    its result, with the argument it reads billed once."""
    a = torch.empty(3, 4, 5, dtype=torch.bfloat16, device="meta")
    b = torch.empty(3, 5, 6, dtype=torch.bfloat16, device="meta")
    out, cost = count_step(
        lambda: torch.bmm(a, b, out_dtype=torch.float32), b)
    assert out.dtype == torch.float32
    assert cost.flops == 2 * 3 * 4 * 6 * 5
    assert cost.bytes == 3 * 5 * 6 * 2 + 2 * (3 * 4 * 6 * 4)


# ---------------------------------------------------------------------------
# dryrun.py, settings.py, sharding.Rules
# ---------------------------------------------------------------------------

FAMILIES = ("granite-3-2b", "falcon-mamba-7b", "moonshot-v1-16b-a3b",
            "zamba2-1.2b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_dry_run_kernel_route_vs_plain_route(arch):
    """Prefill on meta through the kernels' custom ops (their formulas)
    and through the plain routes (their aten ops): the FLOPs agree within
    15 %.  They differ by design: the plain attention multiplies every
    (row, key) pair and masks, where K5 counts only the live causal pairs
    (about half), and the plain scan's per-step ops count |result| each
    where K6 counts 5 FLOPs per state update."""
    cfg = configs.get_config(arch).reduced()
    shape = ShapeSpec("small", "prefill", 64, 2)
    flops = {}
    for uk in (True, False):
        model = build_model(cfg, ModelFlags(use_kernel=uk))
        _, out, c = dryrun.count_cell(cfg, shape, model)
        assert out[0].shape == (2, cfg.vocab) and out[0].device.type == "meta"
        flops[uk] = c.cost.flops
        kern = [k for k in ("flash_attention", "selective_scan")
                if k in c.by_op]
        assert bool(kern) == uk, c.by_op.keys()
    assert abs(flops[True] / flops[False] - 1) < 0.15, flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dry_run_count_on_meta_equals_count_on_the_cpu(kind):
    """The counter sees the same ops on real tensors and on meta: a
    reduced granite step counted on the CPU equals its meta count."""
    cfg = configs.get_config("granite-3-2b").reduced()
    shape = ShapeSpec("small", kind, 32, 2)
    model = build_model(cfg, ModelFlags(attn_chunk=16))
    _, _, meta = dryrun.count_cell(cfg, shape, model)
    specs = dryrun.input_specs(cfg, shape, model)
    real = sharding.tree_map(
        lambda t: (torch.zeros(t.shape, dtype=t.dtype) if t.is_floating_point()
                   else torch.ones(t.shape, dtype=t.dtype)), specs)
    fn = dryrun.step_fn(cfg, shape, model, real)
    _, cost = count_step(fn, real)
    assert (cost.flops, cost.bytes) == (meta.cost.flops, meta.cost.bytes)


def test_run_cell_result_and_skips():
    r = dryrun.run_cell("zamba2-1.2b", "long_500k")
    cfg = configs.get_config("zamba2-1.2b")
    assert r["status"] == "ok" and r["chips"] == 1 and r["hw"] == "h100-sxm"
    roof = r["roofline"]
    assert roof["model_flops_global"] == 2.0 * cfg.active_param_count()
    assert roof["dominant"] == "memory" and roof["flops_per_device"] > 0
    top = r["top_ops_by_bytes"]
    assert len(top) == 5 and sum(v["bytes"] for v in top.values()) \
        <= roof["bytes_per_device"]
    mem = r["memory"]
    assert mem["temp_bytes_per_device"] is None
    # the caches are updated in place: every output byte but the logits
    # aliases an argument
    assert mem["output_bytes_per_device"] - mem["alias_bytes_per_device"] \
        == 4 * cfg.vocab
    for arch, cfg in configs.ARCHS.items():
        if not cfg.supports_shape(configs.SHAPES["long_500k"]):
            s = dryrun.run_cell(arch, "long_500k")
            assert s["status"] == "skipped" and "500k" in s["reason"]
    # the (2, 16, 16) mesh in this process, over a fake world it ends
    m = dryrun.run_cell("granite-3-2b", "decode_32k", chips=512)
    assert (m["status"], m["chips"], m["multi_pod"]) == ("ok", 512, True)
    assert m["roofline"]["collective_bytes_per_device"] > 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="chips"):
        dryrun.run_cell("granite-3-2b", "train_4k", chips=8)


def test_dry_run_cli_refuses_multi_pod(tmp_path):
    """``--multi-pod`` (``--chips 512``) runs the cell on the (2, 16, 16)
    mesh and writes its result."""
    path = tmp_path / "cell.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-2b", "--shape", "decode_32k", "--multi-pod", "--out",
         str(path)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    r = json.loads(path.read_text())
    assert (r["status"], r["chips"], r["multi_pod"]) == ("ok", 512, True)
    assert r["roofline"]["collective_bytes_per_device"] > 0
    assert "multipod" in out.stdout


def test_written_results_count_only_for_their_own_mesh(tmp_path,
                                                       monkeypatch):
    """A result file under a mesh's name counts as that mesh's only when
    its ``chips`` are the mesh's: a one-card result left under
    ``__pod__`` is run again by ``--all --meshes pod`` and is not printed
    as a pod number by ``--table --chips 256``."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    path = dryrun._result_path("granite-3-2b", "train_4k", "baseline", 256)
    assert path.name == "granite-3-2b__train_4k__pod__baseline.json"
    path.write_text(json.dumps({"status": "ok", "chips": 1}))
    assert dryrun._written(path, 256) is None
    assert dryrun._written(path, 1) == {"status": "ok", "chips": 1}
    row = next(r for r in dryrun.table("baseline", 256).splitlines()
               if r.startswith("| granite-3-2b |"))
    assert "other mesh" in row and " s, " not in row
    path.write_text(json.dumps({"status": "skipped", "chips": 256}))
    row = next(r for r in dryrun.table("baseline", 256).splitlines()
               if r.startswith("| granite-3-2b |"))
    assert "skipped" in row


def test_model_flops_and_batch_template_match_reference():
    """``repro.launch.dryrun.model_flops``'s formulas (that module sets
    ``XLA_FLAGS`` for the whole process when imported, so its formulas are
    written out here) on the reference's parameter counts."""
    for arch in configs.ARCHS:
        for s in configs.SHAPES:
            cfg, shape = configs.ARCHS[arch], configs.SHAPES[s]
            n = rconfigs.ARCHS[arch].active_param_count()
            want = {"train": 6.0 * n * shape.tokens,
                    "prefill": 2.0 * n * shape.tokens,
                    "decode": 2.0 * n * shape.global_batch}[shape.kind]
            assert dryrun.model_flops(cfg, shape) == want
            t = dryrun.batch_template(cfg, shape)
            assert all(p.shape[0] == shape.global_batch for p in t.values())


def _settings_fields(st, ref_st):
    flags = {f.name: getattr(st.flags, f.name)
             for f in dataclasses.fields(ref_st.flags)}
    want = {f.name: getattr(ref_st.flags, f.name)
            for f in dataclasses.fields(ref_st.flags)}
    assert flags == want
    assert st.flags.use_kernel
    for f in ("microbatches", "grad_sync", "constrain_acts"):
        assert getattr(st, f) == getattr(ref_st, f), f
    assert st.rules.table == ref_st.rules.table


def test_cell_settings_match_reference():
    keys = set(rsettings._OVERRIDES)
    assert set(settings._OVERRIDES) == keys
    for arch, shape, mode in keys:
        _settings_fields(
            settings.cell_settings(configs.ARCHS[arch],
                                   configs.SHAPES[shape], mode),
            rsettings.cell_settings(rconfigs.ARCHS[arch],
                                    rconfigs.SHAPES[shape], mode))
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            for mode in ("baseline", "optimized"):
                _settings_fields(
                    settings.cell_settings(configs.ARCHS[arch],
                                           configs.SHAPES[shape], mode),
                    rsettings.cell_settings(rconfigs.ARCHS[arch],
                                            rconfigs.SHAPES[shape], mode))


def test_rules_candidates_match_reference():
    from repro.distributed import sharding as rsharding
    assert sharding.DEFAULT_RULES == rsharding.DEFAULT_RULES
    names = set(sharding.DEFAULT_RULES) | {None, "no_such_axis"}
    for port, ref in ((sharding.Rules(), rsharding.Rules()),
                      (settings._LLAMA_SP_RULES, rsettings._LLAMA_SP_RULES)):
        assert port.table == ref.table
        for name in names:
            assert port.candidates(name) == ref.candidates(name), name
