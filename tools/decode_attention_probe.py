#!/usr/bin/env python3
"""Decode attention and the captured decode step on the card, at the
benchmark's two served shapes: granite-3-2b (B 32, K 8, G 4, hd 64) and
zamba2-1.2b's tied block (B 24, K 32, G 1, hd 64), both through a
3,021-slot bf16 cache (the longest prompt + 13 new + 8).

``attn``: one single-device decode attention call (``models.attention.
_decode_attend``: q block-diagonal over the kv heads, one product on a
view of each cache, heads innermost) against the formula it replaced (an
f32 copy of the K cache and two einsums over permuted copies), the same
products with the slots innermost, and one product per kv head on strided
views, each written out here, and its two products alone:
CUDA-event time (median of 25 calls; the K and V caches are 2-6x the L2),
the bytes allocated during one call, each beside the bound of reading K
and V once at 3.35 TB/s, and the gaps to the replaced formula.

``step [--src DIR]``: the full-depth model of each cell with the
benchmark's weights, served by ``ServeEngine`` (prefill of 750-token
prompts, then the captured decode step): the step's CUDA-event time
(median of 20 replays), its kernels by device time under
``torch.profiler`` (per step), and the tensors of 2^20 elements or more
that one eager decode step allocates, by op.  ``--src`` imports
``repro_torch`` from another tree (a parent commit's ``src``).

Needs one CUDA device; run from the repository's root, e.g.
``python3 tools/decode_attention_probe.py attn``; prints JSON lines."""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CL, HD, HBM, PROMPT = 3021, 64, 3.35e12, 750
SHAPES = {"granite-3-2b": (32, 8, 4), "zamba2-1.2b": (24, 32, 1)}


def _events_ms(fn, n: int) -> list:
    import torch
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def _replaced(q, ck, cv, positions, slot, is_swa):
    """The decode attention this tree replaced, as it was."""
    import torch
    from repro_torch.models import attention as A
    hd, cl = q.shape[-1], ck.shape[1]
    scores = torch.einsum("bkgh,btkh->bkgt", q.float(),
                          ck.float()) * (hd ** -0.5)
    slot_ids = torch.arange(cl, device=q.device)[None, :]
    valid = A._live_slots(slot_ids, positions, slot, cl, is_swa)
    scores = scores.masked_fill(~valid[:, None, None], A.NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgt,btkh->bkgh", w.to(cv.dtype), cv)


def _per_kv_head(q, ck, cv, positions, slot, is_swa):
    """One product per kv head (or per row where the rows are fewer) on
    strided views of the cache, (N, G, hd) x (N, hd, cl): the form first
    tried, where cuBLAS picks small-N kernels."""
    import torch
    from repro_torch.models import attention as A
    B, K, G, hd = q.shape
    cl = ck.shape[1]
    if K <= B:
        parts = [((slice(None), i), q[:, i], ck[:, :, i], cv[:, :, i])
                 for i in range(K)]
    else:
        parts = [((i,), q[i], ck[i].transpose(0, 1), cv[i].transpose(0, 1))
                 for i in range(B)]
    scores = q.new_empty((B, K, G, cl), dtype=torch.float32)
    for ix, qs, ks, _ in parts:
        torch.bmm(qs, ks.transpose(1, 2), out_dtype=torch.float32,
                  out=scores[ix])
    scores = scores * (hd ** -0.5)
    slot_ids = torch.arange(cl, device=q.device)[None, :]
    valid = A._live_slots(slot_ids, positions, slot, cl, is_swa)
    scores = scores.masked_fill(~valid[:, None, None], A.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = cv.new_empty((B, K, G, hd))
    for ix, _, _, vs in parts:
        torch.bmm(w[ix], vs, out=out[ix])
    return out


def _cl_inner(q, ck, cv, positions, slot, is_swa):
    """``_decode_attend`` with the scores and weights laid out (B, H, cl),
    slots innermost: the block-diagonal q times the cache's transpose."""
    import torch
    from repro_torch.models import attention as A
    B, K, G, hd = q.shape
    H, cl = K * G, ck.shape[1]
    qd = q.new_zeros((B, K, G, K, hd))
    qd.diagonal(0, 1, 3).copy_(q.permute(0, 2, 3, 1))
    scores = torch.bmm(qd.view(B, H, K * hd), ck.view(B, cl, K * hd)
                       .transpose(1, 2), out_dtype=torch.float32)
    scores = scores.view(B, K, G, cl) * (hd ** -0.5)
    slot_ids = torch.arange(cl, device=q.device)[None, :]
    valid = A._live_slots(slot_ids, positions, slot, cl, is_swa)
    scores = scores.masked_fill(~valid[:, None, None], A.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.bmm(w.view(B, H, cl), cv.view(B, cl, K * hd))
    return out.view(B, K, G, K, hd).diagonal(0, 1, 3).permute(0, 3, 1, 2)


def _products(q, ck, cv):
    """``_decode_attend``'s two products alone."""
    import torch
    from repro_torch.models import attention as A
    B, K, G, hd = q.shape
    w = A._decode_scores(q, ck).to(cv.dtype)
    return torch.bmm(w.transpose(1, 2), cv.view(B, ck.shape[1], K * hd))


def attn() -> None:
    import torch
    from repro_torch.models import attention as A
    dev = torch.device("cuda")
    for cell, (B, K, G) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(B * K)
        q = torch.randn(B, K, G, HD, generator=g, device=dev).bfloat16()
        ck = torch.randn(B, CL, K, HD, generator=g, device=dev).bfloat16()
        cv = torch.randn(B, CL, K, HD, generator=g, device=dev).bfloat16()
        pos = torch.randint(0, CL, (B,), generator=g, device=dev)
        pos[0], pos[-1] = 0, CL - 1
        cache_bytes = ck.numel() * ck.element_size()
        line = {"cell": cell, "B": B, "K": K, "G": G, "cl": CL,
                "bound_us": 2 * cache_bytes / HBM * 1e6,
                "k_cache_bytes": cache_bytes}
        outs = {}
        forms = (("replaced", _replaced), ("in_place", A._decode_attend),
                 ("cl_inner", _cl_inner), ("per_kv_head", _per_kv_head),
                 ("products", lambda q, ck, cv, *_: _products(q, ck, cv)))
        for name, fn in forms:
            call = lambda: fn(q, ck, cv, pos, pos, False)   # noqa: E731
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            outs[name] = call()
            torch.cuda.synchronize()
            line[f"{name}_alloc_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                           - m0)
            line[f"{name}_us"] = statistics.median(_events_ms(call, 25)) * 1e3
        want = outs["replaced"].float()
        for name in ("in_place", "cl_inner", "per_kv_head"):
            gap = (outs[name].float() - want).abs().max()
            line[f"{name}_gap"] = gap.item()
        line["out_max"] = want.abs().max().item()
        print(json.dumps(line), flush=True)
        del q, ck, cv, outs
        torch.cuda.empty_cache()


def _kernel_table(prof, steps: int) -> list:
    from torch.autograd import DeviceType
    rows, avgs = [], prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA] or [
        e for e in avgs if e.self_device_time_total > 0]
    for e in kernels:
        t = e.self_device_time_total
        rows.append((t / steps / 1e3, e.count / steps, e.key[:110]))
    rows.sort(reverse=True)
    return [{"ms": round(ms, 4), "calls": n, "kernel": k}
            for ms, n, k in rows]


def step() -> None:
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from bench import weights
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    dev = torch.device("cuda")

    class Fresh(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.big = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ins = {t.untyped_storage().data_ptr()
                   for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)}
            for t in tree_flatten(out)[0]:
                if (isinstance(t, torch.Tensor) and t.numel() >= 1 << 20
                        and t.untyped_storage().data_ptr() not in ins):
                    key = f"{func.__name__} {tuple(t.shape)} {t.dtype}"
                    self.big[key] = self.big.get(key, 0) + 1
            return out

    for cell, (B, _, _) in SHAPES.items():
        model = build_model(get_config(cell))
        params = weights.draw(model.template(), 1234, dev)
        engine = ServeEngine(model, params, max_seq=CL, batch_slots=B,
                             device=dev)
        P = PROMPT
        prompts = np.random.default_rng(0).integers(2, 30000, (B, P))
        engine.generate(prompts, 2)                 # captures both steps
        tokens = torch.as_tensor(prompts, device=dev).long()
        logits, caches = engine.prefill({"tokens": tokens})
        tok = logits.argmax(-1).long()
        box = {"pos": torch.full((B,), P, dtype=torch.long, device=dev)}

        def one():
            engine.decode(caches, {"token": tok, "positions": box["pos"]})
            box["pos"] = box["pos"] + 1

        for _ in range(3):
            one()
        torch.cuda.synchronize()
        ms = _events_ms(one, 20)
        steps = 5
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                one()
            torch.cuda.synchronize()
        table = _kernel_table(prof, steps)
        with Fresh() as mode:
            model.decode_step(engine.params, caches,
                              {"token": tok, "positions": box["pos"]})
        torch.cuda.synchronize()
        print(json.dumps({"cell": cell, "B": B, "cl": CL,
                          "step_ms_median": statistics.median(ms),
                          "step_ms": [round(x, 3) for x in ms],
                          "kernels_ms_per_step": round(
                              sum(r["ms"] for r in table), 4),
                          "kernels": table[:16],
                          "eager_tensors_ge_2p20": mode.big}), flush=True)
        del engine, params, model, caches, logits
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("part", choices=("attn", "step"))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch to import")
    a = ap.parse_args()
    sys.path[:0] = [a.src, str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(),
                      "torch": torch.__version__, "src": a.src}), flush=True)
    (attn if a.part == "attn" else step)()
    return 0


if __name__ == "__main__":
    sys.exit(main())
