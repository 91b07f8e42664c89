"""Meta-device dry run of one (arch × shape) cell (twin of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for a TPU pod and reads
the roofline off the compiled HLO.  The port builds the same step on the
``meta`` device (shapes and dtypes, no memory, no compute) through its own
entry points — the train step of ``train/train_step.py``,
``Model.prefill``, or ``Model.decode_step`` against a ``seq_len`` cache —
counts it with ``launch.step_cost`` and puts it on the roofline of one
``launch.mesh.HARDWARE`` row (default ``"h100-sxm"``).  Prefill takes the
kernel route: K5 and K6 are custom ops whose meta form gives their output
shapes and whose formulas give their FLOPs and bytes.  An arch whose
heads K5 does not take (head_dim above ``MAX_HEAD_DIM``: nemotron-4-340b's
192) would be refused on the card; its prefill is counted through the
plain route, and the result says so (``prefill_route``).

``top_ops_by_bytes`` names the five aten ops that bill the most bytes.
``memory`` holds the argument and output bytes of the step, exact from
the meta tensors, and the bytes of outputs that alias an argument (the
in-place AdamW state, the decode caches).  ``temp_bytes_per_device`` is
null: no compiler plans a torch step's temporaries.

One device only: ``--all`` runs the one-card cells, and ``--multi-pod``
(or ``run_cell(chips=...)`` above 1) raises: the dry run of a mesh is
ROADMAP Queue 1 item 1(b), slice (C).

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mode optimized] [--jobs 4]

write JSON results to ``results/dryrun_torch/``; ``--table`` prints them
as a markdown table (one row per cell of ``--mode``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import Param, tree_map
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM
from repro_torch.launch import roofline as rl
from repro_torch.launch.settings import cell_settings
from repro_torch.launch.step_cost import StepCounter, tensors
from repro_torch.models.model import Model, build_model
from repro_torch.train.optimizer import AdamWConfig, opt_template
from repro_torch.train.train_step import TrainState, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
_MESHES = ("item 1(b), slice (C): the dry run of more than one device "
           "needs tree_sds, the activation constraints and collective "
           "bytes in launch/step_cost.py (ROADMAP Queue 1 item 1(b), "
           "slice (C))")


# ---------------------------------------------------------------------------
# input_specs: meta stand-ins for every step input (no memory)
# ---------------------------------------------------------------------------


def batch_template(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Param]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        t: Dict[str, Param] = {}
        if cfg.input_mode == "embeddings":
            t["embeds"] = Param((B, S, cfg.d_model), ("batch", None, None))
            t["positions"] = Param((B, S, 3), ("batch", None, None),
                                   dtype=torch.int32)
        else:
            t["tokens"] = Param((B, S), ("batch", None), dtype=torch.int32)
        if shape.kind == "train":
            t["labels"] = Param((B, S), ("batch", None), dtype=torch.int32)
        return t
    # decode: one new token against a seq_len cache
    t = {"positions": Param((B,), ("batch",), dtype=torch.int32)}
    if cfg.input_mode == "embeddings":
        t["embed"] = Param((B, cfg.d_model), ("batch", None))
        t["rope_positions"] = Param((B, 3), ("batch", None),
                                    dtype=torch.int32)
    else:
        t["token"] = Param((B,), ("batch",), dtype=torch.int32)
    return t


def meta_tree(template) -> Any:
    """Meta tensors of a template's shapes and dtypes."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), template)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, model: Model,
                cache_len: Optional[int] = None) -> Dict[str, Any]:
    """Every step input as meta tensors (one device: no shardings); a
    decode step's caches hold ``cache_len`` positions (default
    ``shape.seq_len``)."""
    specs: Dict[str, Any] = {"batch": meta_tree(batch_template(cfg, shape))}
    ptpl = model.template()
    specs["params"] = meta_tree(ptpl)
    if shape.kind == "train":
        specs["opt"] = meta_tree(opt_template(ptpl))
        specs["step"] = torch.empty((), dtype=torch.int32, device="meta")
    if shape.kind == "decode":
        specs["caches"] = meta_tree(
            model.cache_template(shape.global_batch,
                                 cache_len or shape.seq_len))
    return specs


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS per step: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill), 2·N_active·batch (decode, per generated token)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def step_fn(cfg: ArchConfig, shape: ShapeSpec, model: Model, specs,
            microbatches: int = 1, cache_len: Optional[int] = None):
    """The cell's step as a function of nothing, on ``specs``; prefill
    fills caches of ``cache_len`` positions (default ``shape.seq_len``)."""
    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(),
                               microbatches=microbatches)
        state = TrainState(params=specs["params"], opt=specs["opt"],
                           step=specs["step"])
        return lambda: step(state, specs["batch"])
    if shape.kind == "prefill":
        return lambda: model.prefill(specs["params"], specs["batch"],
                                     cache_len or shape.seq_len)
    return lambda: model.decode_step(specs["params"], specs["caches"],
                                     specs["batch"])


def count_cell(cfg: ArchConfig, shape: ShapeSpec, model: Model,
               microbatches: int = 1, cache_len: Optional[int] = None):
    """(specs, step outputs, ``StepCounter``) of the cell's step on meta;
    ``cache_len`` as in ``step_fn``."""
    specs = input_specs(cfg, shape, model, cache_len)
    fn = step_fn(cfg, shape, model, specs, microbatches, cache_len)
    with StepCounter(specs) as counter:
        out = fn()
    return specs, out, counter


def run_cell(arch: str, shape_name: str, mode: str = "baseline",
             chips: int = 1, hw: str = "h100-sxm") -> Dict[str, Any]:
    if chips != 1:
        raise NotImplementedError(_MESHES)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if not cfg.supports_shape(shape):
        return {"arch": arch, "shape": shape_name, "multi_pod": False,
                "mode": mode, "status": "skipped",
                "reason": "full-attention arch at 500k context (O(L^2)); "
                          "documented skip"}
    st = cell_settings(cfg, shape, mode)
    flags, route = st.flags, None
    if shape.kind == "prefill":
        route = "kernels" if flags.use_kernel else "plain"
        if (flags.use_kernel and cfg.has_attention
                and cfg.head_dim > MAX_HEAD_DIM):
            flags = dataclasses.replace(flags, use_kernel=False)
            route = (f"plain: K5 takes head_dim <= {MAX_HEAD_DIM}, this "
                     f"arch has {cfg.head_dim}")
    model = build_model(cfg, flags)
    t0 = time.time()
    specs, out, counter = count_cell(cfg, shape, model, st.microbatches)
    t_count = time.time() - t0
    roof = rl.from_cost(counter.cost, chips, hw)
    args = tensors(specs)
    outs = tensors((out[0].__dict__, out[1]) if shape.kind == "train"
                   else out)
    arg_storages = {t.untyped_storage()._cdata for t in args}
    alias = [t for t in outs if t.untyped_storage()._cdata in arg_storages]
    return {
        "arch": arch, "shape": shape_name, "multi_pod": False,
        "mode": mode, "status": "ok", "chips": chips, "hw": hw,
        "count_s": round(t_count, 1),
        "memory": {
            "argument_bytes_per_device": _bytes(args),
            "output_bytes_per_device": _bytes(outs),
            "temp_bytes_per_device": None,
            "alias_bytes_per_device": _bytes(alias),
        },
        "roofline": roof.as_dict(model_flops(cfg, shape)),
        "prefill_route": route,
        # where the bytes go: the five aten ops that bill the most
        "top_ops_by_bytes": {
            n: {"calls": v[0], "flops": v[1], "bytes": v[2]}
            for n, v in sorted(counter.by_op.items(),
                               key=lambda kv: -kv[1][2])[:5]},
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }


# ---------------------------------------------------------------------------
# CLI + orchestration
# ---------------------------------------------------------------------------


def _result_path(arch, shape, mode) -> Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    return RESULTS_DIR / f"{arch}__{shape}__pod__{mode}.json"


def run_all(jobs: int, mode: str, archs=None, shapes=None,
            force: bool = False) -> int:
    cells = []
    for arch in (archs or ARCHS):
        for shape in (shapes or SHAPES):
            out = _result_path(arch, shape, mode)
            if force or not out.exists():
                cells.append((arch, shape, out))
    print(f"{len(cells)} cells to run, {jobs} parallel", flush=True)
    procs: Dict[Any, Tuple] = {}
    failed = []
    pending = list(cells)
    while pending or procs:
        while pending and len(procs) < jobs:
            arch, shape, out = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mode", mode,
                   "--out", str(out)]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            procs[p] = (arch, shape, out)
        time.sleep(0.5)
        for p in list(procs):
            if p.poll() is None:
                continue
            arch, shape, out = procs.pop(p)
            log = p.stdout.read().decode()
            p.stdout.close()
            tag = f"{arch}/{shape}/{mode}"
            if p.returncode == 0 and out.exists():
                r = json.loads(out.read_text())
                print(f"[done] {tag}: {r['status']} "
                      f"count={r.get('count_s', '-')}s "
                      f"dom={r.get('roofline', {}).get('dominant', '-')}",
                      flush=True)
            else:
                failed.append(tag)
                print(f"[FAIL] {tag} rc={p.returncode}")
                print(log[-2000:], flush=True)
    print(f"finished; {len(failed)} failures: {failed}")
    return 1 if failed else 0


def table(mode: str, device_bytes: float = 80e9) -> str:
    """The written results of ``mode`` as a markdown table, one row per
    arch and one column per shape: the dominant term, the roofline step,
    model FLOPs over counted FLOPs, the argument bytes, and whether the
    arguments and the outputs that alias none of them fit in
    ``device_bytes`` (temporaries are not known)."""
    rows = ["| arch | " + " | ".join(SHAPES) + " |",
            "|---" * (len(SHAPES) + 1) + "|"]
    for arch in ARCHS:
        cells = []
        for shape in SHAPES:
            path = RESULTS_DIR / f"{arch}__{shape}__pod__{mode}.json"
            r = json.loads(path.read_text()) if path.exists() else {}
            if r.get("status") != "ok":
                cells.append(r.get("status", "missing"))
                continue
            rf, mem = r["roofline"], r["memory"]
            held = (mem["argument_bytes_per_device"]
                    + mem["output_bytes_per_device"]
                    - mem["alias_bytes_per_device"])
            plain = r.get("prefill_route") not in (None, "kernels")
            cells.append(
                f"{rf['dominant'][:3]} {rf['step_s']:.3g} s, "
                f"{rf['useful_ratio']:.2f}, "
                f"{mem['argument_bytes_per_device'] / 1e9:.3g} GB, "
                f"{'fits' if held <= device_bytes else 'no'}"
                + (", plain" if plain else ""))
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="baseline")
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--archs", default="")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args()
    if args.table:
        print(table(args.mode))
        return
    if args.multi_pod:
        raise NotImplementedError(_MESHES)

    if args.all:
        sys.exit(run_all(args.jobs, args.mode,
                         archs=args.archs.split(",") if args.archs else None,
                         shapes=(args.shapes.split(",") if args.shapes
                                 else None),
                         force=args.force))

    try:
        result = run_cell(args.arch, args.shape, args.mode)
    except Exception:                   # recorded in the result file
        result = {"arch": args.arch, "shape": args.shape,
                  "multi_pod": False, "mode": args.mode,
                  "status": "error", "traceback": traceback.format_exc()}
    out = args.out or _result_path(args.arch, args.shape, args.mode)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    if result["status"] == "ok":
        r = result["roofline"]
        print(f"{args.arch} {args.shape} pod {args.mode} ({r['hw']}): "
              f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s -> {r['dominant']} "
              f"(roofline_frac={r.get('roofline_fraction', 0):.3f})")
        print("memory:", result["memory"])
    else:
        print(result.get("reason") or result.get("traceback"))
        sys.exit(0 if result["status"] == "skipped" else 1)


if __name__ == "__main__":
    main()
