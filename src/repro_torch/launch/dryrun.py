"""Meta-device dry run of one (arch × shape) cell on one card or on a
production mesh (twin of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for a TPU pod and reads
the roofline off the compiled HLO.  The port builds the same step on the
``meta`` device (shapes and dtypes, no memory, no compute) through its own
entry points — the train step of ``train/train_step.py``,
``Model.prefill``, or ``Model.decode_step`` against a ``seq_len`` cache —
counts it with ``launch.step_cost`` and puts it on the roofline of one
``launch.mesh.HARDWARE`` row (default ``"h100-sxm"``).  Prefill takes the
kernel route: K5 and K6 are custom ops whose meta form gives their output
shapes and whose formulas give their FLOPs and bytes (``prefill_route``).

``chips`` picks the mesh: 1 (one card, the default), 256 (the reference's
(16, 16) pod) or 512 (its (2, 16, 16) multi-pod mesh, ``--multi-pod``).
On a mesh, ``launch.mesh.make_fake_mesh`` builds the mesh in this process
over a ``"fake"``-backend world, every input is a meta DTensor of
``sharding.tree_sds`` (each rank's shard, the reference's per-device
shapes), the step runs on DTensors, and ``StepCounter`` bills each op and
each collective DTensor issues at this rank's local shapes: FLOPs, bytes
and collective bytes per device, the collective term on the row's link
rate.  As in the reference, the batch enters split over ``pod`` only
when the cell's ``grad_sync`` is explicit, and the step runs under
``activation_sharding`` when the cell sets ``constrain_acts``.  On the
multi-pod mesh every step takes the pod route (``sharding.pod_split``):
training through the train step's pod sync, prefill and decode on each
pod's (data, model) submesh, where they need no cross-pod traffic (the
parameters replicate over pods).  No dim is then split over (pod, data),
where DTensor's redistribute planner searches exponentially.

``top_ops_by_bytes`` names the five aten ops that bill the most bytes.
``memory`` holds the argument and output bytes of the step per device,
exact from the (local) meta tensors, and the bytes of outputs that alias
an argument (the in-place AdamW state, the decode caches).
``temp_bytes_per_device`` is null: no compiler plans a torch step's
temporaries.

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --chips 256
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k --mode int8 --multi-pod
    python -m repro_torch.launch.dryrun --all [--meshes card,pod,multipod] [--mode optimized] [--jobs 4]

write JSON results to ``results/dryrun_torch/`` (``__card__`` for one
card, ``__pod__`` / ``__multipod__`` for the meshes); ``--table`` prints
one mesh's results as a markdown table (one row per cell of ``--mode``).
"""
from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.distributed.sharding import (Param, Rules,
                                              activation_sharding, pod_split,
                                              to_submesh, tree_map, tree_sds)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (close_fake_world, make_fake_mesh,
                                     make_production_mesh)
from repro_torch.launch.settings import cell_settings
from repro_torch.launch.step_cost import StepCounter, local_tensors
from repro_torch.models.model import Model, build_model
from repro_torch.train.optimizer import AdamWConfig, opt_template
from repro_torch.train.train_step import TrainState, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# --meshes name -> chips
MESHES = {"card": 1, "pod": 256, "multipod": 512}


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
                cache_len: Optional[int] = None, mesh=None,
                rules: Rules = Rules()) -> Dict[str, Any]:
    """Every step input as meta tensors: plain on one device, or meta
    DTensors laid out by ``rules`` on ``mesh`` (``tree_sds``); a decode
    step's caches hold ``cache_len`` positions (default
    ``shape.seq_len``)."""
    mk = meta_tree if mesh is None else (
        lambda t: tree_sds(t, mesh, rules))
    specs: Dict[str, Any] = {"batch": mk(batch_template(cfg, shape))}
    ptpl = model.template()
    specs["params"] = mk(ptpl)
    if shape.kind == "train":
        specs["opt"] = mk(opt_template(ptpl))
        specs["step"] = torch.empty((), dtype=torch.int32, device="meta")
    if shape.kind == "decode":
        specs["caches"] = mk(
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


def _pod_local(specs, mesh):
    """Prefill and decode inputs on each pod's (data, model) submesh."""
    _, sub, rest = pod_split(mesh)
    out = dict(specs)
    out["params"] = tree_map(
        lambda p: to_submesh(p, sub, rest, batch=False), specs["params"])
    for k in ("batch", "caches"):
        if k in specs:
            out[k] = tree_map(lambda x: to_submesh(x, sub, rest, batch=True),
                              specs[k])
    return out


def step_fn(cfg: ArchConfig, shape: ShapeSpec, model: Model, specs,
            microbatches: int = 1, cache_len: Optional[int] = None,
            grad_sync: str = "auto", mesh=None):
    """The cell's step as a function of nothing, on ``specs``; prefill
    fills caches of ``cache_len`` positions (default ``shape.seq_len``).
    ``grad_sync`` and ``mesh`` go to the train step."""
    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(),
                               microbatches=microbatches,
                               grad_sync=grad_sync, mesh=mesh)
        state = TrainState(params=specs["params"], opt=specs["opt"],
                           step=specs["step"])
        return lambda: step(state, specs["batch"])
    if shape.kind == "prefill":
        return lambda: model.prefill(specs["params"], specs["batch"],
                                     cache_len or shape.seq_len)
    return lambda: model.decode_step(specs["params"], specs["caches"],
                                     specs["batch"])


def count_cell(cfg: ArchConfig, shape: ShapeSpec, model: Model,
               microbatches: int = 1, cache_len: Optional[int] = None, *,
               mesh=None, rules: Rules = Rules(), grad_sync: str = "auto",
               constrain_acts: bool = False):
    """(specs, step outputs, ``StepCounter``) of the cell's step on meta,
    on one device or on the ``DeviceMesh`` ``mesh`` (a fake one:
    ``make_fake_mesh``) with ``rules``, ``grad_sync`` and the activation
    constraints as the cell's settings say; ``cache_len`` as in
    ``step_fn``."""
    specs = input_specs(cfg, shape, model, cache_len, mesh, rules)
    pods = mesh is not None and "pod" in mesh.mesh_dim_names
    if pods and shape.kind == "train" and grad_sync != "auto":
        # explicit pod sync: the batch enters split over "pod" only (the
        # reference's shard_map boundary); the activation constraints
        # split it over "data" inside
        specs["batch"] = tree_sds(batch_template(cfg, shape), mesh,
                                  rules.with_overrides(batch=(("pod",), ())))
    run_specs = (_pod_local(specs, mesh) if pods and shape.kind != "train"
                 else specs)
    fn = step_fn(cfg, shape, model, run_specs, microbatches, cache_len,
                 grad_sync=grad_sync if pods else "auto",
                 mesh=mesh if pods else None)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            # plain tensors made inside the model (positions, masks) meet
            # the DTensors as replicated values, as in the train step
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            stack.enter_context(implicit_replication())
            if constrain_acts:
                stack.enter_context(activation_sharding(mesh, rules))
        counter = stack.enter_context(StepCounter(specs))
        out = fn()
    return specs, out, counter


def run_cell(arch: str, shape_name: str, mode: str = "baseline",
             chips: int = 1, hw: str = "h100-sxm") -> Dict[str, Any]:
    if chips not in MESHES.values():
        raise ValueError(f"chips={chips}; one of {sorted(MESHES.values())}")
    multi_pod = chips == 512
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if not cfg.supports_shape(shape):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "mode": mode, "status": "skipped", "chips": chips,
                "reason": "full-attention arch at 500k context (O(L^2)); "
                          "documented skip"}
    st = cell_settings(cfg, shape, mode)
    route = None
    if shape.kind == "prefill":
        route = "kernels" if st.flags.use_kernel else "plain"
    model = build_model(cfg, st.flags)
    mesh = (None if chips == 1 else
            make_fake_mesh(make_production_mesh(multi_pod=multi_pod)))
    t0 = time.time()
    try:
        specs, out, counter = count_cell(
            cfg, shape, model, st.microbatches, mesh=mesh, rules=st.rules,
            grad_sync=st.grad_sync, constrain_acts=st.constrain_acts)
    finally:
        if mesh is not None:
            close_fake_world()
    t_count = time.time() - t0
    roof = rl.from_cost(counter.cost, chips, hw)
    args = local_tensors(specs)
    outs = local_tensors((out[0].__dict__, out[1])
                         if shape.kind == "train" else out)
    arg_storages = {t.untyped_storage()._cdata for t in args}
    alias = [t for t in outs if t.untyped_storage()._cdata in arg_storages]
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
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


def _mesh_name(chips: int) -> str:
    return {v: k for k, v in MESHES.items()}[chips]


def _result_path(arch, shape, mode, chips: int = 1) -> Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    return RESULTS_DIR / f"{arch}__{shape}__{_mesh_name(chips)}__{mode}.json"


def _written(path: Path, chips: int) -> Optional[Dict[str, Any]]:
    """The result written at ``path`` if it is one of the ``chips`` mesh
    (a file of another mesh under this name, such as a one-card result
    that older versions wrote as ``__pod__``, counts as not written)."""
    if not path.exists():
        return None
    r = json.loads(path.read_text())
    return r if r.get("chips") == chips else None


def run_all(jobs: int, mode: str, meshes=("card",), archs=None, shapes=None,
            force: bool = False) -> int:
    cells = []
    for arch in (archs or ARCHS):
        for shape in (shapes or SHAPES):
            for m in meshes:
                out = _result_path(arch, shape, mode, MESHES[m])
                if force or _written(out, MESHES[m]) is None:
                    cells.append((arch, shape, m, out))
    print(f"{len(cells)} cells to run, {jobs} parallel", flush=True)
    procs: Dict[Any, Tuple] = {}
    failed = []
    pending = list(cells)
    while pending or procs:
        while pending and len(procs) < jobs:
            arch, shape, m, out = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mode", mode,
                   "--chips", str(MESHES[m]), "--out", str(out)]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            procs[p] = (arch, shape, m, out)
        time.sleep(0.5)
        for p in list(procs):
            if p.poll() is None:
                continue
            arch, shape, m, out = procs.pop(p)
            log = p.stdout.read().decode()
            p.stdout.close()
            tag = f"{arch}/{shape}/{m}/{mode}"
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


def table(mode: str, chips: int = 1, device_bytes: float = 80e9) -> str:
    """The written results of ``mode`` on the ``chips`` mesh as a
    markdown table, one row per arch and one column per shape: the
    dominant term, the roofline step, model FLOPs over counted FLOPs, the
    argument bytes per device, and whether the arguments and the outputs
    that alias none of them fit in ``device_bytes`` (temporaries are not
    known)."""
    rows = ["| arch | " + " | ".join(SHAPES) + " |",
            "|---" * (len(SHAPES) + 1) + "|"]
    for arch in ARCHS:
        cells = []
        for shape in SHAPES:
            path = RESULTS_DIR / (f"{arch}__{shape}__{_mesh_name(chips)}__"
                                  f"{mode}.json")
            r = _written(path, chips)
            if r is None:
                cells.append("other mesh" if path.exists() else "missing")
                continue
            if r.get("status") != "ok":
                cells.append(r["status"])
                continue
            rf, mem = r["roofline"], r["memory"]
            held = (mem["argument_bytes_per_device"]
                    + mem["output_bytes_per_device"]
                    - mem["alias_bytes_per_device"])
            cells.append(
                f"{rf['dominant'][:3]} {rf['step_s']:.3g} s, "
                f"{rf['useful_ratio']:.2f}, "
                f"{mem['argument_bytes_per_device'] / 1e9:.3g} GB, "
                f"{'fits' if held <= device_bytes else 'no'}")
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--chips", type=int, default=1,
                    choices=sorted(MESHES.values()))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh: --chips 512")
    ap.add_argument("--mode", default="baseline")
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="card",
                    help="--all's meshes, of " + ",".join(MESHES))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--archs", default="")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args()
    chips = 512 if args.multi_pod else args.chips
    if args.table:
        print(table(args.mode, chips))
        return

    if args.all:
        meshes = args.meshes.split(",")
        bad = [m for m in meshes if m not in MESHES]
        if bad:
            ap.error(f"--meshes {bad}: not of {list(MESHES)}")
        sys.exit(run_all(args.jobs, args.mode, meshes,
                         archs=args.archs.split(",") if args.archs else None,
                         shapes=(args.shapes.split(",") if args.shapes
                                 else None),
                         force=args.force))

    try:
        result = run_cell(args.arch, args.shape, args.mode, chips)
    except Exception:                   # recorded in the result file
        result = {"arch": args.arch, "shape": args.shape,
                  "multi_pod": chips == 512, "mode": args.mode,
                  "chips": chips, "status": "error",
                  "traceback": traceback.format_exc()}
    out = args.out or _result_path(args.arch, args.shape, args.mode, chips)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    if result["status"] == "ok":
        r = result["roofline"]
        print(f"{args.arch} {args.shape} {_mesh_name(chips)} {args.mode} "
              f"({r['hw']}, {chips} chips): "
              f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s -> {r['dominant']} "
              f"(roofline_frac={r.get('roofline_fraction', 0):.3f}, "
              f"count {result['count_s']} s)")
        print("collective bytes per device by kind:",
              r["collective_per_kind"])
        print("memory:", result["memory"])
    else:
        print(result.get("reason") or result.get("traceback"))
        sys.exit(0 if result["status"] == "skipped" else 1)


if __name__ == "__main__":
    main()
