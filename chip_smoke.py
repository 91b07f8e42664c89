#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path at fleet scale through the entry points a user
calls, holds each CUDA kernel against its plain torch twin, and checks the
outputs against the port's CPU path and the paper headline:

  0. card: name and power limit (nvidia-smi), library versions
  1. build: every kernel source in ``src/repro_torch/kernels/csrc`` at
     once, with nvcc's register / shared-memory / spill report; SASS
     counts (``cuobjdump``): K5's bf16 kernels run the tensor cores
     (HGMMA in the TMA-fed wgmma kernels, HMMA in the element-wise
     mma.sync ones), its f32 kernels FFMA only, and K5's registers and
     spills (none in the wgmma kernels); K6's instructions against its
     exps, and
     each K6 instantiation's registers and spills (the per-head ones,
     Mamba-2's, spill nothing)
  2. K1 ``maiz_lohi`` (one fused launch: the sweep and the fold) and its
     per-tile instantiation / K2 ``maiz_topk`` vs their plain twins,
     bitwise, at N = 1,048,576 and a ragged N = 1,000,003, k in {1, 64,
     65, 128}; +0.0 and -0.0 in different tiles (K1, K3); the merged top-1
     and top-65 (through tile candidates) vs the CPU path and the
     full-vector merge; times at k in {1, 64, 65} (CUDA events, median of
     25 after warm-up, L2 flushed) beside the byte/operation bound,
     ``torch.topk`` over the tiles' score rows and ``torch.aminmax`` over
     the term rows as yardsticks for the selection and the reduction
     alone, K1 with L2 flushed clean, and the timing floor
  3. fleet ranking: ``ops.maiz_ranking_fused`` on a 1,048,576-node fleet;
     one device kernel per ``maiz_lohi`` / ``maiz_lohi_b`` call
     (``torch.profiler``)
  4. placement: ``scheduler.place_jobs`` (256 jobs of 64 chips, shortlist
     64, so K2 at k = 65) on 65,536 and 1,048,576 nodes, kernel path ==
     CPU path; profiled device ms per call beside the wall time
  5. simulator: ``simulate_fleet`` on a 65,536-node lifecycle fleet, 24
     epochs, kernel / plain / full engines, kernel == plain; the
     forecast's fits card vs CPU (within 1e-5 of each region's scale) on
     its windows; a 192-node stream card == CPU with the forecast term off
     and at the default w2 = 0.25
  6. Scenario C of the paper experiment on the card: -85.68 % +- 0.05 pp
  7. K3 ``maiz_lohi_b`` (fused) / K4 ``maiz_topk_b`` vs their plain twins,
     bitwise, at L = 4 lanes x N = 1,048,576 and 1,000,003 (k in {1, 64,
     65, 128}) and at the ensemble's 8 x 65,536 (k in {64, 65}), each lane
     also against K1/K2; times beside the bound (CUDA events, L2 flushed)
     and ``torch.aminmax`` over the (L, R, N) term rows as K3's yardstick
  8. batched fleet ranking: ``ops.maiz_ranking_topk_batched`` on four
     1,048,576-node fleets (K3 + K4), each lane == the sequential ranking
  9. ensemble: ``sweep_policies`` over 4 deferral thresholds x 2 seeds on
     65,536-node fleets (8 lanes, one bucket, K4 per placement round);
     every lane == its own ``simulate_fleet_scan`` and the host loop, and
     == the plain-sweep ensemble; profiled device ms per epoch beside the
     wall time; the forecast's fits card vs CPU; a 96-node three-lane
     stream card == CPU with the forecast term off and at w2 = 0.25
 10. K5 ``flash_attention`` / K6 ``selective_scan`` vs their plain
     versions at the serving path's shapes (granite-3-2b's prefill
     attention, falcon-mamba-7b's prefill scan), at ragged shapes and at
     S 2048 (K6 with long and short memory), f32 and bf16, within the JAX
     suite's bars (K5 bf16 on the wgmma route, and at hd 150 on the
     element-wise mma route); times of K5's two kernels on the path
     (bf16 wgmma, f32 FMA) and of K6 beside the bound (for f32 3xTF32 on
     the tensor
     cores, with the FMAs' own bound on the f32 pipes printed beside
     it), the plain version and (K5)
     ``scaled_dot_product_attention`` on the first backend that takes the
     inputs (flash first; the backend is printed); K5 bf16 at phase 15's
     prefill shapes (moonshot, qwen2-vl, zamba2's tied block) and K6's
     per-head form (Mamba-2: dt (B, S, H), A (H,)) bitwise its plain
     version at zamba2's prefill (B 4, S 512, H 64, P 64, N 64), the
     reduced zamba2's heads, ragged tiles, P 1 and S 2048, timed the same
     way with the issue floor of its unfused f32 arithmetic; K5 at
     nemotron-4-340b's head dim 192 with its 12:1 grouping (B 2, H 24,
     K 2, S 512 and 333), bf16 and f32, within the same bars, timed the
     same way
 11. serving at full width and depth: ``launch.serve.serve`` places the
     replica with ``place_jobs`` on a 64-pod fleet and serves 8 requests
     (2 batches of 4 slots, prompt 512, 32 new tokens, greedy) with
     granite-3-2b (40 layers; K5 on every prefill layer) and
     falcon-mamba-7b (64 layers; K6 on every prefill layer), random
     weights from a seed and a redrawn lm_head; the engine's prefill and
     decode run as CUDA graphs (one capture per step and signature, the
     launches counted per replay and warm-up), its tokens == an eager
     engine's, a captured prefill's logits and caches and 8 captured
     decode steps == the eager steps bit for bit, the decode step
     profiled eager and replayed, both engines timed; each K5 / K6
     launch of a
     prefill within its bar of the plain version on that layer's own
     inputs; each model's prefill logits through the kernels == the same
     model through the plain versions on the card, on two prompt batches
     (2e-2 / 8e-2 x max|logit|) and with f32 parameters (1e-4); the
     f32-parameter prefill is granite's path through K5's f32 kernel
 12. policies and faults on 65,536-node fleets, 24 epochs, K2/K4:
     ``sweep_policies`` over reactive, the green-window planner and SLO
     deferral (seeds 1, 2), and ``simulate_fleet_ensemble`` over the
     robustness bench's three operators at 50 % CI dropout plus its chaos
     config with 4 tenants; every lane == its own scan and the host loop,
     the policy lanes == the plain sweep, jobs conserved, the tenant bins
     summing to the emissions and within the reference's host-vs-scan
     bar; the reference's 96-node chaos and tenant probes and its n = 64
     SLO frontier card == CPU; wall and profiled device ms per epoch,
     syncs per epoch per bucket, the planner's gCO2 against reactive and
     the frontier's points printed
 13. serving traffic and the carbon-aware QPS router, held against the
     reference serving bench's recorded results (``BENCH_serving.json``):
     (a) its fixed probe (48 nodes, 24 epochs, 3 tenants, SLO 12 s, γ
     0.75) through the host loop and the scan on the card and the host
     loop on the CPU: 773,913 requests served, 4 p99 violations, the
     placement digest e6b7b02c6bd36633 with and without traffic, request
     gCO2 scan vs host within 1e-4, the tenant request bins, and a
     zero-QPS layer as a no-op; (b) its (SLO x greenness) grid at its own
     size (5 SLOs x 5 γ x seeds 1-3 = 75 lanes of 96 nodes, 168 epochs)
     as one kernel ensemble bucket, every lane against the recorded grid,
     the 8-point frontier and the 59.607 % greenness saving, the middle
     SLO's seed-1 lanes against their host loops; (c) the router attached
     to phase 9's 8 lanes of 65,536 nodes: placements bitwise phase 9's,
     lane 0's requests == its host loop, step 5b's cost (ms and device
     ops per epoch, traffic on vs off)
 14. training through ``launch.train.train_loop`` (plain torch under
     autograd, as the JAX package trains through plain jnp; no kernel):
     (a) granite-3-2b at full width and depth (2.634 B parameters, bf16,
     seed 0), copy task, batch 4 x seq 1024, 5 AdamW steps: step-0 loss
     within 1e-3 of ln 49,155 (the zero-init head), every loss and grad
     norm finite; every non-head leaf's first moment non-zero after the
     run; with a seeded head on the trained state, ``Model.loss`` within
     the serving bar of the cross-entropy of the serving route's logits on
     the same tokens, every gradient leaf finite and non-zero, and in f32
     the training forward's logits within 1e-4 x max|logit| of the
     serving route's; ms/step, tokens/s, peak
     memory, the model-FLOP share (6 N tokens / time / the card's bf16
     peak) and, profiled on one more step, the profiler's device busy
     share, the profiled step's device ms over the unprofiled steps'
     median ms, and device ops per step; (b) the other families at full
     width (``TRAIN_FULL``), 3 steps each, the same checks:
     falcon-mamba-7b with depth cut to 8 of 64 layers, batch 2 x seq
     512; zamba2-1.2b at full depth through the scan route (``train_loop``,
     batch 2 x seq 1024) and the SSD route (``make_train_step``
     with the optimized cell's flags, batch 4 x seq 1024), not profiled;
     moonshot-v1-16b-a3b at 6 of 48 layers, batch 4 x seq 512 (its step-0
     loss ln V + 0.01 x the routers' aux loss at the initial parameters);
     qwen2-vl-72b at 2 of 80 layers through ``make_train_step`` on the
     stub frontend's patch embeddings and M-RoPE ids (grid 16), batch 2 x
     seq 512, not profiled (its token table, which embeddings bypass, left
     out of the gradient checks); the runs' segments mapped on demand
     (``expandable_segments``);
     (c) reduced granite, falcon, danube, moonshot and phi3.5 (capacity
     factor 16), zamba2 (scan and SSD) and qwen2-vl with f32 parameters:
     4 train steps from one state on the card == on the CPU (losses rel
     1e-4 each step, step-0 gradients within 1e-4 x max|g| per leaf, so
     a leaf zero on the CPU is zero on the card), TF32 matmuls off;
     (d) the reference's fault test on the card (reduced granite, 16
     steps, a checkpoint every 4, a node failure at step 9): one restart,
     final loss rel 1e-4 of the clean run; (e) K1-K6 launch 0 times;
     (f) every family (c) trains, bf16: two card runs of the gradient
     from one state, and a third under
     ``torch.use_deterministic_algorithms``, bitwise equal
 15. the remaining model families: (a) moonshot-v1-16b-a3b (MoE, 64
     experts top 6; 28.06 B parameters) and (b) zamba2-1.2b (Mamba-2 with
     K6's per-head form, the tied attention block every 6 blocks),
     both at full width and depth, bf16 from seed 0, served like phase
     11 (8 requests, 2 x 4 slots, prompt 512, 32 new; captured steps
     bitwise the eager ones, tokens == an eager engine's, a digest of
     the served tokens printed); the launches
     counted per prefill, each K5 / K6 launch of a prefill within its bar
     of the plain version on that layer's inputs, the prefill logits
     kernel vs plain route (2e-2 / 4e-1 x max|logit|; for moonshot the
     share of (layer, token) top-6 sets that differ between the routes),
     zamba2's SSD route vs its scan route; (c) qwen2-vl-72b at full width,
     16 of 80 layers: stub patch embeddings (B 4, S 544) with M-RoPE ids
     (grid 32), prefill of 512, 32 decode steps fed the stub embeddings
     and their ids, eager and through the engine's captured steps
     (bitwise), the prefill kernel vs plain route and the last decode
     logits vs the training forward's at that position (2e-2); (d)
     reduced moonshot (capacity factor 16), zamba2 and qwen2-vl with f32
     parameters, prefill and 5 decode steps card == CPU (1e-4); peak
     memory per part, K5 bf16 and K6 per-head launched
 16. the roofline and dry-run layer: (a) ``EnergyModel.for_workload``
     over the 40 (arch x shape) cells on the reference's TPU v5e row ==
     ``BENCH_energy.json``'s 20 recorded cells (to 0.01 W), and the table
     on the card's row; (b) the steps of phases 11 and 14 (granite-3-2b
     prefill, decode and train step, falcon-mamba-7b prefill and decode)
     counted on the card by ``launch.step_cost`` == the meta dry run
     (``launch.dryrun.count_cell``) at the same shape, FLOPs and bytes,
     K5/K6 through their formulas; (c) every cell phases 11, 14 and 15
     time on the card's roofline row: the counted step time beside the
     measured one (a serving cell's captured step, the eager step's ms
     beside it), ``roofline_fraction`` and ``mfu`` (model FLOPs over
     the dense bf16 peak x the measured time; the training cells' within
     1 % of phase 14's share, on the parameters a token uses: both divide
     by the same measured time, so this holds ``active_param_count``
     against the tensor elements; zamba2's is printed only, its
     ``param_count`` leaving out tensors); what
     the custom op adds to a K5/K6 call's host time; (d) the five
     ``examples/torch`` scripts, each in its own process on the card, exit
     0 (green_window_planner's scene 1 over an eighth of its year,
     ``EXAMPLE_CALLS``); (e) the dry run of the production meshes on
     meta (``P16_MESH_CELLS``: granite-3-2b train_4k on (16, 16),
     llama3.2-3b train_4k int8 on (2, 16, 16), nemotron-4-340b
     prefill_32k on (16, 16) through K5's meta form, zamba2-1.2b
     train_4k optimized (the SSD route) on (16, 16)), each through the
     dry-run CLI in its own process, all side by side, each within its
     budget (120 s; zamba2's, 240 s): status ok, collective bytes per
     device > 0, each cell's terms printed
 17. more than one rank: worlds of 2 and 4 spawned ranks that share the
     one card over gloo (NCCL refuses two ranks on one device), every
     rank's tensors on cuda:0 (``distributed.ranks.run_ranks``): (a) the
     int8 / int16 / f32 pod means of a (2, 64, 32) f32 tree per rank at 2
     and 4 ranks, card == CPU bitwise, within the reference's bound, and
     their wire format; (b) granite-3-2b at full width with its depth
     cut (``P17_TRAIN``), bf16, seed 0, on a (data 2, model 2) mesh and a
     (pod 2, data 2) mesh with the int8 sync against one rank within the
     reference's bars, per rank ms/step, peak memory and collective
     bytes, and the (2, 2) checkpoint restored onto one rank leaf-equal;
     (c) phase 9's 8 lanes with ``shard=True`` on 2 ranks == phase 9's
     lanes (digests, counters, emissions), K4's launches per rank;
     (d) ``train_loop(data_mesh=2)`` with a failure at step 9: one
     restart onto data=1, the final loss within the reference's 5e-3 of
     phase 14 (d)'s clean run; (e) ``shard="en"`` at phase 9's
     configuration with K4 on node shards: one lane on 2 ranks (mesh (e
     1, n 2)) and two on 4 ((e 2, n 2)), each lane == the same lanes run
     in one process here (digests, counters bitwise; emissions within
     the ensemble's rel 1e-4), ms per epoch and K4 launches per rank;
     (f) (b)'s (data 2, model 2) step with the rules of the optimized
     llama3.2-3b train cell (the sequence split over ``model``) under
     ``activation_sharding``: the constraints issue at least one
     redistribute each step, the collective plan differs from (b)'s,
     losses within 5e-3 of one rank, collective bytes per rank-step
     beside (b)'s; at most ``P17_BUDGET_S`` seconds

The phases run in the order 0-17: phase 16's examples start after every
phase that times anything and run beside phase 16 (a)-(c) only.  Launch counts are set to 0 just before each of phases 3-5, 8,
9, 11, 12, 13, 14 and 15 (and each held prefill of phase 11, each part of phase
15) and read just after; the ranks of phase 17 (c) and (e) count their
own K4 launches and report them; K5 counts its bf16 wgmma and f32 kernels apart
(a bf16 launch of the main path on the element-wise mma kernel fails), K6
its (D, N) form (Mamba-1) and its per-head form (Mamba-2, counted as
``selective_scan_per_channel``).  The line
before the last is a JSON object with one entry per kernel; the last line is ``{"ok": true, "device":
{...}}``.  Any failed check exits non-zero before that line.  Needs one
CUDA device; run from anywhere with ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
N_BIG, N_RAGGED = 1_048_576, 1_000_003
PLACE_NS = (65_536, N_BIG)      # placement fleets; the first also runs full
SIM_N = 65_536                  # simulator fleet
LANES = 4                       # K3/K4 checks and the batched ranking
ENS_FACTORS = (0.95, 0.85, 0.75, 0.65)   # the ensemble's deferral grid
ENS_SEEDS = (1, 2)
# the tile top-k's k: checked bitwise and timed (K2/K4); 65 is the
# placement engines' k (shortlist 64 + 1), 128 the port's tile cap
TOPK_CHECK = (1, 64, 65, 128)
TOPK_TIME = (1, 64, 65)
# clocks the timing loop spins the card for after each L2 flush (about
# 0.5 ms at the H100's 1.98 GHz): room for the host to enqueue the timed
# launches
SPIN_CYCLES = 1_000_000
# exp2 results per clock per SM on the SFU (CUDA C Programming Guide,
# arithmetic instruction throughput, compute capability 9.0)
SFU_PER_CLOCK = 16
# the serving path (phase 11): full-width models, their prefill shapes
SERVE_ARCHS = ("granite-3-2b", "falcon-mamba-7b")
SERVE_REQUESTS, SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 8, 4, 512, 32
# prefill logits, kernel route vs plain route: the JAX suite's
# prefill-vs-forward bars (tests/test_decode_consistency.py), x max|logit|
SERVE_BARS = {"granite-3-2b": 2e-2, "falcon-mamba-7b": 8e-2,
              "moonshot-v1-16b-a3b": 2e-2, "zamba2-1.2b": 4e-1,
              "qwen2-vl-72b": 2e-2}
# phase 15: the archs whose prefill attention K5 runs there
PHASE15_ATTN = ("moonshot-v1-16b-a3b", "qwen2-vl-72b", "zamba2-1.2b")
# phase 13: the reference serving bench's grid (benchmarks/run.py:1149-1175,
# its defaults SERVE_NS / SERVE_EPOCHS / SERVE_QPS / SERVE_SEEDS)
TRAFFIC_N, TRAFFIC_EPOCHS, TRAFFIC_QPS = 96, 168, 20000.0
TRAFFIC_SEEDS = (1, 2, 3)
TRAFFIC_SLOS = (10.5, 11.0, 12.0, 14.0, 18.0)
TRAFFIC_GAMMAS = (0.0, 0.25, 0.5, 0.75, 1.0)
# the same with f32 parameters on both routes: the CPU suite's f32 bar
# (tests/test_torch_models.py), x max|logit|
SERVE_F32_BAR = 1e-4
# phases 11 and 15: the decode steps the captured step (CUDA graph) is
# held bitwise against the eager step for, from the same caches
GRAPH_DECODE = 8
# phase 14: (arch, layers, batch, seq, steps, route, profiled) of the
# full-width training runs.  "loop" trains through
# ``launch.train.train_loop``; "ssd" through ``make_train_step`` with the
# optimized cell's SSD flags (``train_loop``, as the reference's, builds
# the scan route only); "vlm" through ``make_train_step`` on the stub
# frontend's batches (patch embeddings, M-RoPE ids), as the reference
# trains a VLM only through its train step.  Depth is cut where the
# training state does not fit in 80 GB with 8 GiB to spare (moonshot: 7
# layers would leave 4.8; qwen2-vl: 2 layers peak at 69.4 GiB, so its run
# is not profiled and the allocator maps its segments on demand, see
# ``_train_full``) and, for falcon, to keep the phase's time (16 layers
# took 63 s of it, 8 take 31).  zamba2's chunked scan costs ~11 ms a
# token at full width (22.2 s a step at 2 x 1024 on an H100), so the scan
# route trains 2 x 1024 and the SSD route 4 x 1024 (8 chunks of 128 a
# row), 3 steps each (the zero head gets a gradient at step 0 but moves
# only at step 1, with lr 0 at step 0 of the warmup, so the body's first
# gradient comes at step 2); the scan route's step launches its ops
# chunk by chunk in every layer, too many for the profiler's trace to be
# read in the phase's time, so zamba2's steps are not profiled
TRAIN_FULL = (("granite-3-2b", 40, 4, 1024, 5, "loop", True),
              ("falcon-mamba-7b", 8, 2, 512, 3, "loop", True),
              ("zamba2-1.2b", 38, 2, 1024, 3, "loop", False),
              ("zamba2-1.2b", 38, 4, 1024, 3, "ssd", False),
              ("moonshot-v1-16b-a3b", 6, 4, 512, 3, "loop", True),
              ("qwen2-vl-72b", 2, 2, 512, 3, "vlm", False))
# the VLM batches' M-RoPE grid: 256 image patches, then text
TRAIN_VLM_GRID = 16
# the reduced card == CPU check and (f)'s determinism check: (arch, config
# overrides, flags), batch, seq (past danube's reduced window of 64),
# steps, and the bar (relative, and x max|g| per leaf); the MoE families
# at capacity factor 16, as ``FAMILY_PARITY``
TRAIN_PARITY = (("granite-3-2b", {}, {}), ("falcon-mamba-7b", {}, {}),
                ("h2o-danube-3-4b", {}, {}),
                ("moonshot-v1-16b-a3b", {"capacity_factor": 16.0}, {}),
                ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 16.0}, {}),
                ("zamba2-1.2b", {}, {"ssm_algo": "scan"}),
                ("zamba2-1.2b", {}, {"ssm_algo": "ssd"}),
                ("qwen2-vl-72b", {}, {}))
TRAIN_PARITY_SHAPE = (4, 96, 4)
TRAIN_PARITY_BAR = 1e-4
# phase 15: the remaining families served through the entry points,
# qwen2-vl-72b at full width with its depth cut (145 GB of bf16 weights
# do not fit in 80 GB), its stub frontend's M-RoPE grid, and the reduced
# f32 card == CPU check: (arch, config overrides), prompt, decode steps
FAMILY_SERVE = ("moonshot-v1-16b-a3b", "zamba2-1.2b")
VLM_ARCH, VLM_LAYERS, VLM_GRID = "qwen2-vl-72b", 16, 32
FAMILY_PARITY = (("moonshot-v1-16b-a3b", {"capacity_factor": 16.0}),
                 ("zamba2-1.2b", {}), ("qwen2-vl-72b", {}))
FAMILY_PARITY_SHAPE = (2, 37, 5)
# K5 / K6 vs their plain versions: the JAX suite's bars
# (tests/test_kernels.py), applied as |a - b| <= bar + bar * |b|
K5_BARS = {"float32": 5e-6, "bfloat16": 6e-3}
K6_BARS = {"float32": 2e-6, "bfloat16": 5e-2}
REPLACES = {
    "maiz_lohi": ("src/repro/kernels/maizx_rank.py:175",
                  "src/repro_torch/kernels/csrc/maizx_rank.cu"),
    "maiz_topk": ("src/repro/kernels/maizx_rank.py:187",
                  "src/repro_torch/kernels/csrc/maizx_rank.cu"),
    "maiz_lohi_b": ("src/repro/kernels/maizx_rank.py:203",
                    "src/repro_torch/kernels/csrc/maizx_rank.cu"),
    "maiz_topk_b": ("src/repro/kernels/maizx_rank.py:217",
                    "src/repro_torch/kernels/csrc/maizx_rank.cu"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:33",
                        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_attention_f32": ("src/repro/kernels/flash_attention.py:33",
                            "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "selective_scan": ("src/repro/kernels/selective_scan.py:32",
                       "src/repro_torch/kernels/csrc/selective_scan.cu"),
    "selective_scan_per_channel": (
        "src/repro/kernels/selective_scan.py:32",
        "src/repro_torch/kernels/csrc/selective_scan.cu"),
}


# the reference bench's chaos config (benchmarks/run.py:833-837)
def _chaos():
    from repro_torch.core.faults import FaultConfig
    return FaultConfig(ci_dropout=0.6, stale_cap_h=2, safe_stale_h=4,
                       telem_sigma=0.1, fc_outage=((5, 4),), fc_dropout=0.2,
                       mig_fail=0.4, flap_rate=0.03, quarantine_h=2)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def ulp_diff(a, b) -> int:
    """Max distance in f32 units in the last place (0 = bitwise equal)."""
    import torch
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype != torch.float32:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    ai = a.view(torch.int32).to(torch.int64)
    bi = b.view(torch.int32).to(torch.int64)
    # map sign-magnitude to a monotone integer line
    ai = torch.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = torch.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return int((ai - bi).abs().max()) if ai.numel() else 0


def abs_err(a, b) -> float:
    import torch
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def time_ms(fn, flush, reps=25, warm=3, clean=False) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs, each after
    an L2 flush and a spin kernel (no memory traffic) that keep the
    stream busy while the host enqueues ``fn``, so a slow host adds no
    idle time between the events.  The flush writes 256 MB, so ``fn``
    finds L2 full of dirty lines; ``clean`` flushes by reading them
    instead (L2 left clean)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if clean:
            flush.amax()
        else:
            flush.fill_(1.0)
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def card_hw(name: str) -> str:
    """The card's row of ``launch.mesh.HARDWARE`` (NVIDIA's data sheets;
    the rows ``launch.mesh.CARDS`` matches by name, first match wins)."""
    from repro_torch.launch.mesh import hardware_for
    hw = hardware_for(name)
    if hw is None:
        say(f"[0] no rate table entry for {name!r}: using H100 SXM's")
        hw = "h100-sxm"
    return hw


def card_rates(name: str):
    """(bytes/s, f32 FLOP/s, bf16 tensor FLOP/s, TF32 tensor FLOP/s) of
    the card."""
    from repro_torch.launch.mesh import HARDWARE
    h = HARDWARE[card_hw(name)]
    return (h.hbm_bw, h.peak_flops_f32, h.peak_flops_bf16,
            h.peak_flops_tf32)


def device_busy(fn, top=0):
    """``fn()`` under ``torch.profiler``: (result, ms of device activity,
    ms of wall time of that same profiled run, the profiler's own cost
    included, so the busy share it gives is a lower bound, and a summary
    of the ``top`` largest device kernels and host ops by self time).
    The device ms is None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    except RuntimeError as e:          # no CUPTI in this sandbox
        say(f"profiler unavailable: {e}")
        return None, None, float("nan"), ""
    wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    # only the device's own events (kernels, copies, sets): a host op that
    # launched a kernel also carries that kernel's time, so summing every
    # event's device time counts it twice
    dev = sorted((e for e in ev if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    us = sum(e.self_device_time_total for e in dev)
    summary = ""
    if top:
        host = sorted((e for e in ev if e.device_type != DeviceType.CUDA),
                      key=lambda e: -e.self_cpu_time_total)
        summary = (
            f"{sum(e.count for e in dev)} device ops; top device: "
            + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f}"
                        f" ms x{e.count}" for e in dev[:top])
            + " | top host: "
            + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} "
                        f"ms x{e.count}" for e in host[:top]))
    return out, (us / 1e3 if us > 0 else None), wall, summary


def device_kernels(fn):
    """{device op: count} of one ``fn()`` under ``torch.profiler`` (after
    a warm-up call), or None when the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:          # no CUPTI in this sandbox
        say(f"profiler unavailable: {e}")
        return None
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0}
    return ops or None


def busy_note(dev_ms, wall_ms):
    if dev_ms is None:
        return "device busy: not measured (profiler saw no device time)"
    return (f"device busy {dev_ms:.2f} ms of {wall_ms:.1f} ms wall "
            f"({100 * dev_ms / wall_ms:.1f} %)")


def bound_ms(nbytes: float, ops: float, rates, op_rate=None):
    """The larger of bytes over the memory rate and ``ops`` over
    ``op_rate`` (default: the f32 rate outside the tensor cores)."""
    tb = nbytes / rates[0] * 1e3
    to = ops / (op_rate or rates[1]) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def phase_card():
    """The card's name and power limit; returns (name, SFU exp2/s from
    the SM count and the maximum SM clock)."""
    import torch
    say(_smi("name,power.limit"))
    name = torch.cuda.get_device_name(0)
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"[0] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}, {sms} SMs, max SM clock "
        f"{mhz:.0f} MHz")
    return name, sms * SFU_PER_CLOCK * mhz * 1e6


def phase_build():
    """Build every kernel source at once (one nvcc each); nvcc's -Xptxas
    -v reports (registers, shared memory, spills per kernel) are printed
    before the timing line."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import maizx_rank as mr
    from repro_torch.kernels import selective_scan as sc
    mods = (mr, fa, sc)
    t0 = time.perf_counter()
    built = _build.build_many([(m.SOURCE, m.NVCC_FLAGS) for m in mods],
                              verbose=True)
    for m in mods:
        _build.load(m.SOURCE, m.NVCC_FLAGS, m._bind)
    say(f"[1] built {', '.join(p.name for p, _ in built)} in "
        f"{time.perf_counter() - t0:.2f} s (each done at "
        f"{', '.join(f'{t:.2f}' for _, t in built)} s)")
    # K5's bf16 kernels run on the tensor cores: wgmma (HGMMA) on the TMA
    # route, mma.sync (HMMA) on the element-wise one; its f32 kernel on
    # the FP32 pipes (FFMA, no HMMA)
    counts = sass_counts(built[mods.index(fa)][0], ("HGMMA", "HMMA", "FFMA"))
    for fn, c in counts.items():
        say(f"[1] SASS {fn}: {c['all']} instructions, {c['HGMMA']} HGMMA, "
            f"{c['HMMA']} HMMA, {c['FFMA']} FFMA")
    wg = [c for fn, c in counts.items() if "flash_wgmma_kernel" in fn]
    mma = [c for fn, c in counts.items() if "flash_mma_kernel" in fn]
    fma = [c for fn, c in counts.items() if "flash_fma_kernel" in fn]
    check(len(wg) == 3 and all(c["HGMMA"] > 0 for c in wg),
          f"K5's wgmma kernels (hd 64, 128, 192) show no HGMMA: {counts}")
    check(len(mma) == 3 and all(c["HMMA"] > 0 for c in mma),
          f"K5's mma kernels (hd 64, 128, 192) show no HMMA: {counts}")
    check(len(fma) == 3 and all(c["HGMMA"] == c["HMMA"] == 0 < c["FFMA"]
                                for c in fma),
          f"K5's f32 kernels are not FMA kernels: {counts}")
    # K5's registers, stack frame and spills per instantiation (ptxas):
    # the hd 192 ones hold 24 accumulator tiles a thread
    lib5 = built[mods.index(fa)][0]
    spills5 = dict(re.findall(
        r"Function properties for (\S+)\n\s*(\d+ bytes stack frame, \d+ "
        r"bytes spill stores, \d+ bytes spill loads)",
        _build.LOGS.get(lib5, "")))
    for fn, u in sorted(resource_usage(lib5).items()):
        say(f"[1] K5 {fn}: {u['REG']} registers, "
            f"{spills5.get(fn, 'no ptxas report (library reused)')}")
        if "flash_wgmma_kernel" in fn:
            check("0 bytes spill stores, 0 bytes spill loads"
                  in spills5.get(fn, "0 bytes spill stores, 0 bytes spill "
                                 "loads"), f"K5 {fn} spills: {spills5.get(fn)}")
    # K6: its instructions against its exps (one MUFU.EX2 per expf)
    for fn, c in sass_counts(built[mods.index(sc)][0],
                             ("MUFU", "FMUL", "FADD", "FFMA")).items():
        say(f"[1] SASS {fn}: {c['all']} instructions, {c['MUFU']} MUFU, "
            f"{c['FMUL']} FMUL, {c['FADD']} FADD, {c['FFMA']} FFMA")
    # K6's registers, stack frame and spills per instantiation (ptxas);
    # the per-head ones (Mamba-2) spill nothing
    lib = built[mods.index(sc)][0]
    usage = resource_usage(lib)
    spills = dict(re.findall(
        r"Function properties for (\S+)\n\s*(\d+ bytes stack frame, \d+ "
        r"bytes spill stores, \d+ bytes spill loads)",
        _build.LOGS.get(lib, "")))
    head = sorted(fn for fn in usage if "scan_head_kernel" in fn)
    check(len(head) == 4 and sum("Li64E" in fn for fn in head) == 2,
          f"K6's per-head kernels (N 16 and 64, f32 and bf16) are missing: "
          f"{sorted(usage)}")
    for fn in sorted(usage):
        say(f"[1] K6 {fn}: {usage[fn]['REG']} registers, "
            f"{spills.get(fn, 'no ptxas report (library reused)')}")
    for fn in head:
        check("0 bytes spill stores, 0 bytes spill loads"
              in spills.get(fn, "0 bytes spill stores, 0 bytes spill loads"),
              f"K6 {fn} spills: {spills.get(fn)}")


def sass_counts(lib, opcodes):
    """Per kernel of a built library (``cuobjdump -sass``), the number of
    SASS instructions of each opcode."""
    from repro_torch.kernels import _build
    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        counts[name.strip()] = {op: len(re.findall(rf"\b{op}\b", body))
                                for op in opcodes}
        # every instruction line starts with its address, /*0a10*/
        counts[name.strip()]["all"] = len(re.findall(r"/\*[0-9a-f]{4,}\*/",
                                                     body))
    return counts


def resource_usage(lib):
    """Per kernel of a built library (``cuobjdump -res-usage``), its
    REG / STACK / SHARED / LOCAL counts."""
    from repro_torch.kernels import _build
    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr}")
    usage = {}
    for name, line in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)",
                                 out.stdout):
        usage[name] = dict(re.findall(r"(\w+):(\d+)", line))
    return usage


def _streams(n, seed, dev, marginal, w_m):
    import torch
    g = np.random.default_rng(seed)
    s = [g.random(n) * 100, 1 + g.random(n), g.random(n) * 500,
         g.random(n) * 500, g.random(n), g.random(n)]
    s = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in s]
    kw = {}
    if marginal:
        ct = g.choice([64.0, 128.0, 256.0], n).astype(np.float32)
        cap = np.where(g.random(n) < 0.3, ct, np.floor(g.random(n) * ct))
        kw = dict(pk=torch.from_numpy((g.random(n) * 64).astype(
                      np.float32)).to(dev),
                  cap=torch.from_numpy(cap.astype(np.float32)).to(dev),
                  ct=torch.from_numpy(ct).to(dev),
                  en=torch.tensor([0.35, 0.65, 120.0, w_m], device=dev))
    return s, kw


def _pad(x, n_pad):
    import torch.nn.functional as F
    return F.pad(x, (0, n_pad - x.shape[0])).contiguous()


def phase_kernels(dev, rates, flush):
    """K1/K2 vs plain twins, bitwise, and their times."""
    import torch
    from repro_torch.kernels import maizx_rank as mr
    from repro_torch.kernels import ops

    w = torch.tensor([0.35, 0.25, 0.25, 0.15], device=dev)
    err = {"maiz_lohi": [0.0, 0], "maiz_topk": [0.0, 0]}
    times, tiles = {}, {}

    def note(name, a, b):
        err[name][0] = max(err[name][0], abs_err(a, b))
        err[name][1] = max(err[name][1], ulp_diff(a, b))

    for n in (N_BIG, N_RAGGED):
        n_pad = n + (-n) % mr.TILE
        for variant, (marginal, w_m) in (("4term", (False, 0.0)),
                                         ("5term_wm0", (True, 0.0)),
                                         ("5term_wm0.3", (True, 0.3))):
            s, kw = _streams(n, n + len(variant), dev, marginal, w_m)
            sp = [_pad(x, n_pad) for x in s]
            kwp = {k: (v if k == "en" else _pad(v, n_pad))
                   for k, v in kw.items()}
            r = 5 if marginal else 4
            # the fused sweep (one launch) and its per-tile instantiation
            lohi = mr.maiz_lohi(*sp, n, **kwp)
            lo, hi = mr.maiz_lohi_tiles(*sp, n, **kwp)
            lo_p, hi_p = mr.maiz_lohi_plain(*sp, n, **kwp)
            note("maiz_lohi", lohi, mr.fold_lohi(lo_p, hi_p))
            note("maiz_lohi", lo, lo_p)
            note("maiz_lohi", hi, hi_p)
            for k in TOPK_CHECK:
                got = mr.maiz_topk(*sp, n, lohi, w, k=k, **kwp)
                want = mr.maiz_topk_plain(*sp, n, lohi, w, k=k, **kwp)
                for a, b in zip(got, want):
                    note("maiz_topk", a, b)
            # merged shortlist: card (kernels) vs the port's CPU path, and
            # top-65 through the tile candidates vs the full-vector merge
            okw = {("chips_total" if k == "ct" else k): v
                   for k, v in kw.items()}
            for k in (1, 65):
                got = ops.maiz_ranking_topk(*s, w, k=k, **okw)
                want = ops.maiz_ranking_topk(
                    *[x.cpu() for x in s], w.cpu(), k=k,
                    **{a: b.cpu() for a, b in okw.items()})
                for a, b in zip(got, want):
                    check(ulp_diff(a, b) == 0,
                          f"merged top-{k} differs card vs CPU ({variant})")
                full_s, full_i = ops.lex_head(got[0], k)
                check(ulp_diff(got[1], full_s) == 0 and torch.equal(
                    got[2], full_i.to(torch.int32)), f"merged top-{k} "
                    f"differs from the full-vector merge ({variant})")
            torch.cuda.synchronize()
            if n == N_BIG and variant == "4term":
                rows = mr.maiz_topk(*sp, n, lohi, w, k=1)[0].view(-1,
                                                                   mr.TILE)
                times["yardstick"] = (rows.shape, time_ms(
                    lambda: torch.topk(rows, 65, dim=1, largest=False,
                                       sorted=True), flush))
                # K1's reduction alone: aminmax over the term rows
                terms = torch.stack(mr._terms(*sp, None, None, None, None))
                times["yardstick_k1"] = (terms.shape, time_ms(
                    lambda: torch.aminmax(terms, dim=1), flush))
                del terms
            for k in TOPK_TIME:
                key = (n, variant, k)
                times[("maiz_topk",) + key] = (
                    time_ms(lambda: mr.maiz_topk(*sp, n, lohi, w, k=k,
                                                 **kwp), flush),
                    time_ms(lambda: mr.maiz_topk_plain(*sp, n, lohi, w,
                                                       k=k, **kwp), flush,
                            reps=21),
                    _k2_bound(n_pad, r, k, rates))
            times[("maiz_lohi", n, variant, 0)] = (
                time_ms(lambda: mr.maiz_lohi(*sp, n, **kwp), flush),
                time_ms(lambda: mr.fold_lohi(*mr.maiz_lohi_plain(
                    *sp, n, **kwp)), flush),
                _k1_bound(n_pad, n, r, rates, dev))
            tiles[(n, variant)] = (
                time_ms(lambda: mr.maiz_lohi_tiles(*sp, n, **kwp), flush),
                time_ms(lambda: _torch_fold(mr.maiz_lohi_tiles(
                    *sp, n, **kwp)), flush),
                time_ms(lambda: mr.maiz_lohi(*sp, n, **kwp), flush,
                        clean=True),
                time_ms(lambda: mr.maiz_lohi_tiles(*sp, n, **kwp), flush,
                        clean=True))
    check_zero_order(dev)
    shape, yard = times.pop("yardstick")
    tshape, tyard = times.pop("yardstick_k1")
    for key, (ms, plain, (b, by)) in sorted(times.items(), key=str):
        say(f"[2] {key[0]} N={key[1]} {key[2]}"
            + (f" k={key[3]}" if key[0] == "maiz_topk" else "")
            + f": kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
              f"bound {b * 1e3:.2f} us ({by})")
    for (n, variant), (ms, ms_fold, fused_clean, ms_clean) in sorted(
            tiles.items(), key=str):
        say(f"[2] maiz_lohi_tiles (the fold off, one partial per tile) "
            f"N={n} {variant}: {ms * 1e3:.1f} us, {ms_fold * 1e3:.1f} us "
            f"with the three torch fold ops after it (the route before the "
            f"fused kernel); with L2 flushed clean: fused "
            f"{fused_clean * 1e3:.1f} us, tiles {ms_clean * 1e3:.1f} us")
    tiny = torch.zeros(1, device=dev)
    floor = time_ms(lambda: tiny.add_(1), flush)
    say(f"[2] timing floor: a one-element add_ {floor * 1e3:.1f} us (the "
        "launch and the events; every time above includes it)")
    say(f"[2] yardstick for the selection alone: torch.topk(k=65, "
        f"sorted=True) over the {tuple(shape)} tile score rows "
        f"{yard * 1e3:.1f} us (no tie rule; the port never calls it)")
    say(f"[2] yardstick for K1's reduction alone: torch.aminmax over the "
        f"precomputed {tuple(tshape)} term rows {tyard * 1e3:.1f} us (no "
        f"mask, no zero order; the port never calls it)")
    for name, (ae, ulp) in err.items():
        say(f"[2] {name} vs plain: max abs err {ae}, max ulp diff {ulp}")
        check(ulp == 0, f"{name} is not bitwise equal to its plain twin")
    return err, times


def check_zero_order(dev):
    """K1 and K3 on streams with +0.0 in one tile and -0.0 in another for
    the same term (the min of eff and sched, the max of the two CFP
    terms): bitwise the twin's fold, which orders -0.0 below +0.0."""
    import torch
    from repro_torch.kernels import maizx_rank as mr
    n = 4096
    g = np.random.default_rng(5)
    s = [g.random(n).astype(np.float32) + 1 for _ in range(6)]
    s[0] = -s[0]                  # ec < 0: the CFP terms' max is a zero
    s[0][5], s[0][1024 + 9] = 0.0, -0.0
    s[4][100], s[4][2048 + 7] = 0.0, -0.0
    s[5][10], s[5][3000] = 0.0, -0.0
    st = [torch.from_numpy(x).to(dev) for x in s]
    lanes = [torch.stack([x, x.flip(0)]) for x in st]
    for nv in (n, 3000):
        got = mr.maiz_lohi(*st, nv)
        want = mr.fold_lohi(*mr.maiz_lohi_plain(*st, nv))
        check(ulp_diff(got, want) == 0 and torch.equal(
            torch.signbit(got), torch.signbit(want)),
            f"K1's zero order differs from the twin's fold (n_valid {nv})")
        got_b = mr.maiz_lohi_b(*lanes, nv)
        want_b = mr.fold_lohi(*mr.maiz_lohi_plain_b(*lanes, nv))
        check(torch.equal(got_b.cpu().view(torch.int32),
                          want_b.cpu().view(torch.int32)),
              f"K3's zero order differs from the twin's fold (n_valid {nv})")
    say(f"[2] +0.0 / -0.0 in different tiles: K1 and K3 == the twins' fold "
        f"bit for bit (signs of lo/hi {torch.signbit(got).int().tolist()})")


def _torch_fold(lohi_tiles):
    """The per-tile partials folded as the wrapper did before the fused
    kernel: amin, amax and stack, three launches."""
    import torch
    lo, hi = lohi_tiles
    return torch.stack([lo.amin(-2), hi.amax(-2)], -1)


def _k1_bound(n_pad, n_valid, r, rates, dev, lanes=1):
    """The fused K1 (K3 with ``lanes``): every stream read once, each
    block's (R, 2) partial and the (R, 2) result written once."""
    from repro_torch.kernels import maizx_rank as mr
    streams = 6 if r == 4 else 9
    blocks = mr.lohi_blocks(dev, r, lanes, n_valid)
    nbytes = lanes * (n_pad * 4 * streams + (blocks + 1) * r * 2 * 4
                      + (16 if r == 5 else 0))
    ops = lanes * n_pad * ((3 if r == 4 else 12) + 2 * r)  # terms + min/max
    return bound_ms(nbytes, ops, rates)


def _k2_bound(n_pad, r, k, rates, lanes=1):
    """K2 (K4 with ``lanes``): every stream read once, scores and tile
    candidates written once."""
    streams = 6 if r == 4 else 9
    nt = n_pad // 1024
    nbytes = lanes * (n_pad * 4 * (streams + 1) + nt * k * 8 + r * 8
                      + (16 if r == 5 else 0)) + 16
    # terms + 4 ops per normalized term + k rounds of one compare per node
    ops = lanes * n_pad * ((3 if r == 4 else 12) + 4 * r + 1 + k)
    return bound_ms(nbytes, ops, rates)


def _wrappers():
    from repro_torch.kernels import maizx_rank as mr
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    return mr.WRAPPERS + (flash_attention, selective_scan)


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; returns (result, {kernel: launches}).  A CUDA graph's
    replays count the launches it captured, each time (``_graphs``); the
    capture itself counts none."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    torch.cuda.synchronize()
    for f in _wrappers():
        f.launches = 0
    routes = flash_attention.route_launches
    scan_routes = selective_scan.route_launches
    for d in (routes, scan_routes):
        for r in d:
            d[r] = 0
    out = fn()
    torch.cuda.synchronize()
    cnt = {f.__name__: f.launches for f in _wrappers()}
    # K5's two kernels: bf16 on the tensor cores, f32 on the FMA pipes;
    # K6's (D, N) decay (Mamba-1) and per-head decay (Mamba-2) forms.  The
    # main path's bf16 tensors are all TMA's: none takes the element-wise
    # mma kernel
    check(routes["bf16-mma"] == 0,
          f"{routes['bf16-mma']} bf16 K5 launches of the main path took the "
          f"element-wise mma kernel, not the wgmma one")
    cnt["flash_attention"] = routes["bf16-wgmma"]
    cnt["flash_attention_f32"] = routes["f32"]
    cnt["selective_scan"] = scan_routes["dn"]
    cnt["selective_scan_per_channel"] = scan_routes["per_channel"]
    return out, cnt


def phase_ranking(dev):
    import torch
    from repro_torch.core.fleet import synthetic_fleet
    from repro_torch.core.ranking import RankWeights
    from repro_torch.kernels import ops
    fleet = synthetic_fleet(N_BIG, seed=1, device=dev)
    w = RankWeights()
    args = (fleet.effective_power_kw(), fleet.pue, fleet.ci_now,
            fleet.ci_forecast, fleet.flops_per_j, fleet.sched_term,
            w.as_array(dev))
    (scores, best_s, best_n), n = counted(
        lambda: ops.maiz_ranking_fused(*args))
    want = fleet.rank(weights=w)
    check(scores.shape == (N_BIG,) and bool(torch.isfinite(scores).all()),
          "fused scores are not finite")
    check(abs_err(scores, want) <= 1e-5, "fused scores differ from Eq. 1")
    check(int(best_n) == int(torch.argmin(want)), "fused argmin differs")
    check(n["maiz_lohi"] > 0 and n["maiz_topk"] > 0,
          f"fused ranking launched no kernel: {n}")
    say(f"[3] fused ranking N={N_BIG}: best node {int(best_n)} score "
        f"{float(best_s):.6f}, ulp vs Eq. 1 {ulp_diff(scores, want)}, "
        f"launches {n}")
    # one maiz_lohi[_b] call is one device kernel: the fold runs inside it
    from repro_torch.kernels import maizx_rank as mr
    cols = [a.to(torch.float32).contiguous() for a in args[:6]]
    wide = [torch.stack([c] * LANES) for c in cols]
    for name, fn in (("maiz_lohi", lambda: mr.maiz_lohi(*cols, N_BIG)),
                     ("maiz_lohi_b", lambda: mr.maiz_lohi_b(*wide, N_BIG))):
        ops = device_kernels(fn)
        if ops is None:
            say(f"[3] device kernels per {name} call: not measured (the "
                "profiler saw no device activity)")
            continue
        say(f"[3] device kernels per {name} call: {sum(ops.values())} "
            f"({ops})")
        check(sum(ops.values()) == 1 and "lohi_kernel" in next(iter(ops)),
              f"{name} is not one launch of the fused kernel: {ops}")
    return n


def phase_placement(dev):
    import torch
    from repro_torch.core.fleet import synthetic_fleet
    from repro_torch.core.scheduler import place_jobs
    J, d, K = 256, 64, 64
    demands = np.full(J, d)
    total = {}
    for n in PLACE_NS:
        fg = synthetic_fleet(n, seed=1, device=dev)

        def kernel_path():
            return place_jobs(fg, demands, engine="shortlist", shortlist=K,
                              use_kernel=True)

        place_jobs(fg, demands[:8], engine="shortlist", shortlist=K,
                   use_kernel=True)                     # warm-up
        t0 = time.perf_counter()
        a, cnt = counted(kernel_path)
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in cnt.items():
            total[k] = total.get(k, 0) + v
        _, dev_ms, prof_ms, summ = device_busy(kernel_path, top=3)
        t0 = time.perf_counter()
        b = place_jobs(synthetic_fleet(n, seed=1, device="cpu"), demands,
                       engine="shortlist", shortlist=K, use_kernel=True)
        ms_cpu = (time.perf_counter() - t0) * 1e3
        check(torch.equal(a.node.cpu(), b.node), f"n={n}: nodes differ "
              "between the card's kernel path and the CPU path")
        check(a.n_sweeps == b.n_sweeps, f"n={n}: sweeps differ")
        check(cnt["maiz_topk"] == a.n_sweeps > 0,
              f"n={n}: K2 launches {cnt} != sweeps {a.n_sweeps}")
        check(int((a.node >= 0).sum()) == J, f"n={n}: unplaced jobs")
        dev_call = "not measured" if dev_ms is None else f"{dev_ms:.3f} ms"
        line = (f"[4] place_jobs n={n}: kernel path {a.n_sweeps} sweeps "
                f"{ms:.1f} ms wall, profiled device time {dev_call} per "
                f"call (K2 launches {cnt['maiz_topk']}; "
                f"{busy_note(dev_ms, prof_ms)}), CPU path {ms_cpu:.1f} ms, "
                "equal")
        if n == PLACE_NS[0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = place_jobs(fg, demands, engine="shortlist", shortlist=K)
            torch.cuda.synchronize()
            ms_c = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            f = place_jobs(fg, demands, engine="full")
            torch.cuda.synchronize()
            ms_f = (time.perf_counter() - t0) * 1e3
            check(torch.equal(c.node, f.node) and torch.equal(a.node, c.node),
                  "shortlist (plain sweep) != full re-rank on the card")
            line += (f"; plain-sweep shortlist {c.n_sweeps} sweeps "
                     f"{ms_c:.1f} ms, full {f.n_sweeps} sweeps {ms_f:.1f} ms,"
                     " equal")
        say(line)
        say(f"[4] profiled call n={n}: {summ}")
    return total


def phase_simulator(dev):
    from repro_torch.core import simulator as S
    from repro_torch.core.ranking import RankWeights
    n = SIM_N
    cfg = S.SimConfig(epochs=24, seed=1, arrival_rate=12.0,
                      mean_duration_h=12.0, migration_budget=2,
                      deferrable_frac=0.1, shortlist=64)
    fleet, traces, ridx = S.synthetic_lifecycle_fleet(n, cfg, device=dev)
    jobs = S.generate_jobs(cfg)
    runs = {}
    variants = (("plain", cfg),
                ("kernel", dataclasses.replace(cfg, use_kernel=True)),
                ("full", dataclasses.replace(cfg, engine="full")))
    for name, c in variants:       # warm-up: first-call library set-up
        S.simulate_fleet(fleet, traces, ridx,
                         dataclasses.replace(c, epochs=2), jobs=jobs)
    for name, c in variants:
        t0 = time.perf_counter()
        r, cnt = counted(lambda: S.simulate_fleet(fleet, traces, ridx, c,
                                                  jobs=jobs))
        runs[name] = (r, cnt, (time.perf_counter() - t0) * 1e3 / cfg.epochs)
    _, dev_ms, prof_ms, _ = device_busy(lambda: S.simulate_fleet(
        fleet, traces, ridx, dataclasses.replace(variants[1][1], epochs=4),
        jobs=jobs))
    (rk, ck, msk), (rp, _, msp), (rf, _, msf) = (runs["kernel"],
                                                 runs["plain"], runs["full"])
    check(np.array_equal(rp.node_log, rf.node_log)
          and rp.emissions_g == rf.emissions_g,
          "simulator: shortlist and full engines disagree on the card")
    spj = rk.rank_sweeps / max(rk.arrivals_placed, 1)
    check(ck["maiz_topk"] > 0 and spj < 0.2,
          f"simulator kernel run: launches {ck}, sweeps/job {spj:.3f}")
    check(math.isfinite(rk.emissions_g) and rk.emissions_series.shape ==
          (cfg.epochs,), "simulator emissions malformed")
    moved = int((rk.node_log != rp.node_log).sum())
    say(f"[5] simulate_fleet n={n} epochs={cfg.epochs} jobs={jobs.n}: "
        f"kernel {msk:.1f} ms/epoch ({rk.rank_sweeps} sweeps, "
        f"{spj:.3f} sweeps/job, K2 launches {ck['maiz_topk']}; 4 epochs "
        f"{busy_note(dev_ms, prof_ms)}), plain "
        f"{msp:.1f} ms/epoch ({rp.rank_sweeps} sweeps), full {msf:.1f} "
        f"ms/epoch ({rf.rank_sweeps} sweeps); shortlist == full; kernel vs "
        f"plain: {moved} jobs placed differently, emissions "
        f"{rk.emissions_g:.6e} vs {rp.emissions_g:.6e} g")
    # the kernel and plain sweeps share the card's forecast, and K2 is
    # bitwise its twin: the same placements
    check(moved == 0 and _same_run(rk, rp),
          f"simulator: the kernel sweep places {moved} jobs differently "
          "from the plain sweep on the card")
    forecast_gap(traces, cfg, dev, "[5] the simulator's")
    # a small stream, with the forecast term off (w2 = 0) and at the
    # paper's default weights (w2 = 0.25): the card's trajectory == the
    # CPU path's
    small = S.SimConfig(epochs=24, seed=11, arrival_rate=8.0,
                        mean_duration_h=8.0, shortlist=32, history_h=48,
                        horizon_h=12, migration_budget=2,
                        deferrable_frac=0.2, outage=(0, 12, 6),
                        use_kernel=True)
    for weights in (RankWeights(0.35, 0.0, 0.5, 0.15), RankWeights()):
        c = dataclasses.replace(small, weights=weights)
        out = []
        for d in (dev, "cpu"):
            f, t, ri = S.synthetic_lifecycle_fleet(192, c, chips_per_node=128,
                                                   device=d)
            out.append(S.simulate_fleet(f, t, ri, c))
        if weights.w2:
            forecast_gap(t, c, dev, "[5] the n=192 stream's")
        check(_same_run(out[0], out[1], emissions_rel=0.0),
              f"simulator: card and CPU paths disagree on the n=192 stream "
              f"(w2 = {weights.w2})")
        say(f"[5] n=192 stream, w2 = {weights.w2}: card == CPU path "
            f"({out[0].rank_sweeps} sweeps, {out[0].migrations} migrations, "
            f"{out[0].evictions} evictions, {out[0].jobs_deferred} deferred; "
            f"emissions {out[0].emissions_g!r} vs {out[1].emissions_g!r} g)")
    return ck


def forecast_gap(traces, cfg, dev, what):
    """``forecast_regions`` on the card (cuSOLVER's QR) and on the CPU
    (LAPACK's SVD driver) over every epoch window the simulator fits
    (``_forecast_step``: the ``history_h`` hours before each epoch):
    checked within 1e-5 of each region's forecast scale, the bar the CPU
    tests hold the port's forecast to against the reference."""
    import torch
    from repro_torch.core import forecast
    tr = torch.from_numpy(np.asarray(traces, np.float32))
    h = cfg.history_h
    ab = rel = 0.0
    fit_ms = []
    for t in range(cfg.epochs):
        win = tr[:, t:t + h]
        win_d = win.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card, _ = forecast.forecast_regions(win_d, cfg.horizon_h, 0)
        torch.cuda.synchronize()
        fit_ms.append((time.perf_counter() - t0) * 1e3)
        cpu, _ = forecast.forecast_regions(win, cfg.horizon_h, 0)
        d = (card.cpu() - cpu).abs()
        check(bool(torch.isfinite(card).all()), "card forecast not finite")
        ab = max(ab, float(d.max()))
        rel = max(rel, float((d.amax(1) / cpu.abs().amax(1)
                              .clamp_min(1e-30)).max()))
    say(f"{what} forecast windows ({cfg.epochs} epochs x {tr.shape[0]} "
        f"regions, history {h} h, horizon {cfg.horizon_h} h): card vs CPU "
        f"max abs err {ab:.4g}, {rel:.4g} of each region's scale (bar "
        f"1e-5); one fit on the card {statistics.median(fit_ms):.3f} ms "
        f"(median wall, synchronized)")
    check(rel <= 1e-5, f"{what} forecast: card vs CPU {rel:.3g} of the "
          "region's scale, over the 1e-5 bar")


def phase_scenario_c(dev):
    from repro_torch.core.scenarios import run_paper_experiment
    t0 = time.perf_counter()
    r = run_paper_experiment(device=dev)
    secs = time.perf_counter() - t0
    c = r.reduction_pct["C"]
    check(abs(c - 85.68) <= 0.05, f"Scenario C {c:.4f} % off the headline")
    cpu = run_paper_experiment(device="cpu")
    for k, v in cpu.emissions_kg.items():
        check(abs(r.emissions_kg[k] / v - 1) <= 1e-5,
              f"scenario {k}: card {r.emissions_kg[k]} vs CPU {v} kg")
    say(f"[6] Scenario C on the card: -{c:.4f} % CO2 ({secs:.1f} s, 8760 "
        f"epochs); kg " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    r.emissions_kg.items()))


def _lane_stack(n, n_pad, lanes, seed, dev, marginal, w_m):
    """(L, n_pad) padded streams of ``lanes`` independent lanes, with
    per-lane en rows (their own idle/embodied, the same w_m)."""
    import torch
    per = [_streams(n, seed + 7 * l, dev, marginal, w_m)
           for l in range(lanes)]
    sp = [torch.stack([_pad(p[0][i], n_pad) for p in per])
          for i in range(6)]
    kwp = {}
    if marginal:
        kwp = {k: torch.stack([_pad(p[1][k], n_pad) for p in per])
               for k in ("pk", "cap", "ct")}
        rows = [[0.35, 0.65, 120.0], [0.25, 0.75, 0.0], [0.4, 0.6, 30.0],
                [0.3, 0.7, 60.0]]
        kwp["en"] = torch.tensor([rows[l % 4] + [w_m]
                                  for l in range(lanes)], device=dev)
    return sp, kwp


def phase_batched_kernels(dev, rates, flush):
    """K3/K4 vs their plain twins, bitwise; each lane vs K1/K2 on that
    lane; times at L = 4 lanes and at the ensemble's shape."""
    import torch
    from repro_torch.kernels import maizx_rank as mr

    w = torch.tensor([0.35, 0.25, 0.25, 0.15], device=dev)
    err = {"maiz_lohi_b": [0.0, 0], "maiz_topk_b": [0.0, 0]}
    times, tiles, yard_k3 = {}, {}, {}

    def note(name, a, b):
        err[name][0] = max(err[name][0], abs_err(a, b))
        err[name][1] = max(err[name][1], ulp_diff(a, b))

    def lane_eq(a, b, what):
        check(ulp_diff(a, b) == 0, f"{what}: a K3/K4 lane differs from "
              "K1/K2 on that lane")

    shapes = [(n, LANES, v, m) for n in (N_BIG, N_RAGGED)
              for v, m in (("4term", (False, 0.0)),
                           ("5term_wm0", (True, 0.0)),
                           ("5term_wm0.3", (True, 0.3)))]
    # the ensemble's K4 shape: 8 lanes of 65,536 nodes, 5 terms, w_m = 0
    shapes.append((SIM_N, 8, "5term_wm0", (True, 0.0)))
    for n, lanes, variant, (marginal, w_m) in shapes:
        n_pad = n + (-n) % mr.TILE
        sp, kwp = _lane_stack(n, n_pad, lanes, n + len(variant), dev,
                              marginal, w_m)
        r = 5 if marginal else 4
        lohi = mr.maiz_lohi_b(*sp, n, **kwp)
        lo, hi = mr.maiz_lohi_tiles_b(*sp, n, **kwp)
        lo_p, hi_p = mr.maiz_lohi_plain_b(*sp, n, **kwp)
        note("maiz_lohi_b", lohi, mr.fold_lohi(lo_p, hi_p))
        note("maiz_lohi_b", lo, lo_p)
        note("maiz_lohi_b", hi, hi_p)
        ks = TOPK_CHECK if lanes == LANES else (64, 65)
        for l in range(lanes):
            lane = [x[l] for x in sp]
            lkw = {a: b[l] for a, b in kwp.items()}
            lane_eq(lohi[l], mr.maiz_lohi(*lane, n, **lkw),
                    f"K3 N={n} {variant}")
            lo1, hi1 = mr.maiz_lohi_tiles(*lane, n, **lkw)
            lane_eq(lo[l], lo1, f"K3 lo N={n} {variant}")
            lane_eq(hi[l], hi1, f"K3 hi N={n} {variant}")
        for k in ks:
            got = mr.maiz_topk_b(*sp, n, lohi, w, k=k, **kwp)
            want = mr.maiz_topk_plain_b(*sp, n, lohi, w, k=k, **kwp)
            for a, b in zip(got, want):
                note("maiz_topk_b", a, b)
            for l in range(lanes):
                one = mr.maiz_topk(*[x[l] for x in sp], n, lohi[l], w, k=k,
                                   **{a: b[l] for a, b in kwp.items()})
                for a, b in zip(got, one):
                    lane_eq(a[l], b, f"K4 N={n} {variant} k={k}")
        torch.cuda.synchronize()
        tag = variant if lanes == LANES else f"{variant}_L{lanes}"
        if (n, variant) in ((N_BIG, "4term"), (SIM_N, "5term_wm0")):
            # K3's reduction alone: aminmax over the precomputed (L, R, N)
            # term rows (no mask, no zero order)
            terms = torch.stack(mr._terms(
                *sp, kwp.get("pk"), kwp.get("cap"), kwp.get("ct"),
                kwp.get("en")), dim=1)
            yard_k3[(n, tag)] = (terms.shape, time_ms(
                lambda: torch.aminmax(terms, dim=-1), flush))
            del terms
        if lanes != LANES:
            rows = mr.maiz_topk_b(*sp, n, lohi, w, k=1, **kwp)[0].view(
                -1, mr.TILE)
            times["yardstick"] = (rows.shape, time_ms(
                lambda: torch.topk(rows, 65, dim=1, largest=False,
                                   sorted=True), flush))
        for k in (TOPK_TIME if lanes == LANES else ks):
            times[("maiz_topk_b", n, tag, k)] = (
                time_ms(lambda: mr.maiz_topk_b(*sp, n, lohi, w, k=k, **kwp),
                        flush),
                time_ms(lambda: mr.maiz_topk_plain_b(*sp, n, lohi, w, k=k,
                                                     **kwp), flush,
                        reps=11),
                _k2_bound(n_pad, r, k, rates, lanes))
        times[("maiz_lohi_b", n, tag, 0)] = (
            time_ms(lambda: mr.maiz_lohi_b(*sp, n, **kwp), flush),
            time_ms(lambda: mr.fold_lohi(*mr.maiz_lohi_plain_b(
                *sp, n, **kwp)), flush, reps=11),
            _k1_bound(n_pad, n, r, rates, dev, lanes))
        tiles[(n, tag)] = (
            time_ms(lambda: mr.maiz_lohi_tiles_b(*sp, n, **kwp), flush),
            time_ms(lambda: _torch_fold(mr.maiz_lohi_tiles_b(
                *sp, n, **kwp)), flush),
            time_ms(lambda: mr.maiz_lohi_b(*sp, n, **kwp), flush,
                    clean=True),
            time_ms(lambda: mr.maiz_lohi_tiles_b(*sp, n, **kwp), flush,
                    clean=True))
        del sp, kwp
    for (n, tag), (ms, ms_fold, fused_clean, ms_clean) in sorted(
            tiles.items(), key=str):
        say(f"[7] maiz_lohi_tiles_b (the fold off) N={n} {tag}: "
            f"{ms * 1e3:.1f} us, {ms_fold * 1e3:.1f} us with the three torch "
            f"fold ops; with L2 flushed clean: fused "
            f"{fused_clean * 1e3:.1f} us, tiles {ms_clean * 1e3:.1f} us")
    shape, yard = times.pop("yardstick")
    for key, (ms, plain, (b, by)) in sorted(times.items(), key=str):
        say(f"[7] {key[0]} N={key[1]} {key[2]}"
            + (f" k={key[3]}" if key[0] == "maiz_topk_b" else "")
            + f": kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
              f"bound {b * 1e3:.2f} us ({by})")
    say(f"[7] yardstick for the selection alone: torch.topk(k=65, "
        f"sorted=True) over the ensemble's {tuple(shape)} tile score rows "
        f"{yard * 1e3:.1f} us (no tie rule; the port never calls it)")
    for (n, tag), (tshape, tyard) in sorted(yard_k3.items(), key=str):
        say(f"[7] yardstick for K3's reduction alone (N={n} {tag}): "
            f"torch.aminmax over the precomputed {tuple(tshape)} term rows "
            f"{tyard * 1e3:.1f} us (no mask, no zero order; the port never "
            f"calls it)")
    for name, (ae, ulp) in err.items():
        say(f"[7] {name} vs plain: max abs err {ae}, max ulp diff {ulp}; "
            "every lane == K1/K2 on that lane")
        check(ulp == 0, f"{name} is not bitwise equal to its plain twin")
    return err, times


def phase_batched_ranking(dev):
    """``ops.maiz_ranking_topk_batched`` on four fleets: K3 then K4, each
    lane equal to the sequential fleet ranking on that fleet."""
    import torch
    from repro_torch.core.fleet import synthetic_fleet
    from repro_torch.core.ranking import RankWeights
    from repro_torch.kernels import ops
    w = RankWeights()
    wa = w.as_array(dev)
    fleets = [synthetic_fleet(N_BIG, seed=s, device=dev)
              for s in range(1, LANES + 1)]

    def cols(f):
        return (f.effective_power_kw(), f.pue, f.ci_now, f.ci_forecast,
                f.flops_per_j, f.sched_term)

    args = [torch.stack(c) for c in zip(*[cols(f) for f in fleets])]
    (scores, top_s, top_i), n = counted(
        lambda: ops.maiz_ranking_topk_batched(*args, wa, k=16))
    check(n["maiz_lohi_b"] == 1 and n["maiz_topk_b"] == 1,
          f"batched ranking launches {n}")
    for l, f in enumerate(fleets):
        want = ops.maiz_ranking_topk(*cols(f), wa, k=16)
        for a, b in zip((scores[l], top_s[l], top_i[l]), want):
            check(ulp_diff(a, b) == 0,
                  f"batched ranking lane {l} != the sequential ranking")
    ref = fleets[0].rank(weights=w)
    check(bool(torch.isfinite(scores).all()) and scores.shape ==
          (LANES, N_BIG), "batched scores malformed")
    check(abs_err(scores[0], ref) <= 1e-5, "batched lane 0 != Eq. 1")
    say(f"[8] batched ranking {LANES} x N={N_BIG}: best nodes "
        f"{top_i[:, 0].tolist()}, every lane == maiz_ranking_topk, "
        f"launches {n}")
    return n


def _grid_runs(S, cfg, grid, n, seeds, dev, region=None):
    """The (policy x seed) runs ``sweep_policies`` builds, in its order."""
    fleets = {s: S.synthetic_lifecycle_fleet(
        n, dataclasses.replace(cfg, seed=s), region=region, device=dev)
        for s in seeds}
    runs = []
    for name, pcfg in grid.items():
        for s in seeds:
            c = dataclasses.replace(cfg, seed=s, policy=pcfg)
            runs.append((name, s, fleets[s] + (c, S.generate_jobs(c))))
    return runs


def _same_run(a, b, emissions_rel=1e-4):
    keys = ("rank_sweeps", "arrivals_placed", "jobs_completed",
            "jobs_dropped", "jobs_deferred", "migrations", "evictions",
            "deadline_misses", "defer_delay_h", "migrations_failed",
            "jobs_active_end", "safe_epochs")
    return (np.array_equal(a.node_log, b.node_log)
            and np.array_equal(a.first_node, b.first_node)
            and np.array_equal(a.start_epoch, b.start_epoch)
            and all(getattr(a, k) == getattr(b, k) for k in keys)
            and abs(a.emissions_g / b.emissions_g - 1) <= emissions_rel)


def phase_ensemble(dev):
    """sweep_policies on the card: 8 kernel lanes in one bucket, held lane
    by lane against the scan driver and the host loop."""
    import torch
    from repro_torch.core import simulator as S
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.core.ranking import RankWeights
    n = SIM_N
    cfg = S.SimConfig(epochs=24, arrival_rate=12.0, mean_duration_h=12.0,
                      migration_budget=2, deferrable_frac=0.1, shortlist=64,
                      use_kernel=True)
    grid = {f"reactive_g{f}": PolicyConfig(defer_green_factor=f)
            for f in ENS_FACTORS}
    S.sweep_policies(dataclasses.replace(cfg, epochs=2), grid, n=n,
                     seeds=ENS_SEEDS, device=dev)          # warm-up
    t0 = time.perf_counter()
    records, cnt = counted(lambda: S.sweep_policies(
        cfg, grid, n=n, seeds=ENS_SEEDS, device=dev))
    ens_ms = (time.perf_counter() - t0) * 1e3 / cfg.epochs
    grid_runs = _grid_runs(S, cfg, grid, n, ENS_SEEDS, dev)
    specs = [spec for _, _, spec in grid_runs]
    ens = S.simulate_fleet_ensemble(specs)
    for rec, r in zip(records, ens):
        check(rec["deferred"] == r.jobs_deferred
              and rec["emissions_g"] == r.emissions_g,
              "sweep_policies records != the ensemble's lanes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = [S.simulate_fleet_scan(*sp[:4], jobs=sp[4], pad_plan=True)
           for sp in specs]
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3 / cfg.epochs
    # one lane or eight: the same decisions; the f32 emission sums may be
    # reduced in another order on the card
    for (name, seed, _), a, b in zip(grid_runs, ens, seq):
        check(_same_run(a, b, 1e-5), f"ensemble lane ({name}, seed {seed}) "
              "!= its own simulate_fleet_scan")
    t0 = time.perf_counter()
    host = [S.simulate_fleet(*sp[:4], jobs=sp[4]) for sp in specs]
    host_ms = (time.perf_counter() - t0) * 1e3 / cfg.epochs
    for (name, seed, _), a, h in zip(grid_runs, ens, host):
        check(_same_run(a, h), f"ensemble lane ({name}, seed {seed}) != "
              "the host loop simulate_fleet")
    plain_specs = [sp[:3] + (dataclasses.replace(sp[3], use_kernel=False),
                             sp[4]) for sp in specs]
    t0 = time.perf_counter()
    plain = S.simulate_fleet_ensemble(plain_specs)
    plain_ms = (time.perf_counter() - t0) * 1e3 / cfg.epochs
    moved = sum(int((a.node_log != b.node_log).sum())
                for a, b in zip(ens, plain))
    # the kernel and plain sweeps share each lane's forecast, and K4 is
    # bitwise its twin: the same placements
    check(moved == 0 and all(_same_run(a, b) for a, b in zip(ens, plain)),
          f"ensemble: the kernel sweep places {moved} jobs differently "
          "from the plain sweep")
    sweeps = sum(r.rank_sweeps for r in ens)
    placed = sum(r.arrivals_placed for r in ens)
    spj = sweeps / max(placed, 1)
    check(spj < 0.2 and cnt["maiz_topk_b"] > 0,
          f"ensemble: sweeps/job {spj:.3f}, launches {cnt}")
    for r in ens:
        check(math.isfinite(r.emissions_g) and r.emissions_series.shape ==
              (cfg.epochs,), "ensemble emissions malformed")
    syncs = ens[0].host_syncs / cfg.epochs
    short = [sp[:3] + (dataclasses.replace(sp[3], epochs=4),
                       S.generate_jobs(dataclasses.replace(sp[3], epochs=4)))
             for sp in specs]
    _, dev_ms, prof_ms, prof_top = device_busy(
        lambda: S.simulate_fleet_ensemble(short), top=6)
    jobs = sum(sp[4].n for sp in specs)
    dev_epoch = ("not measured" if dev_ms is None
                 else f"{dev_ms / 4:.3f} ms")
    say(f"[9] sweep_policies {len(specs)} lanes x n={n} x {cfg.epochs} "
        f"epochs ({jobs} jobs): ensemble {ens_ms:.1f} ms/epoch wall, "
        f"profiled device time {dev_epoch} per epoch (K4 "
        f"launches {cnt['maiz_topk_b']}, {sweeps} sweeps, {spj:.3f} "
        f"sweeps/job, {syncs:.1f} host syncs/epoch; 4 epochs "
        f"{busy_note(dev_ms, prof_ms)}); {len(specs)} sequential scans "
        f"{seq_ms:.1f} ms/epoch, {len(specs)} host loops {host_ms:.1f} "
        f"ms/epoch; plain-sweep ensemble {plain_ms:.1f} ms/epoch; every lane "
        f"== its scan and the host loop ({len(host)}/{len(host)}); kernel vs "
        f"plain sweep: {moved} jobs placed differently")
    say(f"[9] 4 profiled epochs: {prof_top}")
    say("[9] records: " + json.dumps([
        {k: rec[k] for k in ("policy", "seed", "emissions_g", "deferred",
                             "avg_start_delay_h")} for rec in records]))
    front = S.pareto_frontier(records)
    say(f"[9] pareto frontier: {[p['policy'] for p in front]}")
    for seed in ENS_SEEDS:
        forecast_gap(grid_runs[ENS_SEEDS.index(seed)][2][1],
                     dataclasses.replace(cfg, seed=seed), dev,
                     f"[9] the seed-{seed} fleets'")
    # a small mixed stream, with the forecast term off (w2 = 0) and at the
    # paper's default weights (w2 = 0.25): the card's ensemble == the CPU's
    small = S.SimConfig(epochs=24, arrival_rate=8.0, mean_duration_h=10.0,
                        shortlist=32, history_h=48, horizon_h=12,
                        migration_budget=2, deferrable_frac=0.3,
                        outage=(0, 12, 6), flash_crowd=(20, 3, 2.5),
                        use_kernel=True)
    for weights in (RankWeights(0.35, 0.0, 0.5, 0.15), RankWeights()):
        out = []
        for d in (dev, "cpu"):
            sp = []
            for seed in (11, 12, 13):
                c = dataclasses.replace(small, seed=seed, weights=weights)
                f, t, ri = S.synthetic_lifecycle_fleet(
                    96, c, chips_per_node=64, device=d)
                sp.append((f, t, ri, c, S.generate_jobs(c)))
                if weights.w2 and d == "cpu":
                    forecast_gap(t, c, dev, f"[9] the n=96 seed-{seed} lane's")
            out.append(S.simulate_fleet_ensemble(sp))
        check(all(_same_run(a, b) for a, b in zip(*out)),
              f"ensemble: card and CPU lanes disagree on the 96-node stream "
              f"(w2 = {weights.w2})")
        say(f"[9] n=96 stream, 3 lanes, w2 = {weights.w2}: card == CPU ("
            f"{sum(r.migrations for r in out[0])} migrations, "
            f"{sum(r.evictions for r in out[0])} evictions, "
            f"{sum(r.jobs_deferred for r in out[0])} deferred)")
    return cnt, (cfg, grid_runs, ens)


def _conserved(r, jobs, epochs):
    """No job silently dropped: every in-horizon job is completed,
    dropped, or still running at the horizon."""
    in_h = int((np.asarray(jobs.arrive) < epochs).sum())
    placed = r.first_node >= 0
    return (r.jobs_completed + r.jobs_dropped + r.jobs_active_end == in_h
            and r.jobs_completed + r.jobs_active_end <= int(placed.sum())
            and bool(np.all(r.node_log[~placed] == -1)))


def _tenant_bins_ok(r, rel):
    t = r.tenant_emissions_g
    return t is not None and abs(t.sum() / r.emissions_g - 1) <= rel


def _syncs(results, epochs):
    """Host syncs per epoch of each distinct bucket among ``results``."""
    return sorted({round(r.host_syncs / epochs, 2) for r in results})


def phase_policies(dev):
    """Phase 12: the carbon policies (reactive, green-window planner, SLO
    deferral) and signal faults (the robustness bench's three operators,
    the chaos config with tenants) through the ensemble, the scanned
    driver and the host loop on 65,536-node fleets with K2/K4; three
    small probes card == CPU."""
    import torch
    from repro_torch.core import policy as P
    from repro_torch.core import simulator as S
    from repro_torch.core.faults import FaultConfig
    n = SIM_N
    cfg = S.SimConfig(epochs=24, arrival_rate=12.0, mean_duration_h=12.0,
                      migration_budget=2, deferrable_frac=0.1, shortlist=64,
                      use_kernel=True)
    T = cfg.epochs
    grid = {"reactive": P.REACTIVE, "green_window": P.green_window(),
            "slo": P.slo_deferral(0.95, value_weight=1.0, deadline_hi=24)}
    S.sweep_policies(dataclasses.replace(cfg, epochs=2), grid, n=n,
                     seeds=ENS_SEEDS, device=dev)              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records, cnt = counted(lambda: S.sweep_policies(
        cfg, grid, n=n, seeds=ENS_SEEDS, device=dev))
    sweep_ms = (time.perf_counter() - t0) * 1e3 / T
    grid_runs = _grid_runs(S, cfg, grid, n, ENS_SEEDS, dev)
    specs = [sp for _, _, sp in grid_runs]
    ens = S.simulate_fleet_ensemble(specs)
    for rec, r in zip(records, ens):
        check(rec["deferred"] == r.jobs_deferred
              and rec["emissions_g"] == r.emissions_g,
              "[12] sweep_policies records != the ensemble's lanes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scans = [S.simulate_fleet_scan(*sp[:4], jobs=sp[4], pad_plan=True)
             for sp in specs]
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3 / T
    t0 = time.perf_counter()
    hosts, cnt_h = counted(lambda: [S.simulate_fleet(*sp[:4], jobs=sp[4])
                                    for sp in specs])
    host_ms = (time.perf_counter() - t0) * 1e3 / T
    for (name, seed, _), a, b, h in zip(grid_runs, ens, scans, hosts):
        check(_same_run(a, b, 1e-5), f"[12] ensemble lane ({name}, seed "
              f"{seed}) != its own simulate_fleet_scan")
        check(_same_run(a, h), f"[12] ensemble lane ({name}, seed {seed}) "
              "!= the host loop simulate_fleet")
        check(math.isfinite(a.emissions_g) and a.emissions_series.shape
              == (T,), "[12] ensemble emissions malformed")
    plain = S.simulate_fleet_ensemble(
        [sp[:3] + (dataclasses.replace(sp[3], use_kernel=False), sp[4])
         for sp in specs])
    moved = sum(int((a.node_log != b.node_log).sum())
                for a, b in zip(ens, plain))
    check(moved == 0 and all(_same_run(a, b) for a, b in zip(ens, plain)),
          f"[12] the kernel sweep places {moved} jobs differently from the "
          "plain sweep under the policies")
    check(cnt["maiz_topk_b"] > 0 and cnt_h["maiz_topk"] > 0,
          f"[12] policy runs launched no rank kernel: {cnt}, {cnt_h}")
    by = {}
    for rec in records:
        by.setdefault(rec["policy"], []).append(rec)
    mean = {k: {f: float(np.mean([r[f] for r in v])) for f in
                ("emissions_g", "migrations", "deferred", "deadline_misses",
                 "avg_start_delay_h")} for k, v in by.items()}
    short = [sp[:3] + (dataclasses.replace(sp[3], epochs=4),
                       S.generate_jobs(dataclasses.replace(sp[3], epochs=4)))
             for sp in specs]
    _, dev_ms, prof_ms, prof_top = device_busy(
        lambda: S.simulate_fleet_ensemble(short), top=6)
    say(f"[12] policies: sweep_policies {len(specs)} lanes (3 policies x "
        f"seeds {ENS_SEEDS}) x n={n} x {T} epochs: {sweep_ms:.1f} ms/epoch "
        f"wall, profiled device time "
        + ("not measured" if dev_ms is None else f"{dev_ms / 4:.3f} ms")
        + f" per epoch (4 epochs {busy_note(dev_ms, prof_ms)}), host syncs/"
        f"epoch per bucket {_syncs(ens, T)}, K4 launches "
        f"{cnt['maiz_topk_b']}; {len(specs)} scans {scan_ms:.1f} ms/epoch, "
        f"{len(specs)} host loops {host_ms:.1f} ms/epoch (K2 launches "
        f"{cnt_h['maiz_topk']}); every lane == its scan and the host loop, "
        f"kernel vs plain sweep: {moved} moved")
    say(f"[12] policies, 4 profiled epochs: {prof_top}")
    say("[12] policy means over seeds: " + json.dumps(mean))
    gw, re_ = mean["green_window"], mean["reactive"]
    say(f"[12] planner vs reactive (mean of seeds {ENS_SEEDS}): gCO2 "
        f"{gw['emissions_g']!r} vs {re_['emissions_g']!r} ("
        f"{100 * (gw['emissions_g'] / re_['emissions_g'] - 1):+.4f} %), "
        f"migrations {gw['migrations']} vs {re_['migrations']}")

    # ---- signal faults: three operators at 50 % dropout, chaos + tenants
    modes = {"naive": FaultConfig(), "degraded": FaultConfig(stale_cap_h=6),
             "safe": FaultConfig(stale_cap_h=6, safe_stale_h=12)}
    fleets = {s: sp[:3] for (_, s, sp) in grid_runs[:len(ENS_SEEDS)]}
    fspecs, fnames = [], []
    for mode, fc in modes.items():
        for s in ENS_SEEDS:
            c = dataclasses.replace(cfg, seed=s, faults=dataclasses.replace(
                fc, ci_dropout=0.5))
            fspecs.append(fleets[s] + (c, S.generate_jobs(c)))
            fnames.append(f"{mode}, seed {s}")
    c = dataclasses.replace(cfg, seed=ENS_SEEDS[0], faults=_chaos(),
                            n_tenants=4)
    fspecs.append(fleets[ENS_SEEDS[0]] + (c, S.generate_jobs(c)))
    fnames.append(f"chaos + 4 tenants, seed {ENS_SEEDS[0]}")
    S.simulate_fleet_ensemble(
        [sp[:3] + (dataclasses.replace(sp[3], epochs=2),
                   S.generate_jobs(dataclasses.replace(sp[3], epochs=2)))
         for sp in fspecs])                                    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fens, cnt_f = counted(lambda: S.simulate_fleet_ensemble(fspecs))
    fens_ms = (time.perf_counter() - t0) * 1e3 / T
    fscans = [S.simulate_fleet_scan(*sp[:4], jobs=sp[4], pad_plan=True)
              for sp in fspecs]
    t0 = time.perf_counter()
    fhosts, cnt_fh = counted(lambda: [S.simulate_fleet(*sp[:4], jobs=sp[4])
                                      for sp in fspecs])
    fhost_ms = (time.perf_counter() - t0) * 1e3 / T
    for name, sp, a, b, h in zip(fnames, fspecs, fens, fscans, fhosts):
        check(_same_run(a, b, 1e-5), f"[12] fault lane ({name}) != its own "
              "simulate_fleet_scan")
        check(_same_run(a, h), f"[12] fault lane ({name}) != the host loop")
        check(_conserved(a, sp[4], T) and _conserved(h, sp[4], T),
              f"[12] fault lane ({name}): jobs not conserved")
    ch, chh = fens[-1], fhosts[-1]
    check(_tenant_bins_ok(ch, 1e-5) and _tenant_bins_ok(chh, 1e-12),
          "[12] tenant bins do not sum to the emissions")
    # the reference's bar (tests/test_energy.py:130-134): rtol 1e-3 with
    # an atol of 1e-7 of the total, for the near-zero idle bin
    diff = np.abs(ch.tenant_emissions_g - chh.tenant_emissions_g)
    bar = 1e-7 * chh.emissions_g + 1e-3 * np.abs(chh.tenant_emissions_g)
    bins_gap = float(np.max(diff / bar))
    check(bins_gap <= 1.0, f"[12] tenant bins: scan vs host at "
          f"{bins_gap:.3g} x the reference's bar")
    check(ch.evictions > 0, "[12] the chaos lane saw no flap eviction")
    check(cnt_f["maiz_topk_b"] > 0 and cnt_fh["maiz_topk"] > 0,
          f"[12] fault runs launched no rank kernel: {cnt_f}, {cnt_fh}")
    fshort = [sp[:3] + (dataclasses.replace(sp[3], epochs=4),
                        S.generate_jobs(dataclasses.replace(sp[3],
                                                            epochs=4)))
              for sp in fspecs]
    _, fdev_ms, fprof_ms, _ = device_busy(
        lambda: S.simulate_fleet_ensemble(fshort))
    say(f"[12] faults: simulate_fleet_ensemble {len(fspecs)} lanes x n={n} "
        f"x {T} epochs: {fens_ms:.1f} ms/epoch wall, profiled device time "
        + ("not measured" if fdev_ms is None else f"{fdev_ms / 4:.3f} ms")
        + f" per epoch (4 epochs {busy_note(fdev_ms, fprof_ms)}), host "
        f"syncs/epoch per bucket {_syncs(fens, T)}, K4 launches "
        f"{cnt_f['maiz_topk_b']}; {len(fspecs)} host loops {fhost_ms:.1f} "
        f"ms/epoch; every lane == its scan and the host loop, jobs "
        f"conserved")
    say("[12] fault lanes: " + "; ".join(
        f"{nm}: {r.emissions_g:.6e} g, {r.migrations} mig, "
        f"{r.migrations_failed} failed, {r.evictions} evicted, "
        f"{r.safe_epochs} safe, {r.jobs_deferred} deferred"
        for nm, r in zip(fnames, fens)))
    say(f"[12] chaos tenant bins (g): {ch.tenant_emissions_g.tolist()} "
        f"(scan) vs host {chh.tenant_emissions_g.tolist()}, gap "
        f"{bins_gap:.3g} x the bar; sum / emissions - 1 = "
        f"{ch.tenant_emissions_g.sum() / ch.emissions_g - 1:.3g}")

    # ---- card == CPU on the reference's own probes --------------------
    probes = {
        "chaos probe": S.SimConfig(
            epochs=36, seed=3, arrival_rate=6.0, mean_duration_h=12.0,
            migration_budget=2, deferrable_frac=0.3, shortlist=16,
            history_h=48, horizon_h=8, outage=[(0, 6, 4), (1, 18, 4)],
            faults=_chaos(), use_kernel=True),
        "tenant probe": S.SimConfig(
            epochs=48, seed=3, arrival_rate=6.0, mean_duration_h=6.0,
            shortlist=16, history_h=48, horizon_h=8, n_tenants=4,
            use_kernel=True)}
    for name, pc in probes.items():
        out = {}
        for d in (dev, "cpu"):
            f, t, ri = S.synthetic_lifecycle_fleet(96, pc, chips_per_node=64,
                                                   device=d)
            jobs = S.generate_jobs(pc)
            out[str(d)] = (S.simulate_fleet(f, t, ri, pc, jobs=jobs),
                           S.simulate_fleet_scan(f, t, ri, pc, jobs=jobs))
        (hc, sc), (hp, sp_) = out[str(dev)], out["cpu"]
        check(_same_run(hc, hp, 0.0) and _same_run(sc, sp_, 1e-6)
              and _same_run(sc, hc), f"[12] {name}: card and CPU disagree")
        if pc.faults is not None:
            check(hc.migrations_failed > 0 and hc.evictions > 0,
                  f"[12] {name}: no migration failure or eviction")
        if pc.n_tenants:
            # the tenants' bins are float64 sums of the same f32 shares on
            # both devices; the idle bin carries the f32 rounding of each
            # epoch's total, whose summation order is the device's: it is
            # held to the emissions' own card-vs-CPU bar
            check(np.allclose(sc.tenant_emissions_g, sp_.tenant_emissions_g,
                              rtol=1e-9, atol=1e-6 * sp_.emissions_g)
                  and np.array_equal(hc.tenant_emissions_g,
                                     hp.tenant_emissions_g)
                  and _tenant_bins_ok(sc, 1e-5),
                  f"[12] {name}: tenant bins card vs CPU")
        say(f"[12] {name} (n=96): card == CPU, host loop and scan "
            f"({hc.migrations} migrations, {hc.migrations_failed} failed, "
            f"{hc.evictions} evictions, {hc.safe_epochs} safe epochs, "
            f"{hc.jobs_deferred} deferred)")
    fcfg = S.SimConfig(epochs=24, seed=ENS_SEEDS[0], arrival_rate=24.0,
                       mean_duration_h=3.0, migration_budget=0,
                       deferrable_frac=0.5, defer_max_h=24, shortlist=64,
                       use_kernel=True)
    fgrid = {"no_defer": P.slo_deferral(0.0, deadline_hi=24)}
    for w in (4.0, 2.0, 1.0, 0.5, 0.0):
        fgrid[f"slo_w{w:g}"] = P.slo_deferral(0.95, value_weight=w,
                                              deadline_hi=24)
    lanes = {}
    for d in (dev, "cpu"):
        runs = _grid_runs(S, fcfg, fgrid, 64, ENS_SEEDS, d, region=0)
        lanes[str(d)] = S.simulate_fleet_ensemble([sp for _, _, sp in runs])
    check(all(_same_run(a, b, 1e-5) for a, b in zip(lanes[str(dev)],
                                                    lanes["cpu"])),
          "[12] SLO frontier: card and CPU lanes disagree")
    frecs = S.sweep_policies(fcfg, fgrid, n=64, seeds=ENS_SEEDS, region=0,
                             device=dev)
    front = S.pareto_frontier(frecs)
    say(f"[12] SLO frontier (n=64, region 0, {fcfg.epochs} epochs, "
        f"{len(frecs)} lanes): card == CPU lane by lane; frontier "
        + json.dumps([{k: p[k] for k in ("policy", "avg_start_delay_h",
                                         "emissions_g", "miss_rate")}
                      for p in front]))
    total = {}
    for part in (cnt, cnt_h, cnt_f, cnt_fh):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


def _digest(r) -> str:
    """The reference's placement digest (``node_log`` then
    ``first_node``, sha256, first 16 hex digits)."""
    import hashlib
    return hashlib.sha256(np.concatenate(
        [r.node_log, r.first_node]).tobytes()).hexdigest()[:16]


def _router(cfg, slo, g):
    return dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, router_slo_s=slo, router_greenness=g))


def _requests(r):
    return (r.req_served, r.req_offered, r.p99_violations)


def device_ops(fn):
    """(device ops, device ms) of one ``fn()`` under ``torch.profiler``,
    or (None, None) when the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:          # the profiler found no CUPTI
        say(f"profiler unavailable: {e}")
        return None, None
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    if not dev:
        return None, None
    return (sum(e.count for e in dev),
            sum(e.self_device_time_total for e in dev) / 1e3)


def phase_traffic(dev, ens9):
    """Phase 13: serving traffic and the QPS router through the host loop,
    the scan and the ensemble, against the reference serving bench's
    recorded results; step 5b's cost on phase 9's fleet-scale lanes."""
    import torch
    from repro_torch.core import simulator as S
    from repro_torch.core.traffic import TrafficConfig
    t_phase = time.perf_counter()
    bench = json.loads((SRC.parent / "BENCH_serving.json").read_text())
    bench = bench["configs"][0]
    total = {}

    def add(cnt):
        for k, v in cnt.items():
            total[k] = total.get(k, 0) + v

    # ---- (a) the bench's fixed parity probe (run.py:1117-1147) ----------
    pcfg = S.SimConfig(epochs=24, seed=3, arrival_rate=16.0,
                       mean_duration_h=10.0, shortlist=16, history_h=48,
                       horizon_h=8, chips_lo=8, chips_hi=32, n_tenants=3,
                       use_kernel=True)
    ptc = TrafficConfig(req_rate=20000.0, n_svc=4, flash_rate=0.05,
                        mu_per_chip=0.1)
    loud = _router(dataclasses.replace(pcfg, traffic=ptc), 12.0, 0.75)
    zero = dataclasses.replace(pcfg, traffic=dataclasses.replace(
        ptc, req_rate=0.0))
    pjobs = S.generate_jobs(loud)
    fc = S.synthetic_lifecycle_fleet(48, pcfg, chips_per_node=64, device=dev)
    fp = S.synthetic_lifecycle_fleet(48, pcfg, chips_per_node=64,
                                     device="cpu")
    t0 = time.perf_counter()
    (base, h, sc, zh, zs), cnt = counted(lambda: (
        S.simulate_fleet(*fc, pcfg, jobs=pjobs),
        S.simulate_fleet(*fc, loud, jobs=pjobs),
        S.simulate_fleet_scan(*fc, loud, jobs=pjobs),
        S.simulate_fleet(*fc, zero, jobs=pjobs),
        S.simulate_fleet_scan(*fc, zero, jobs=pjobs)))
    probe_s = time.perf_counter() - t0
    add(cnt)
    check(cnt["maiz_topk"] > 0 and cnt["maiz_topk_b"] > 0,
          f"[13] the probe launched no K2 or K4: {cnt}")
    hp = S.simulate_fleet(*fp, loud, jobs=pjobs)
    par = bench["parity"]
    want = (par["req_served"], par["p99_violations"])
    for name, r in (("card host loop", h), ("card scan", sc),
                    ("CPU host loop", hp)):
        check((r.req_served, r.p99_violations) == want,
              f"[13] probe {name}: served/violations "
              f"{(r.req_served, r.p99_violations)} != the bench's {want}")
        check(_digest(r) == bench["placement_digest"],
              f"[13] probe {name}: digest {_digest(r)}")
        check(r.tenant_request_g is not None
              and r.tenant_request_g[-1] == 0.0
              and abs(r.tenant_request_g.sum() / r.req_gco2 - 1) <= 1e-4,
              f"[13] probe {name}: tenant request bins "
              f"{r.tenant_request_g}")
    check(h.req_offered == sc.req_offered == hp.req_offered,
          "[13] probe: offered requests differ between the drivers")
    check(_digest(base) == bench["placement_digest"],
          f"[13] probe without traffic: digest {_digest(base)} != "
          f"{bench['placement_digest']}")
    check(_same_run(h, hp, 0.0) and h.req_gco2 == hp.req_gco2
          and h.req_p99_s == hp.req_p99_s,
          "[13] probe: the card's host loop != the CPU's")
    rel = abs(sc.req_gco2 / h.req_gco2 - 1)
    check(rel <= 1e-4 and abs(sc.req_p99_s / h.req_p99_s - 1) <= 1e-3,
          f"[13] probe: request gCO2 scan vs host off by {rel:.3g}")
    for name, r in (("host loop", zh), ("scan", zs)):
        check(_digest(r) == _digest(base) and _requests(r) == (0, 0, 0)
              and r.req_gco2 == 0.0,
              f"[13] probe at zero QPS: the {name} is not a no-op")
    say(f"[13] (a) probe n=48, 24 epochs: served {h.req_served}, offered "
        f"{h.req_offered}, {h.p99_violations} violations on the card's host "
        f"loop and scan and the CPU's host loop (bench: {want}); digest "
        f"{_digest(h)} with and without traffic; req gCO2 host "
        f"{h.req_gco2!r} vs scan {sc.req_gco2!r} (rel {rel:.3g}), p99 "
        f"{h.req_p99_s!r} vs {sc.req_p99_s!r} s; tenant request bins "
        f"{sc.tenant_request_g.tolist()}; zero QPS a no-op; five runs "
        f"{probe_s:.1f} s, launches {cnt}")

    # ---- (b) the (SLO x greenness) grid at the bench's size -------------
    n, T = TRAFFIC_N, TRAFFIC_EPOCHS
    tc = TrafficConfig(req_rate=TRAFFIC_QPS, n_svc=4, flash_rate=0.0,
                       mu_per_chip=0.1)
    runs, metas = [], []
    for seed in TRAFFIC_SEEDS:
        cfg = S.SimConfig(epochs=T, seed=seed, arrival_rate=n / 3.0,
                          mean_duration_h=10.0, shortlist=16, history_h=48,
                          horizon_h=8, chips_lo=8, chips_hi=32, traffic=tc,
                          use_kernel=True)
        fl = S.synthetic_lifecycle_fleet(n, cfg, chips_per_node=64,
                                         device=dev)
        jobs = S.generate_jobs(cfg)
        for slo in TRAFFIC_SLOS:
            for g in TRAFFIC_GAMMAS:
                runs.append(fl + (_router(cfg, slo, g), jobs))
                metas.append((slo, g, seed))
    keys = {S._bucket_key(S._prepare_scan_run(*sp[:4], sp[4]))
            for sp in runs}
    check(len(keys) == 1, f"[13] the grid split into {len(keys)} buckets")
    S.simulate_fleet_ensemble(
        [sp[:3] + (dataclasses.replace(sp[3], epochs=2),
                   S.generate_jobs(dataclasses.replace(sp[3], epochs=2)))
         for sp in runs])                                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, cnt = counted(lambda: S.simulate_fleet_ensemble(runs))
    grid_ms = (time.perf_counter() - t0) * 1e3 / T
    add(cnt)
    # the engines take the frozen lo/hi of their context: K4 ranks, K3
    # does not run here
    check(cnt["maiz_topk_b"] > 0, f"[13] the grid launched no K4: {cnt}")
    recorded = {(r["slo_s"], r["greenness"], r["seed"]): r
                for r in bench["grid"]}
    check(len(recorded) == len(runs) == 75,
          f"[13] grid: {len(runs)} lanes, {len(recorded)} recorded")
    recs, worst = [], [0.0, 0.0]
    for (slo, g, seed), r in zip(metas, res):
        served = max(r.req_served, 1)
        rec = {"policy": f"slo{slo:g}_g{g:g}", "seed": seed, "slo_s": slo,
               "greenness": g, "miss_rate": r.p99_violations / served,
               "req_p99_s": r.req_p99_s, "g_per_req": r.req_gco2 / served}
        recs.append(rec)
        w = recorded[(slo, g, seed)]
        e_g = abs(rec["g_per_req"] / w["g_per_req"] - 1)
        e_p = abs(rec["req_p99_s"] / w["req_p99_s"] - 1)
        worst = [max(worst[0], e_g), max(worst[1], e_p)]
        check(rec["miss_rate"] == w["miss_rate"] and e_g <= 1e-4
              and e_p <= 1e-3,
              f"[13] grid lane (slo {slo}, γ {g}, seed {seed}): miss rate "
              f"{rec['miss_rate']!r} vs {w['miss_rate']!r}, g/req rel "
              f"{e_g:.3g}, p99 rel {e_p:.3g}")
    front = S.pareto_frontier(recs, x="req_p99_s", y="g_per_req")
    xs = [p["req_p99_s"] for p in front]
    ys = [p["g_per_req"] for p in front]
    monotone = (all(b > a for a, b in zip(xs, xs[1:]))
                and all(b < a for a, b in zip(ys, ys[1:])))
    check(len(front) == bench["frontier_points"] == 8 and monotone,
          f"[13] frontier: {len(front)} points, monotone {monotone}")
    mid = TRAFFIC_SLOS[len(TRAFFIC_SLOS) // 2]
    by = dict(zip(metas, res))
    gs = [float(np.mean([by[(mid, g, s)].req_gco2
                         / max(by[(mid, g, s)].req_served, 1)
                         for s in TRAFFIC_SEEDS])) for g in TRAFFIC_GAMMAS]
    saving = 100.0 * (1.0 - gs[-1] / gs[0])
    check(abs(saving - bench["greenness_saving_pct"]) <= 0.01
          and all(b <= a * (1.0 + 1e-9) for a, b in zip(gs, gs[1:])),
          f"[13] greenness saving at SLO {mid}: {saving:.4f} % vs "
          f"{bench['greenness_saving_pct']:.4f} %")
    # the middle SLO's seed-1 lanes against their own host loops
    t0 = time.perf_counter()
    hosts = [(i, S.simulate_fleet(*runs[i][:4], jobs=runs[i][4]))
             for i, m in enumerate(metas)
             if m[0] == mid and m[2] == TRAFFIC_SEEDS[0]]
    host_ms = (time.perf_counter() - t0) * 1e3 / (T * len(hosts))
    for i, hr in hosts:
        check(_same_run(res[i], hr) and _requests(res[i]) == _requests(hr)
              and _digest(res[i]) == _digest(hr)
              and abs(res[i].req_gco2 / hr.req_gco2 - 1) <= 1e-4,
              f"[13] grid lane {metas[i]} != its host loop")
    short = [sp[:3] + (dataclasses.replace(sp[3], epochs=4),
                       S.generate_jobs(dataclasses.replace(sp[3], epochs=4)))
             for sp in runs]
    _, dev_ms, prof_ms, prof_top = device_busy(
        lambda: S.simulate_fleet_ensemble(short), top=6)
    say(f"[13] (b) grid {len(runs)} lanes (SLO {TRAFFIC_SLOS} x γ "
        f"{TRAFFIC_GAMMAS} x seeds {TRAFFIC_SEEDS}) x n={n} x {T} epochs, "
        f"one bucket: {grid_ms:.1f} ms/epoch wall, profiled device time "
        + ("not measured" if dev_ms is None else f"{dev_ms / 4:.3f} ms")
        + f" per epoch (4 epochs {busy_note(dev_ms, prof_ms)}), "
        f"{res[0].host_syncs / T:.2f} host syncs/epoch, launches {cnt}; "
        f"every lane == the bench's record (worst g/req rel {worst[0]:.3g}, "
        f"p99 rel {worst[1]:.3g}); {len(hosts)} host loops {host_ms:.1f} "
        f"ms/epoch each, == their lanes")
    say(f"[13] (b) 4 profiled epochs: {prof_top}")
    say(f"[13] (b) frontier ({len(front)} points): " + json.dumps(
        [{k: p[k] for k in ("policy", "req_p99_s", "g_per_req",
                            "miss_rate")} for p in front]))
    say(f"[13] (b) greenness at SLO {mid}: g/req {gs}, saving "
        f"{saving:.4f} % (bench {bench['greenness_saving_pct']:.4f} %)")

    # ---- (c) the router on phase 9's fleet-scale lanes ------------------
    cfg9, runs9, ens_off = ens9
    specs = [sp for _, _, sp in runs9]
    on = [sp[:3] + (dataclasses.replace(sp[3], traffic=tc),
                    S.generate_jobs(dataclasses.replace(sp[3], traffic=tc)))
          for sp in specs]
    T9 = cfg9.epochs
    S.simulate_fleet_ensemble(
        [sp[:3] + (dataclasses.replace(sp[3], epochs=2),
                   S.generate_jobs(dataclasses.replace(sp[3], epochs=2)))
         for sp in on])                                        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = S.simulate_fleet_ensemble(specs)
    torch.cuda.synchronize()
    off_ms = (time.perf_counter() - t0) * 1e3 / T9
    t0 = time.perf_counter()
    res_on, cnt = counted(lambda: S.simulate_fleet_ensemble(on))
    on_ms = (time.perf_counter() - t0) * 1e3 / T9
    add(cnt)
    for (name, seed, _), a, b, c in zip(runs9, res_on, ens_off, off):
        check(_same_run(a, b, 0.0) and _same_run(c, b, 0.0)
              and a.emissions_g == b.emissions_g,
              f"[13] fleet lane ({name}, seed {seed}) with traffic != "
              "phase 9's lane")
        check(a.req_served > 0, f"[13] fleet lane ({name}, seed {seed}) "
              "served nothing")
    h0 = S.simulate_fleet(*on[0][:4], jobs=on[0][4])
    check(_requests(h0) == _requests(res_on[0])
          and abs(res_on[0].req_gco2 / h0.req_gco2 - 1) <= 1e-4
          and abs(res_on[0].req_p99_s / h0.req_p99_s - 1) <= 1e-3,
          f"[13] fleet lane 0: requests {_requests(res_on[0])} != its host "
          f"loop's {_requests(h0)}")
    short_on = [sp[:3] + (dataclasses.replace(sp[3], epochs=4),
                          S.generate_jobs(dataclasses.replace(sp[3],
                                                              epochs=4)))
                for sp in on]
    short_off = [sp[:3] + (dataclasses.replace(sp[3], traffic=None),
                           sp[4]) for sp in short_on]
    ops_off, dms_off = device_ops(
        lambda: S.simulate_fleet_ensemble(short_off))
    ops_on, dms_on = device_ops(lambda: S.simulate_fleet_ensemble(short_on))
    ops_note = ("not measured" if ops_on is None or ops_off is None else
                f"{ops_off / 4:.1f} -> {ops_on / 4:.1f} device ops/epoch "
                f"(+{(ops_on - ops_off) / 4:.1f}), device "
                f"{dms_off / 4:.3f} -> {dms_on / 4:.3f} ms/epoch")
    say(f"[13] (c) phase 9's {len(on)} lanes x n={SIM_N} x {T9} epochs "
        f"with the router: placements and traffic-free counters == phase "
        f"9's, lane 0's requests == its host loop ({_requests(h0)}); "
        f"traffic off {off_ms:.1f} -> on {on_ms:.1f} ms/epoch wall "
        f"(+{on_ms - off_ms:.1f}), {ops_note}; host syncs/epoch "
        f"{off[0].host_syncs / T9:.2f} off, {res_on[0].host_syncs / T9:.2f}"
        f" on; launches {cnt}")
    router_cost(dev, len(on), max(
        S._prepare_scan_run(*sp[:4], sp[4], pad_plan=True).plan.slots
        for sp in on))
    say(f"[13] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return total


def router_cost(dev, L, slots, reps=20):
    """Step 5b's two parts alone on (L, slots) seeded slot tables: one
    ``route_epoch_batched`` call and ``modeled_p99`` unrolled to 64 and 32
    chips (synchronized wall ms per call and device ops per call)."""
    import torch
    from repro_torch.core import router as R
    g = np.random.default_rng(0)

    def t(lo, hi, dtype=np.int32):
        return torch.from_numpy(g.integers(lo, hi, (L, slots)).astype(
            dtype)).to(dev)
    args = dict(req_t=torch.full((L,), 20000, dtype=torch.int32,
                                 device=dev),
                svc=t(-1, 4), jid=t(0, 1 << 20),
                weight=t(1, 5), cap=t(0, 3000),
                carbon=t(100, 900, np.float32), n_svc=4,
                greenness=torch.full((L,), 0.75, device=dev))
    routed, _ = R.route_epoch_batched(**args)
    chips = t(8, 33)
    mu = torch.full((L, 1), 0.1, device=dev)
    parts = {"route_epoch_batched": lambda: R.route_epoch_batched(**args),
             "modeled_p99 to 64": lambda: R.modeled_p99(torch, routed, chips,
                                                        64, mu),
             "modeled_p99 to 32": lambda: R.modeled_p99(torch, routed, chips,
                                                        32, mu)}
    out = []
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        ops, _ = device_ops(fn)
        out.append(f"{name} {ms:.3f} ms, {ops} device ops")
    say(f"[13] (c) step 5b's parts alone at {L} lanes x {slots} slots: "
        + "; ".join(out))


def _allclose_err(got, want, bar):
    """(max |got - want|, whether |got - want| <= bar + bar * |want|
    everywhere): the JAX suite's ``assert_allclose(atol=bar, rtol=bar)``."""
    import torch
    g, w = got.detach().float(), want.detach().float()
    d = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((d <= bar + bar * w.abs())
                                                 .all())
    return float(d.max()), ok


def _k5_bound(B, H, K, S, hd, window, dtype, rates, fp32_pipes=False):
    """``kernels.flash_attention.k5_cost``'s operations and bytes (q and
    o (B, H, S, hd), k and v (B, K, S, hd), each moved once; the two
    products over the live (row, key) pairs) on the tensor cores: at the
    dense bf16 rate for bf16 inputs, and for f32 three times over at the
    dense TF32 rate (3xTF32, the least tensor work that keeps f32
    accuracy).  ``fp32_pipes``: the f32 products once at the f32 rate
    outside the tensor cores instead (the route's FMA kernel), printed
    beside the bound."""
    import torch
    from repro_torch.kernels.flash_attention import k5_cost
    ops, nbytes = k5_cost(B, H, K, S, hd, window, dtype)
    if dtype == torch.bfloat16:
        return bound_ms(nbytes, ops, rates, rates[2])
    if fp32_pipes:
        return bound_ms(nbytes, ops, rates)
    return bound_ms(nbytes, 3 * ops, rates, rates[3])


def _k6_bound(B, S, D, N, dtype, rates, heads=None):
    """``kernels.selective_scan.k6_cost``'s operations and bytes (x and y
    (B, S, D), B and C (B, S, N), dt (B, S, D) and A (D, N), or in the
    per-head form (``heads`` H) dt (B, S, H) and A (H,), and the final
    state (B, D, N) moved once; per (b, t, d, n) 5 FLOPs) on the f32
    pipes.  The (D, N) form's one exp per (b, t, d, n) is left out: the
    SFU alone would take about as long as the bytes, but a share of the
    exps can run as polynomial code on the f32 pipes beside it, so the two
    together stay under the bytes.  The per-head form takes one exp per
    (b, t, head)."""
    from repro_torch.kernels.selective_scan import k6_cost
    ops, nbytes = k6_cost(B, S, D, N, dtype, heads)
    return bound_ms(nbytes, ops, rates)


def _sdpa_ms(q, k, v, flush):
    """Time of one ``scaled_dot_product_attention`` call on the same
    inputs, with the first backend that takes them, in the order flash,
    memory-efficient, cuDNN, math; GQA through ``enable_gqa``, or with k/v
    expanded to the q heads beforehand where a backend refuses it.
    Returns (ms, the backend's name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[1] // k.shape[1]
    wide = (k.repeat_interleave(G, 1), v.repeat_interleave(G, 1))
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for gqa in (True, False):
            kk, vv = (k, v) if gqa else wide
            try:
                with sdpa_kernel([backend]):
                    F.scaled_dot_product_attention(q, kk, vv, is_causal=True,
                                                   enable_gqa=gqa)
                    ms = time_ms(lambda: F.scaled_dot_product_attention(
                        q, kk, vv, is_causal=True, enable_gqa=gqa), flush)
            except (RuntimeError, TypeError):
                continue
            return ms, backend.name + ("" if gqa else
                                       " (k/v expanded to the q heads)")
    return None, "none"


def phase_model_kernels(dev, rates, sfu, flush):
    """K5/K6 vs their plain versions at the serving path's shapes, at
    ragged ones and at S 2048, f32 and bf16; times at the path's
    shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention,
                                                     variant)
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_plain)
    g = torch.Generator(device=dev).manual_seed(10)
    err = {k: [0.0, 0] for k in ("flash_attention", "flash_attention_f32",
                                 "selective_scan",
                                 "selective_scan_per_channel")}
    times = {}
    gr, fm = get_config("granite-3-2b"), get_config("falcon-mamba-7b")
    # (B, H, K, S, hd, window): granite's prefill, a ragged band with
    # danube's head dim, hd 150 (rows no 16-byte multiple: bf16 on the
    # element-wise mma kernel, kept out of the path's kernel entry), and
    # granite's heads at S 2048
    k5_path = (SERVE_SLOTS, gr.n_heads, gr.n_kv_heads, SERVE_PROMPT,
               gr.head_dim, 0)
    for shape in (k5_path, (2, 6, 3, 77, 120, 30), (2, 4, 1, 260, 150, 70),
                  (1, gr.n_heads, gr.n_kv_heads, 2048, gr.head_dim, 0)):
        B, H, K, S, hd, win = shape
        for dt in (torch.bfloat16, torch.float32):
            name = ("flash_attention" if dt == torch.bfloat16
                    else "flash_attention_f32")
            q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dt)
            k = torch.randn(B, K, S, hd, generator=g, device=dev).to(dt)
            v = torch.randn(B, K, S, hd, generator=g, device=dev).to(dt)
            got = flash_attention(q, k, v, window=win)
            want = attention_plain(q, k, v, window=win)
            torch.cuda.synchronize()
            e, ok = _allclose_err(got, want, K5_BARS[str(dt)[6:]])
            if not variant(dt, hd).startswith("bf16-mma"):
                err[name][0] = max(err[name][0], e)
            say(f"[10] K5 {shape} {str(dt)[6:]} ({variant(dt, hd)}): max abs "
                f"err {e:.3g} (bar {K5_BARS[str(dt)[6:]]})")
            check(ok, f"K5 differs from its plain version at {shape} {dt}")
            del got, want
            if shape == k5_path:
                lib, backend = _sdpa_ms(q, k, v, flush)
                say(f"[10] SDPA yardstick for {str(dt)[6:]}: {backend}")
                if dt == torch.float32:
                    tb, tby = _k5_bound(*shape, dt, rates, fp32_pipes=True)
                    say(f"[10] flash_attention_f32 for the record: its FMAs "
                        f"on the f32 pipes alone are bound by "
                        f"{tb * 1e3:.2f} us ({tby})")
                times[name] = (
                    time_ms(lambda: flash_attention(q, k, v), flush),
                    time_ms(lambda: attention_plain(q, k, v), flush),
                    _k5_bound(*shape, dt, rates), lib)
    # (B, S, D, N, dt range): falcon's prefill, ragged S and D, and 2048
    # steps with long memory (dt ~ 0.005) and short memory (dt ~ 1)
    k6_path = (SERVE_SLOTS, SERVE_PROMPT, fm.d_inner, fm.ssm_state)
    for shape, (lo, hi) in ((k6_path, (0.01, 0.11)),
                            ((2, 37, 96, 16), (0.01, 0.11)),
                            ((1, 45, 200, 8), (0.01, 0.11)),
                            ((2, 2048, 1024, 16), (0.004, 0.006)),
                            ((2, 2048, 1000, 8), (0.5, 1.5))):
        B, S, D, N = shape
        for dt in (torch.float32, torch.bfloat16):
            d_t = (torch.rand(B, S, D, generator=g, device=dev) * (hi - lo)
                   + lo).to(dt)
            x = torch.randn(B, S, D, generator=g, device=dev).to(dt)
            b = torch.randn(B, S, N, generator=g, device=dev)
            c = torch.randn(B, S, N, generator=g, device=dev)
            a = -torch.exp(torch.randn(D, N, generator=g, device=dev) * 0.3)
            y, h = selective_scan(d_t, x, b, c, a)
            y_p, h_p = selective_scan_plain(d_t, x, b, c, a)
            torch.cuda.synchronize()
            bar = K6_BARS[str(dt)[6:]]
            ey, oky = _allclose_err(y, y_p, bar)
            eh, okh = _allclose_err(h, h_p, bar)
            err["selective_scan"][0] = max(err["selective_scan"][0], ey, eh)
            say(f"[10] K6 {shape} dt in [{lo}, {hi}] {str(dt)[6:]}: max abs "
                f"err y {ey:.3g}, h_S {eh:.3g} (bar {bar}); bitwise: y "
                f"{ulp_diff(y, y_p) == 0}, h_S {ulp_diff(h, h_p) == 0}")
            check(oky and okh, f"K6 differs from its plain version at "
                  f"{shape} {dt}")
            if shape == k6_path and dt == torch.float32:
                times["selective_scan"] = (
                    time_ms(lambda: selective_scan(d_t, x, b, c, a), flush),
                    time_ms(lambda: selective_scan_plain(d_t, x, b, c, a),
                            flush, reps=5, warm=1),
                    _k6_bound(*shape, dt, rates), None)
    _k5_phase15_shapes(dev, g, rates, flush, err)
    _k5_hd192(dev, g, rates, flush, err)
    times["selective_scan_per_channel"] = _k6_per_head(dev, g, rates, sfu,
                                                       flush, err)
    for k, (ms, plain, (bd, by), lib) in times.items():
        say(f"[10] {k} at the path's shape: kernel {ms * 1e3:.1f} us, "
            f"plain {plain * 1e3:.1f} us, bound {bd * 1e3:.2f} us ({by}), "
            f"{100 * bd / ms:.1f} % of the bound"
            + (f", SDPA {lib * 1e3:.1f} us" if lib is not None else ""))
    B, S, D, N = k6_path
    say(f"[10] selective_scan: its {B * S * D * N:.3g} exps on the SFU "
        f"alone would take {B * S * D * N / sfu * 1e6:.2f} us")
    return err, times


def _k5_hd192(dev, g, rates, flush, err):
    """K5 at nemotron-4-340b's head dim 192 with its 12:1 grouping (96
    heads over 8 kv heads, cut to 24 over 2), at S 512 and a ragged S,
    bf16 and f32, held to the bars of hd 64/128 and timed beside the
    bound, the plain version and SDPA."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention,
                                                     variant)
    nm = get_config("nemotron-4-340b")
    G = nm.n_heads // nm.n_kv_heads
    for S in (512, 333):
        shape = (2, 2 * G, 2, S, nm.head_dim, 0)
        B, H, K, _, hd, win = shape
        for dt in (torch.bfloat16, torch.float32):
            name = ("flash_attention" if dt == torch.bfloat16
                    else "flash_attention_f32")
            q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dt)
            k = torch.randn(B, K, S, hd, generator=g, device=dev).to(dt)
            v = torch.randn(B, K, S, hd, generator=g, device=dev).to(dt)
            got = flash_attention(q, k, v, window=win)
            want = attention_plain(q, k, v, window=win)
            torch.cuda.synchronize()
            bar = K5_BARS[str(dt)[6:]]
            e, ok = _allclose_err(got, want, bar)
            err[name][0] = max(err[name][0], e)
            check(ok, f"K5 at hd 192 differs from its plain version at "
                  f"{shape} {dt}")
            line = (f"[10] K5 hd 192 {shape} {str(dt)[6:]} "
                    f"({variant(dt, hd)}): max abs err {e:.3g} (bar {bar})")
            if S == 512:
                ms = time_ms(lambda: flash_attention(q, k, v), flush)
                plain = time_ms(lambda: attention_plain(q, k, v), flush)
                bd, by = _k5_bound(*shape, dt, rates)
                lib, backend = _sdpa_ms(q, k, v, flush)
                line += (f"; kernel {ms * 1e3:.1f} us, plain "
                         f"{plain * 1e3:.1f} us, bound {bd * 1e3:.2f} us "
                         f"({by}), {100 * bd / ms:.1f} % of the bound, SDPA "
                         + (f"{lib * 1e3:.1f} us ({backend})"
                            if lib is not None else "none"))
            say(line)
            del got, want


def _k5_phase15_shapes(dev, g, rates, flush, err):
    """K5 bf16 vs its plain version at phase 15's prefill shapes, timed
    beside the bound, the plain version and SDPA."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    for arch in PHASE15_ATTN:
        c = get_config(arch)
        shape = (SERVE_SLOTS, c.n_heads, c.n_kv_heads, SERVE_PROMPT,
                 c.head_dim, 0)
        B, H, K, S, hd, _ = shape
        q = torch.randn(B, H, S, hd, generator=g, device=dev).bfloat16()
        k = torch.randn(B, K, S, hd, generator=g, device=dev).bfloat16()
        v = torch.randn(B, K, S, hd, generator=g, device=dev).bfloat16()
        e, ok = _allclose_err(flash_attention(q, k, v),
                              attention_plain(q, k, v), K5_BARS["bfloat16"])
        err["flash_attention"][0] = max(err["flash_attention"][0], e)
        check(ok, f"K5 differs from its plain version at {arch}'s {shape}")
        ms = time_ms(lambda: flash_attention(q, k, v), flush)
        plain = time_ms(lambda: attention_plain(q, k, v), flush)
        bd, by = _k5_bound(*shape, torch.bfloat16, rates)
        lib, backend = _sdpa_ms(q, k, v, flush)
        say(f"[10] K5 bf16 at {arch}'s prefill {shape}: max abs err {e:.3g}"
            f" (bar {K5_BARS['bfloat16']}); kernel {ms * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, bound {bd * 1e3:.2f} us ({by}), "
            f"{100 * bd / ms:.1f} % of the bound, SDPA {backend} "
            f"{lib * 1e3:.1f} us")


def _k6_per_head(dev, g, rates, sfu, flush, err):
    """K6's per-head form (Mamba-2: dt (B, S, H), a (H,)) vs its plain
    version, bit for bit, at zamba2's prefill shape (B 4, S 512, H 64, P
    64, N 64), the reduced zamba2's heads (P 32, N 16), a D that ends in
    the middle of a tile with a ragged S, tiles holding parts of heads (P
    48), one head a channel (P 1) and 2048 steps with long and short
    memory, f32 and bf16; returns (ms, plain ms, bound, None) at the
    path's shape in f32, with the issue floor of its unfused arithmetic
    printed beside the bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_plain)
    z = get_config("zamba2-1.2b")
    zr = z.reduced()
    path = (SERVE_SLOTS, SERVE_PROMPT, z.d_inner // z.ssm_head_dim,
            z.ssm_head_dim, z.ssm_state)
    out = None
    # (B, S, H, P, N), dt range
    for shape, (lo, hi) in (
            (path, (0.001, 0.1)),
            ((2, 37, zr.d_inner // zr.ssm_head_dim, zr.ssm_head_dim,
              zr.ssm_state), (0.01, 0.11)),
            ((2, 37, 5, 24, 64), (0.01, 0.11)),
            ((1, 45, 96, 1, 16), (0.01, 0.11)),
            ((1, 2048, 130, 1, 64), (0.004, 0.006)),
            ((1, 2048, 4, 64, 64), (0.004, 0.006)),
            ((2, 2048, 3, 48, 64), (0.5, 1.5))):
        B, S, H, P, N = shape
        D = H * P
        for dt in (torch.float32, torch.bfloat16):
            d_t = (torch.rand(B, S, H, generator=g, device=dev) * (hi - lo)
                   + lo).to(dt)
            x = torch.randn(B, S, D, generator=g, device=dev).to(dt)
            b = torch.randn(B, S, N, generator=g, device=dev)
            c = torch.randn(B, S, N, generator=g, device=dev)
            a = -torch.exp(torch.randn(H, generator=g, device=dev) * 0.3)
            y, h = selective_scan(d_t, x, b, c, a)
            y_p, h_p = selective_scan_plain(d_t, x, b, c, a)
            torch.cuda.synchronize()
            bar = K6_BARS[str(dt)[6:]]
            ey, oky = _allclose_err(y, y_p, bar)
            eh, okh = _allclose_err(h, h_p, bar)
            rec = err["selective_scan_per_channel"]
            rec[0] = max(rec[0], ey, eh)
            uy, uh = ulp_diff(y, y_p), ulp_diff(h, h_p)
            say(f"[10] K6 per-head (B, S, H, P, N) {shape} dt in [{lo}, "
                f"{hi}] {str(dt)[6:]}: max abs err y {ey:.3g}, h_S "
                f"{eh:.3g} (bar {bar}); bitwise: y {uy == 0}, h_S "
                f"{uh == 0}")
            check(oky and okh, f"K6's per-head form differs from its "
                  f"plain version at {shape} {dt}")
            check(torch.equal(y, y_p) and torch.equal(h, h_p),
                  f"K6's per-head form is not bitwise its plain version at "
                  f"{shape} {dt}: y {uy}, h_S {uh} ulp apart")
            if shape == path and dt == torch.float32:
                out = (time_ms(lambda: selective_scan(d_t, x, b, c, a),
                               flush),
                       time_ms(lambda: selective_scan_plain(d_t, x, b, c, a),
                               flush, reps=5, warm=1),
                       _k6_bound(B, S, D, N, dt, rates, heads=H), None)
                # 5 unfused f32 instructions per state-step, issued at
                # 128 a clock per SM (8 times the SFU's 16)
                say(f"[10] selective_scan_per_channel: its "
                    f"{B * S * D * N:.3g} state-steps as 5 unfused f32 "
                    f"instructions each take at least "
                    f"{5 * B * S * D * N / (8 * sfu) * 1e6:.2f} us of issue "
                    f"at the max SM clock (the bitwise floor)")
    return out


def _bitwise(what, a, b):
    """Check ``a`` == ``b`` bit for bit; a difference names its first
    element and the count."""
    import torch
    if torch.equal(a, b):
        return
    diff = a != b
    n = int(diff.sum()) if a.shape == b.shape else -1
    at = (tuple(int(i) for i in torch.nonzero(diff)[0]) if n > 0 else ())
    first = (f"first at {at}: {float(a[at])!r} vs {float(b[at])!r}"
             if n > 0 else f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    check(False, f"{what}: captured and eager differ in {n} of "
          f"{a.numel()} values, {first}")


class _EagerStep:
    """An engine step run as the engine ran it before its steps were
    captured: the same call, no graph."""
    setup_s = captures = warmups = 0

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, params, inputs, state=None, **static):
        return self.fn(params, inputs, state, **static)


def _eager_engine(model, params, cache, dev):
    """A ``ServeEngine`` whose prefill and decode run eagerly: its
    ``generate`` is the engine's loop, sampling and per-step reads
    included, timed as the engine times its steps."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(model, params, max_seq=cache, batch_slots=SERVE_SLOTS,
                      device=dev)
    eng._prefill = _EagerStep(eng._prefill.fn)
    eng._decode = _EagerStep(eng._decode.fn)
    return eng


def _busy_share(dev_ms, step_ms):
    """The profiled step's device ms as a share of the unprofiled step's
    measured ms (the profiler's own wall time is mostly its start-up)."""
    if dev_ms is None:
        return "not measured (the profiler saw no device time)"
    return (f"device {dev_ms:.2f} ms = {100 * dev_ms / step_ms:.1f} % of "
            f"the unprofiled {step_ms:.2f} ms")


def _sync_ms(fn, reps=3):
    """Median host ms of ``fn()`` ended by a device synchronize."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _captured_vs_eager(tag, arch, model, params, cache, served, dec, dev):
    """The served engine's captured steps against the eager steps, on the
    first prompt batch ``serve`` drew (seed 0): (1) the engine's greedy
    tokens (``served``) == an eager engine's, whose decode ms/step and
    prefill ms are the eager times; (2) a captured prefill's logits and
    caches and ``GRAPH_DECODE`` captured decode steps' logits (and the
    caches after them) bitwise the eager steps' from the same caches;
    (3) the prefill alone, eager and replayed, 3 times each; (4) one
    eager decode step and one replayed, profiled, each step's device time
    against its measured ms (``dec``: the served engine's captured decode
    ms per step).  Returns (eager prefill ms, captured prefill ms), each
    the mean of (3)'s two medians, and the eager engine's decode ms per
    step.  (The engine's own prefill mean is over 2 calls, the first
    carrying any first use in the process of what follows the step.)"""
    import torch
    from repro_torch.serve.engine import ServeEngine
    prompts = np.random.default_rng(0).integers(
        2, model.cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT))
    eager = _eager_engine(model, params, cache, dev)
    toks = [r.tokens for r in eager.generate(prompts, SERVE_NEW)]
    check(toks == [r.tokens for r in served],
          f"{arch}: the engine's tokens differ from an eager engine's")
    t = eager.timings
    pre, e_dec = t["prefill_s"] * 1e3, t["decode_s"] / t["decode_steps"] * 1e3
    del eager
    eng = ServeEngine(model, params, max_seq=cache, batch_slots=SERVE_SLOTS,
                      device=dev)
    batch = {"tokens": torch.as_tensor(prompts, device=dev).long()}
    le, ce = model.prefill(params, batch, cache)
    lg, cg = eng.prefill(batch)
    _bitwise(f"{arch} prefill logits", le, lg)
    for i, (a, b) in enumerate(zip(_leaves(ce), _leaves(cg))):
        _bitwise(f"{arch} prefill cache leaf {i}", a, b)
    for i in range(GRAPH_DECODE):
        step = {"token": le.argmax(-1),
                "positions": torch.full((SERVE_SLOTS,), SERVE_PROMPT + i,
                                        dtype=torch.long, device=dev)}
        le, ce = model.decode_step(params, ce, step)
        lg, cg = eng.decode(cg, step)
        _bitwise(f"{arch} decode step {i} logits", le, lg)
    for i, (a, b) in enumerate(zip(_leaves(ce), _leaves(cg))):
        _bitwise(f"{arch} cache leaf {i} after {GRAPH_DECODE} decode steps",
                 a, b)
    p_ms = [_sync_ms(lambda: model.prefill(params, batch, cache)),
            _sync_ms(lambda: eng.prefill(batch)),
            _sync_ms(lambda: eng.prefill(batch)),
            _sync_ms(lambda: model.prefill(params, batch, cache))]
    _, e_dev, e_wall, e_summ = device_busy(
        lambda: model.decode_step(params, ce, step), top=5)
    _, g_dev, g_wall, g_summ = device_busy(lambda: eng.decode(cg, step),
                                           top=5)
    say(f"{tag} {arch}: the engine's {len(toks)} x {SERVE_NEW} tokens == "
        f"an eager engine's; the captured prefill's logits and caches and "
        f"{GRAPH_DECODE} captured decode steps' logits and caches == the "
        f"eager steps' bit for bit; eager engine: prefill {pre:.2f} ms, "
        f"decode {e_dec:.3f} ms per step; the prefill alone (median of 3, "
        f"synchronized; eager, captured, captured, eager): "
        f"{', '.join(f'{m:.2f}' for m in p_ms)} ms; pool of this engine's "
        f"two graphs {eng._pool.reserved / 2**20:.1f} MiB")
    say(f"{tag} {arch}: profiled eager decode step: "
        f"{_busy_share(e_dev, e_dec)}; {busy_note(e_dev, e_wall)}; {e_summ}")
    say(f"{tag} {arch}: profiled replayed decode step: "
        f"{_busy_share(g_dev, dec)}; {busy_note(g_dev, g_wall)}; {g_summ}")
    return (p_ms[0] + p_ms[3]) / 2, (p_ms[1] + p_ms[2]) / 2, e_dec


def _graph_note(out):
    """The serve engine's captures, their seconds and its pool."""
    return (f"{out['captures']} captures (one per step and signature) in "
            f"{out['capture_s']:.2f} s, {out['warmup_prefills']} warm-up "
            f"prefills, graph pool {out['pool_bytes'] / 2**20:.1f} MiB")


def phase_serving(dev, record):
    """Serve each full-width model through ``launch.serve.serve``; its
    prefill logits through the kernels == through the plain versions.
    ``record`` gets each model's prefill and decode cell for phase 16:
    the measured ms and the step counted on the card."""
    import torch
    from repro_torch._graphs import WARMUP
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import ModelFlags, build_model
    total = {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = build_model(cfg).init(generator=gen, device=dev)
        # a random head, so greedy tokens are not all 0 (the zero-init
        # head gives uniform logits)
        params["lm_head"] = (torch.randn(cfg.d_model, cfg.vocab,
                                         generator=gen, device=dev)
                             / math.sqrt(cfg.d_model)).to(torch.bfloat16)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in _leaves(params))
        say(f"[11] {arch}: {cfg.n_layers} layers, {n_par / 1e9:.3f} B "
            f"parameters drawn in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
        out, cnt = counted(lambda: serve(
            cfg, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
            max_new=SERVE_NEW, slots=SERVE_SLOTS, device=dev,
            params=params, log=lambda m: say(f"[11] {m.strip()}")))
        for k, v in cnt.items():
            total[k] = total.get(k, 0) + v
        kern = "flash_attention" if cfg.has_attention else "selective_scan"
        other = "selective_scan" if cfg.has_attention else "flash_attention"
        # the engine's captured prefill launches its kernel once a layer
        # on each replay, and on each eager warm-up before its capture
        check(out["captures"] == 2 and out["warmup_prefills"] == WARMUP,
              f"{arch}: {out['captures']} captures, "
              f"{out['warmup_prefills']} warm-ups; expected 2 and {WARMUP}")
        want = cfg.n_layers * (out["prefills"] + out["warmup_prefills"])
        check(cnt[kern] == want and cnt[other] == 0,
              f"{arch}: launches {cnt}, expected {kern} = {want}")
        check(out["requests"] == SERVE_REQUESTS and all(
            len(r.tokens) == SERVE_NEW and 0 <= min(r.tokens)
            and max(r.tokens) < cfg.vocab for r in out["results"]),
            f"{arch}: wrong results")
        check(len({t for r in out["results"] for t in r.tokens}) > 1,
              f"{arch}: every generated token is the same")
        cache = SERVE_PROMPT + SERVE_NEW + 8
        kmodel = build_model(cfg)
        pmodel = build_model(cfg, ModelFlags(use_kernel=False))
        # (parameters, prompt seed): the first batch's prompts as serve()
        # drew them (seed 0), another batch, and the first again with f32
        # parameters on both routes
        params32 = _tree_map(lambda t: t.float(), params)
        for p_dt, seed in (("bf16", 0), ("bf16", 1), ("f32", 0)):
            pr = params32 if p_dt == "f32" else params
            prompts = torch.as_tensor(np.random.default_rng(seed).integers(
                2, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT)), device=dev)
            (lk, caches, held), c = counted(
                lambda: _held_prefill(kmodel, pr, {"tokens": prompts},
                                      cache))
            if p_dt == "f32":
                # K5's f32 kernel: granite's prefill with f32 parameters
                total["flash_attention_f32"] = (
                    total.get("flash_attention_f32", 0)
                    + c["flash_attention_f32"])
            lp, _ = pmodel.prefill(pr, {"tokens": prompts}, cache)
            torch.cuda.synchronize()
            e_l, n_ok, n_held = held[kern]
            check(n_held == cfg.n_layers and n_ok == n_held,
                  f"{arch}: {n_held - n_ok} of {n_held} prefill {kern} "
                  f"launches differ from the plain version on their own "
                  f"inputs ({p_dt} parameters, prompts {seed})")
            scale = float(lp.abs().max())
            e = float((lk - lp).abs().max())
            bar = SERVE_F32_BAR if p_dt == "f32" else SERVE_BARS[arch]
            check(bool(torch.isfinite(lk).all()) and lk.shape == (
                SERVE_SLOTS, cfg.vocab), f"{arch}: prefill logits not finite")
            check(e <= bar * scale,
                  f"{arch}: kernel-route prefill logits differ from the "
                  f"plain route by {e} (max|logit| {scale}, {p_dt} "
                  f"parameters, prompts {seed})")
            say(f"[11] {arch}, {p_dt} parameters, prompts {seed}: each of "
                f"the {n_held} {kern} launches within its bar of the plain "
                f"version on that layer's inputs (max abs err {e_l:.4g}); "
                f"prefill logits kernel vs plain route max abs err {e:.4g} "
                f"= {e / scale:.3g} x max|logit| {scale:.4g} (bar {bar})")
            del lk, lp, caches
        del params32
        torch.cuda.empty_cache()
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            2, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT)), device=dev)
        _, dev_ms, prof_ms, summ = device_busy(
            lambda: kmodel.prefill(params, {"tokens": prompts}, cache),
            top=5)
        pre = out["prefill_s"] / out["prefills"] * 1e3
        dec = out["decode_s"] / out["decode_steps"] * 1e3
        say(f"[11] {arch}: pod {out['pod']}, {out['tokens']} tokens, "
            f"captured prefill {pre:.1f} ms per batch of {SERVE_SLOTS}x"
            f"{SERVE_PROMPT}, captured decode {dec:.2f} ms per step of "
            f"{SERVE_SLOTS} tokens ({dec / SERVE_SLOTS:.2f} ms/token), "
            f"{out['tok_per_s']:.1f} tok/s, {out['g_per_request']:.4f} "
            f"gCO2/request; launches {cnt[kern]} {kern}; {_graph_note(out)}"
            f"; profiled eager prefill: {busy_note(dev_ms, prof_ms)}; "
            f"{summ}")
        e_pre, g_pre, e_dec = _captured_vs_eager(
            "[11]", arch, kmodel, params, cache,
            out["results"][:SERVE_SLOTS], dec, dev)
        c_pre, c_dec = _count_serving(kmodel, params, prompts, cache)
        _roof_cell(record, f"{arch} prefill", cfg, kmodel, "prefill",
                   SERVE_PROMPT, SERVE_SLOTS, g_pre, cache_len=cache,
                   card=c_pre, eager=e_pre)
        _roof_cell(record, f"{arch} decode", cfg, kmodel, "decode", cache,
                   SERVE_SLOTS, dec, card=c_dec, eager=e_dec)
        del params, kmodel, pmodel
        torch.cuda.empty_cache()
    # counted() fails a main-path bf16 launch on the element-wise kernel
    say(f"[11] all {total['flash_attention']} bf16 K5 launches took the "
        f"TMA-fed wgmma kernel")
    return total


def phase_families(dev, record):
    """Phase 15: moonshot-v1-16b-a3b (MoE) and zamba2-1.2b (Mamba-2 and
    the tied attention block) served through ``launch.serve.serve`` at
    full width and depth, qwen2-vl-72b (patch embeddings, M-RoPE) at full
    width and 16 of 80 layers through ``Model.prefill`` /
    ``decode_step``, and the three reduced with f32 parameters card ==
    CPU.  Returns the launch counts; ``record`` gets the measured
    prefill and decode cells for phase 16."""
    import torch
    t0 = time.perf_counter()
    total = {}
    for part in ([lambda a=a: _serve_family(dev, a, record)
                  for a in FAMILY_SERVE]
                 + [lambda: _vlm_family(dev, record),
                    lambda: _families_card_equal_cpu(dev)]):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, cnt = counted(part)
        for k, v in cnt.items():
            total[k] = total.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"[15] peak device memory {peak:.2f} GiB; launches "
            f"{ {k: v for k, v in cnt.items() if v} }")
    check(total["flash_attention"] > 0
          and total["selective_scan_per_channel"] > 0,
          f"phase 15 did not launch K5 bf16 and K6 per-head: {total}")
    # counted() fails a main-path bf16 launch on the element-wise kernel
    say(f"[15] all {total['flash_attention']} bf16 K5 launches took the "
        f"TMA-fed wgmma kernel")
    say(f"[15] phase 15 took {time.perf_counter() - t0:.1f} s")
    return total


def _tokens_digest(results) -> str:
    """sha256 of the served requests' tokens (int64, in request order),
    first 16 hex digits: equal digests are equal served tokens."""
    import hashlib
    return hashlib.sha256(np.asarray([r.tokens for r in results],
                                     np.int64).tobytes()).hexdigest()[:16]


def _seeded_params(cfg, dev):
    """bf16 parameters from seed 0 and a random head (the zero-init head
    gives uniform logits); their count."""
    import torch
    from repro_torch.models.model import build_model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg).init(generator=gen, device=dev)
    params["lm_head"] = (torch.randn(cfg.d_model, cfg.vocab, generator=gen,
                                     device=dev)
                         / math.sqrt(cfg.d_model)).to(torch.bfloat16)
    torch.cuda.synchronize()
    return params, sum(t.numel() for t in _leaves(params))


def _routings(fn, pin=None):
    """``fn()`` with every MoE router's top-k ids recorded, in call
    order; returns (result, [top_e per call]).  With ``pin`` (such a
    list) each router takes the pinned ids instead of its own choice and
    weighs them with its own probabilities."""
    import torch
    from repro_torch.models import moe
    rec, route = [], moe.route
    pinned = iter(pin or ())

    def recording(cfg, p, x):
        probs, top_w, top_e = route(cfg, p, x)
        if pin is not None:
            top_e = next(pinned)
            top_w = torch.gather(probs, -1, top_e)
            top_w = top_w / torch.sum(top_w, -1, keepdim=True)
        rec.append(top_e)
        return probs, top_w, top_e

    moe.route = recording
    try:
        return fn(), rec
    finally:
        moe.route = route


def _serve_family(dev, arch, record):
    """(a) / (b): serve 8 requests at full width and depth, then hold the
    kernel route's prefill against the plain route's (and for zamba2 the
    SSD route's against the scan's)."""
    import torch
    from repro_torch._graphs import WARMUP
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.models.transformer import hybrid_groups
    tag = "(a)" if arch == FAMILY_SERVE[0] else "(b)"
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params, n_par = _seeded_params(cfg, dev)
    say(f"[15] {tag} {arch}: {cfg.n_layers} layers, {n_par / 1e9:.3f} B "
        f"parameters drawn in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    out, cnt = counted(lambda: serve(
        cfg, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
        max_new=SERVE_NEW, slots=SERVE_SLOTS, device=dev, params=params,
        log=lambda m: None))
    n_attn = (len(hybrid_groups(cfg)) if cfg.family == "hybrid"
              else cfg.n_layers)
    n_scan = cfg.n_layers if cfg.has_ssm else 0
    check(out["captures"] == 2 and out["warmup_prefills"] == WARMUP,
          f"{arch}: {out['captures']} captures, {out['warmup_prefills']} "
          f"warm-ups; expected 2 and {WARMUP}")
    # each replay of the captured prefill, and each warm-up before it
    runs = out["prefills"] + out["warmup_prefills"]
    want = {"flash_attention": n_attn * runs,
            "selective_scan_per_channel": n_scan * runs}
    check(all(cnt[k] == v for k, v in want.items())
          and sum(cnt.values()) == sum(want.values()),
          f"{arch}: launches {cnt}, expected {want}")
    check(out["requests"] == SERVE_REQUESTS and all(
        len(r.tokens) == SERVE_NEW and 0 <= min(r.tokens)
        and max(r.tokens) < cfg.vocab for r in out["results"]),
        f"{arch}: wrong results")
    check(len({t for r in out["results"] for t in r.tokens}) > 1,
          f"{arch}: every generated token is the same")
    pre = out["prefill_s"] / out["prefills"] * 1e3
    dec = out["decode_s"] / out["decode_steps"] * 1e3
    say(f"[15] {tag} {arch}: served tokens digest "
        f"{_tokens_digest(out['results'])} (sha256 of the requests' tokens "
        f"in order, first 16 hex digits)")
    say(f"[15] {tag} {arch}: pod {out['pod']}, {out['tokens']} tokens, "
        f"captured prefill {pre:.1f} ms per batch of {SERVE_SLOTS}x"
        f"{SERVE_PROMPT}, captured decode {dec:.2f} ms per step of "
        f"{SERVE_SLOTS} tokens, {out['tok_per_s']:.1f} tok/s, "
        f"{out['g_per_request']:.4f} gCO2/request; launches {want}; "
        f"{_graph_note(out)}")
    cache = SERVE_PROMPT + SERVE_NEW + 8
    kmodel = build_model(cfg)
    e_pre, g_pre, e_dec = _captured_vs_eager(
        f"[15] {tag}", arch, kmodel, params, cache,
        out["results"][:SERVE_SLOTS], dec, dev)
    _roof_cell(record, f"{arch} prefill", cfg, kmodel, "prefill",
               SERVE_PROMPT, SERVE_SLOTS, g_pre, cache_len=cache,
               eager=e_pre)
    _roof_cell(record, f"{arch} decode", cfg, kmodel, "decode", cache,
               SERVE_SLOTS, dec, eager=e_dec)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        2, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT)), device=dev)
    batch = {"tokens": prompts}
    pmodel = build_model(cfg, ModelFlags(use_kernel=False))
    ((lk, _, held), ek) = _routings(
        lambda: _held_prefill(kmodel, params, batch, cache))
    lp, ep = _routings(lambda: pmodel.prefill(params, batch, cache)[0])
    if cfg.is_moe:
        # a bf16 ulp of K5 in a router's input flips near-ties between
        # experts; the bar holds the plain route with the kernel route's
        # expert choices, the free plain route's gap is printed
        lp_free = lp
        lp, _ = _routings(lambda: pmodel.prefill(params, batch, cache)[0],
                          pin=ek)
    torch.cuda.synchronize()
    for name, (e_l, n_ok, n_held) in held.items():
        check(n_ok == n_held, f"{arch}: {n_held - n_ok} of {n_held} prefill "
              f"{name} launches differ from the plain version on their "
              f"own inputs")
        if n_held:
            say(f"[15] {tag} {arch}: each of the {n_held} {name} launches "
                f"of a prefill within its bar of the plain version on that "
                f"layer's inputs (max abs err {e_l:.4g})")
    scale = float(lp.abs().max())
    e = float((lk - lp).abs().max())
    bar = SERVE_BARS[arch]
    check(bool(torch.isfinite(lk).all()) and lk.shape == (
        SERVE_SLOTS, cfg.vocab), f"{arch}: prefill logits not finite")
    pinned = ""
    if cfg.is_moe:
        # a routing that differs between the routes: another top-k set
        n = sum(int((torch.sort(a, -1).values != torch.sort(b, -1).values)
                    .any(-1).sum()) for a, b in zip(ek, ep))
        total_r = sum(a.shape[0] * a.shape[1] for a in ek)
        ef = float((lk - lp_free).abs().max())
        say(f"[15] {tag} {arch}: with each route choosing its own experts, "
            f"{n} of {total_r} (layer, token) top-{cfg.top_k} sets differ "
            f"between the routes ({100 * n / total_r:.3f} %) and the "
            f"prefill logits by {ef:.4g} = {ef / scale:.3g} x max|logit|")
        pinned = ", the plain route on the kernel route's experts"
    say(f"[15] {tag} {arch}: prefill logits kernel vs plain route{pinned} "
        f"max abs err {e:.4g} = {e / scale:.3g} x max|logit| {scale:.4g} "
        f"(bar {bar})")
    check(e <= bar * scale, f"{arch}: kernel-route prefill logits differ "
          f"from the plain route by {e} (max|logit| {scale})")
    _, dev_ms, prof_ms, summ = device_busy(
        lambda: kmodel.prefill(params, batch, cache), top=5)
    say(f"[15] {tag} {arch}: profiled eager prefill: "
        f"{busy_note(dev_ms, prof_ms)}; {summ}")
    if cfg.has_ssm:
        ls, _ = build_model(cfg, ModelFlags(ssm_algo="ssd")).prefill(
            params, batch, cache)
        es = float((ls - lk).abs().max())
        say(f"[15] {tag} {arch}: SSD-route prefill logits vs the scan route "
            f"max abs err {es:.4g} = {es / scale:.3g} x max|logit| (bar "
            f"{bar})")
        check(bool(torch.isfinite(ls).all()) and es <= bar * scale,
              f"{arch}: SSD prefill logits differ from the scan route by "
              f"{es}")
    del params


def _vlm_family(dev, record):
    """(c): qwen2-vl-72b at full width, 16 of 80 layers: stub patch
    embeddings with M-RoPE ids, prefill, 32 decode steps, each eager and
    captured (the serving engine's steps with ``embed`` and
    ``rope_positions`` among the static inputs), the captured ones
    bitwise the eager ones; the prefill held kernel vs plain route, the
    last decode logits vs the training forward's at the same position."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import frontend
    from repro_torch.models import transformer as tr
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    params, n_par = _seeded_params(cfg, dev)
    say(f"[15] (c) {VLM_ARCH}: {cfg.n_layers} of 80 layers, {n_par / 1e9:.3f}"
        f" B parameters drawn in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    B, S = SERVE_SLOTS, SERVE_PROMPT + SERVE_NEW
    embeds = frontend.fake_patch_embeddings(cfg, B, S, device=dev)
    ids = frontend.mrope_position_ids(B, S, grid=VLM_GRID, device=dev)
    batch = {"embeds": embeds[:, :SERVE_PROMPT],
             "positions": ids[:, :SERVE_PROMPT]}
    cache = S + 8
    kmodel = build_model(cfg)
    eng = ServeEngine(kmodel, params, max_seq=cache, batch_slots=B,
                      device=dev)
    le, ce = kmodel.prefill(params, batch, cache)
    lg, cg = eng.prefill(batch)           # the capture and a first replay
    # the prefill alone, synchronized (median of 3; eager, captured,
    # captured, eager)
    p_ms = [_sync_ms(lambda: kmodel.prefill(params, batch, cache)),
            _sync_ms(lambda: eng.prefill(batch)),
            _sync_ms(lambda: eng.prefill(batch)),
            _sync_ms(lambda: kmodel.prefill(params, batch, cache))]
    pre, pre_g = (p_ms[0] + p_ms[3]) / 2, (p_ms[1] + p_ms[2]) / 2
    _bitwise(f"{VLM_ARCH} prefill logits", le, lg)
    for i, (a, b) in enumerate(zip(_leaves(ce), _leaves(cg))):
        _bitwise(f"{VLM_ARCH} prefill cache leaf {i}", a, b)
    lk, _, held = _held_prefill(kmodel, params, batch, cache)
    lp, _ = build_model(cfg, ModelFlags(use_kernel=False)).prefill(
        params, batch, cache)
    e_l, n_ok, n_held = held["flash_attention"]
    check(n_held == cfg.n_layers and n_ok == n_held,
          f"{VLM_ARCH}: {n_held - n_ok} of {n_held} prefill K5 launches "
          f"differ from the plain version on their own inputs")
    scale = float(lp.abs().max())
    e = float((lk - lp).abs().max())
    check(bool(torch.isfinite(lk).all()) and e <= SERVE_BARS[VLM_ARCH] * scale,
          f"{VLM_ARCH}: kernel-route prefill logits differ from the plain "
          f"route by {e} (max|logit| {scale})")
    steps = [{"embed": embeds[:, t],
              "positions": torch.full((B,), t, dtype=torch.long, device=dev),
              "rope_positions": ids[:, t]} for t in range(SERVE_PROMPT, S)]
    eager, captured = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in steps:
        logits, ce = kmodel.decode_step(params, ce, step)
        eager.append(logits.clone())
    torch.cuda.synchronize()
    dec = (time.perf_counter() - t0) * 1e3 / SERVE_NEW
    t0, s0 = time.perf_counter(), eng._decode.setup_s
    for step in steps:
        lg, cg = eng.decode(cg, step)
        captured.append(lg.clone())
    torch.cuda.synchronize()
    dec_g = ((time.perf_counter() - t0 - (eng._decode.setup_s - s0)) * 1e3
             / SERVE_NEW)
    for i, (a, b) in enumerate(zip(eager, captured)):
        _bitwise(f"{VLM_ARCH} decode step {i} logits", a, b)
    for i, (a, b) in enumerate(zip(_leaves(ce), _leaves(cg))):
        _bitwise(f"{VLM_ARCH} cache leaf {i} after {SERVE_NEW} decode steps",
                 a, b)
    logits = eager[-1]
    with torch.no_grad():
        x, pos = kmodel._inputs({"embeds": embeds, "positions": ids}, params)
        h, _ = tr.stack_apply(cfg, params["stack"], x, pos, remat="none")
        ref = kmodel._logits(params, h[:, -1:])[:, 0]
    ed = float((logits - ref).abs().max())
    rs = float(ref.abs().max())
    check(bool(torch.isfinite(logits).all())
          and ed <= SERVE_BARS[VLM_ARCH] * rs,
          f"{VLM_ARCH}: the last decode logits differ from the forward's by "
          f"{ed} (max|logit| {rs})")
    _, e_dev, e_wall, e_summ = device_busy(
        lambda: kmodel.decode_step(params, ce, steps[-1]), top=5)
    _, g_dev, g_wall, g_summ = device_busy(
        lambda: eng.decode(cg, steps[-1]), top=5)
    say(f"[15] (c) {VLM_ARCH}: each of the {n_held} K5 launches of the "
        f"prefill within its bar of the plain version on that layer's "
        f"inputs (max abs err {e_l:.4g}); prefill logits kernel vs plain "
        f"route max abs err {e:.4g} = {e / scale:.3g} x max|logit|; the "
        f"logits after {SERVE_NEW} decode steps vs the forward's at "
        f"position {S - 1}: {ed:.4g} = {ed / rs:.3g} x max|logit| {rs:.4g} "
        f"(bar {SERVE_BARS[VLM_ARCH]}); the captured prefill's logits and "
        f"caches and {SERVE_NEW} captured decode steps' logits and caches "
        f"== the eager steps' bit for bit; prefill {pre_g:.1f} ms captured, "
        f"{pre:.1f} ms eager, per batch of {B}x{SERVE_PROMPT}; decode "
        f"{dec_g:.2f} ms captured, {dec:.2f} ms eager, per step of {B} "
        f"tokens; {eng._prefill.captures + eng._decode.captures} captures "
        f"in {eng._prefill.setup_s + eng._decode.setup_s:.2f} s, graph "
        f"pool {eng._pool.reserved / 2**20:.1f} MiB")
    say(f"[15] (c) {VLM_ARCH}: profiled eager decode step: "
        f"{_busy_share(e_dev, dec)}; {busy_note(e_dev, e_wall)}; {e_summ}")
    say(f"[15] (c) {VLM_ARCH}: profiled replayed decode step: "
        f"{_busy_share(g_dev, dec_g)}; {busy_note(g_dev, g_wall)}; "
        f"{g_summ}")
    name = f"{VLM_ARCH} ({VLM_LAYERS} layers)"
    _roof_cell(record, f"{name} prefill", cfg, kmodel, "prefill",
               SERVE_PROMPT, B, pre_g, cache_len=cache, eager=pre)
    _roof_cell(record, f"{name} decode", cfg, kmodel, "decode", cache, B,
               dec_g, eager=dec)
    del params, ce, cg, eng


def _families_card_equal_cpu(dev):
    """(d): the reduced moonshot (capacity factor 16), zamba2 and
    qwen2-vl with f32 parameters: prefill and decode steps on the card ==
    on the CPU within ``SERVE_F32_BAR`` x max|logit|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import frontend
    from repro_torch.models.model import build_model
    B, S_pre, n_dec = FAMILY_PARITY_SHAPE
    S = S_pre + n_dec
    for arch, over in FAMILY_PARITY:
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        model = build_model(cfg)
        cpu = _tree_map(lambda t: t.float(), model.init(0, device="cpu"))
        cpu["lm_head"] = torch.from_numpy(np.random.default_rng(1)
                                          .standard_normal(
            (cfg.d_model, cfg.vocab)).astype(np.float32)
            / np.float32(math.sqrt(cfg.d_model)))
        if cfg.input_mode == "embeddings":
            full = {"embeds": frontend.fake_patch_embeddings(
                        cfg, B, S, device="cpu").float(),
                    "positions": frontend.mrope_position_ids(
                        B, S, grid=4, device="cpu")}
        else:
            full = {"tokens": torch.from_numpy(np.random.default_rng(7)
                                               .integers(0, cfg.vocab,
                                                         (B, S)))}
        gaps = []
        for where in ("cpu", dev):
            params = _tree_map(lambda t: t.to(where), cpu)
            b = {k: v[:, :S_pre].to(where) for k, v in full.items()}
            logits, caches = model.prefill(params, b, S)
            out = [logits.cpu()]
            for t in range(S_pre, S):
                step = {"positions": torch.full((B,), t, dtype=torch.long,
                                                device=where)}
                if cfg.input_mode == "embeddings":
                    step["embed"] = full["embeds"][:, t].to(where)
                    step["rope_positions"] = full["positions"][:, t].to(where)
                else:
                    step["token"] = full["tokens"][:, t].to(where)
                logits, caches = model.decode_step(params, caches, step)
                out.append(logits.cpu())
            gaps.append(torch.stack(out))
        scale = float(gaps[0].abs().max())
        e = float((gaps[1] - gaps[0]).abs().max())
        say(f"[15] (d) reduced {arch}, f32: prefill + {n_dec} decode steps "
            f"card vs CPU max abs err {e:.4g} = {e / scale:.3g} x "
            f"max|logit| {scale:.4g} (bar {SERVE_F32_BAR})")
        check(bool(torch.isfinite(gaps[1]).all())
              and e <= SERVE_F32_BAR * scale,
              f"reduced {arch}: card and CPU logits differ by {e}")


def _held_prefill(model, params, batch, cache):
    """``model.prefill`` with each K5 / K6 launch held against the plain
    version on that layer's own inputs (the JAX suite's bar for the
    output's dtype); returns (logits, caches, {kernel: [max abs err,
    launches within the bar, launches]})."""
    from repro_torch.models import attention, ssm
    held = {"flash_attention": [0.0, 0, 0], "selective_scan": [0.0, 0, 0]}

    def holding(op, name, bars):
        def run(*a, **kw):
            got = op(*a, **kw)
            want = op(*a, **{**kw, "use_kernel": False})
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            bar = bars[str(got[0].dtype)[6:]]
            errs = [_allclose_err(g, w, bar) for g, w in zip(got, want)]
            rec = held[name]
            rec[0] = max([rec[0]] + [e for e, _ in errs])
            rec[1] += all(ok for _, ok in errs)
            rec[2] += 1
            return got if len(got) > 1 else got[0]
        return run

    ops = (attention.flash_attention_op, ssm.selective_scan_op)
    attention.flash_attention_op = holding(ops[0], "flash_attention",
                                           K5_BARS)
    ssm.selective_scan_op = holding(ops[1], "selective_scan", K6_BARS)
    try:
        logits, caches = model.prefill(params, batch, cache)
    finally:
        attention.flash_attention_op, ssm.selective_scan_op = ops
    return logits, caches, held


def phase_training(dev, rates, record):
    """Phase 14: the training path at full width for every family
    (``TRAIN_FULL``), card == CPU at reduced size, the fault restart,
    two card runs bitwise; returns the launch counts (all 0: training
    runs no kernel) and (d)'s clean last loss.  ``record`` gets the
    full-width training cells for phase 16."""
    import torch
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the f32 card == CPU check needs them off")
    ((_, _, clean, _), cnt) = counted(lambda: (
        _train_full(dev, rates, record), _train_card_equals_cpu(dev),
        _train_fault_restart(dev), _train_deterministic(dev)))
    check(not any(cnt.values()),
          f"the training path launched a kernel: {cnt}")
    say(f"[14] (e) kernel launches during phase 14: {cnt} (none, as in "
        f"the reference: its training forward is plain jnp)")
    say(f"[14] phase 14 took {time.perf_counter() - t0:.1f} s")
    return cnt, clean


def _full_step(cfg, route, seq, steps):
    """The model and train step of a full-width run: the launcher's
    (``make_step``), or for ``"ssd"`` the same AdamW with the optimized
    train cell's SSD flags (``launch.settings``: SSD chunks of 128)."""
    from repro_torch.launch.train import make_step
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step
    if route != "ssd":
        return make_step(cfg, seq=seq, steps=steps, lr=3e-4)
    model = build_model(cfg, ModelFlags(attn_chunk=min(512, seq),
                                        ssm_chunk=128, ssm_algo="ssd"))
    return model, make_train_step(model, AdamWConfig(
        lr_peak=3e-4, warmup_steps=max(2, steps // 10), total_steps=steps))


def _full_batch(cfg, route, batch, seq, step, dev):
    """Step ``step``'s batch: the launcher's pipeline (seed 0), or for a
    VLM ``_vlm_batch``'s."""
    from repro_torch.data.pipeline import DataConfig, PipelineState
    from repro_torch.data.pipeline import device_batch
    if route != "vlm":
        return device_batch(DataConfig(cfg, batch, seq, seed=0),
                            PipelineState(0, step), dev)[1]
    return _vlm_batch(cfg, batch, seq, step, TRAIN_VLM_GRID, dev)


def _vlm_batch(cfg, batch, seq, step, grid, dev, dtype=None):
    """A VLM's training batch for step ``step``: the stub frontend's patch
    embeddings (seed ``step``; cast to ``dtype`` if given) with its M-RoPE
    ids on a ``grid`` x ``grid`` image, as both packages' frontends make
    them, and labels drawn by numpy (seed ``step``), the same on every
    device."""
    import torch
    from repro_torch.models import frontend
    emb = frontend.fake_patch_embeddings(cfg, batch, seq, seed=step,
                                         device=dev)
    labels = np.random.default_rng(step).integers(0, cfg.vocab, (batch, seq))
    return {"embeds": emb if dtype is None else emb.to(dtype),
            "positions": frontend.mrope_position_ids(batch, seq, grid=grid,
                                                     device=dev),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(dev)}


def _train_direct(cfg, route, batch, seq, steps, dev, log):
    """``train_loop``'s steps (parameters from seed 0, a batch a step, the
    loss and grad norm read back each step) for the routes ``train_loop``
    does not build (``TRAIN_FULL``)."""
    from repro_torch.launch.train import TrainRun
    from repro_torch.train.train_step import TrainState
    model, step_fn = _full_step(cfg, route, seq, steps)
    state = TrainState.create(model.init(0, device=dev))
    losses, gnorms, step_s = [], [], []
    for s in range(steps):
        t0 = time.monotonic()
        state, met = step_fn(state, _full_batch(cfg, route, batch, seq, s,
                                                dev))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        step_s.append(time.monotonic() - t0)
        log(f"step {s:5d} loss {losses[-1]:.4f} gnorm {gnorms[-1]:.3f}")
    return TrainRun(losses=losses, steps_done=steps, restarts=0,
                    migrations=0, final_state=state, grad_norms=gnorms,
                    step_s=step_s)


def _active_elements(cfg, n_par):
    """The parameter elements a token's step uses: all of them, but for an
    MoE only top_k of each layer's n_experts experts' weights."""
    if not cfg.is_moe:
        return n_par
    one = (3 if cfg.mlp == "swiglu" else 2) * cfg.d_model * cfg.d_ff
    return n_par - cfg.n_layers * (cfg.n_experts - cfg.top_k) * one


def _train_full(dev, rates, record):
    """(a) granite-3-2b at full width and depth; (b) the rest of
    ``TRAIN_FULL``: falcon-mamba-7b at 8 of 64 layers, zamba2-1.2b at full
    width and depth through both Mamba-2 routes, moonshot-v1-16b-a3b and
    qwen2-vl-72b at full width with their depth cut; (a)'s step once more
    under the step-cost counter for phase 16.  The caching allocator maps
    its segments on demand meanwhile (``expandable_segments``): qwen2-vl's
    2 layers peak at 69.4 GiB of 79.2, and with fixed segments AdamW's f32
    temporaries of its 1.25 B-element table leaves found no free block."""
    import torch
    torch.cuda.empty_cache()
    _expandable_segments(True)
    try:
        for run_spec in TRAIN_FULL:
            _train_full_run(dev, rates, record, run_spec)
    finally:
        torch.cuda.empty_cache()
        _expandable_segments(False)


def _expandable_segments(on):
    """The caching allocator's ``expandable_segments`` setting, for the
    allocations made from now on (torch 2.11 moved the setter)."""
    import torch
    setter = (getattr(torch._C, "_accelerator_setAllocatorSettings", None)
              or torch.cuda.memory._set_allocator_settings)
    setter(f"expandable_segments:{on}")


def _train_full_run(dev, rates, record, run_spec):
    """One ``TRAIN_FULL`` run, its checks and its roofline cell."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    total = torch.cuda.get_device_properties(0).total_memory
    arch, layers, batch, seq, steps, route, profiled = run_spec
    part = "a" if run_spec == TRAIN_FULL[0] else "b"
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    tag = (f"{arch} {'ssd' if route == 'ssd' else 'scan'}"
           if cfg.ssm_variant == "mamba2" else arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()

    def log(m, tag=tag, part=part):
        say(f"[14] ({part}) {tag}: {m}")
    if route == "loop":
        run = train_loop(cfg, reduced=False, steps=steps, batch=batch,
                         seq=seq, device=dev, seed=0, log_every=1,
                         log=log)
    else:
        run = _train_direct(cfg, route, batch, seq, steps, dev, log)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_par = sum(t.numel() for t in _leaves(run.final_state.params))
    n_act = _active_elements(cfg, n_par)
    ln_v = want = math.log(cfg.vocab)
    model, step_fn = _full_step(cfg, route, seq, steps)
    if cfg.is_moe:
        # the zero head's cross-entropy, plus 0.01 x the routers' aux
        # loss: the same forward at the initial parameters gives it
        with torch.no_grad():
            _, m0 = model.loss(model.init(0, device=dev),
                               _full_batch(cfg, route, batch, seq, 0,
                                           dev))
        want = ln_v + 0.01 * float(m0["aux"])
        check(abs(float(m0["ce"]) - ln_v) <= 1e-3,
              f"{tag}: step-0 cross-entropy {float(m0['ce'])} is not "
              f"ln V {ln_v}")
    check(abs(run.losses[0] - want) <= 1e-3,
          f"{tag}: step-0 loss {run.losses[0]} is not ln V {ln_v}"
          + (f" + 0.01 x aux = {want}" if cfg.is_moe else ""))
    check(all(math.isfinite(x) for x in run.losses + run.grad_norms),
          f"{tag}: a loss or grad norm is not finite: {run.losses} "
          f"{run.grad_norms}")
    check(run.steps_done == steps == len(run.losses),
          f"{tag}: {run.steps_done} of {steps} steps")
    ms = statistics.median(run.step_s[1:]) * 1e3
    tok = batch * seq
    mfu = 6 * n_act * tok / (ms / 1e3) / rates[2]
    cut = "" if layers == full.n_layers else \
        f" (depth cut from {full.n_layers})"
    active = ("" if n_act == n_par else
              f" ({n_act / 1e9:.3f} B active a token)")
    how = {"loop": "train_loop", "ssd": "make_train_step, SSD flags",
           "vlm": "make_train_step on the frontend's batches"}[route]
    say(f"[14] ({part}) {tag} ({how}): {layers} layers{cut}, "
        f"{n_par / 1e9:.3f} B parameters{active}, batch {batch} x seq "
        f"{seq}, {steps} steps in {wall:.1f} s (step 0 "
        f"{run.step_s[0] * 1e3:.1f} ms); {ms:.1f} ms/step (median of "
        f"steps 1-{steps - 1}), {tok / (ms / 1e3):.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB of {total / 2**30:.2f} "
        f"({(total - peak) / 2**30:.2f} GiB free), model-FLOP share "
        f"{100 * mfu:.2f} % of the bf16 peak; losses "
        f"{', '.join(f'{x:.4f}' for x in run.losses)} (step 0: ln V "
        f"{ln_v:.4f}" + (f" + 0.01 x aux = {want:.4f}" if cfg.is_moe
                         else "") + "); grad norms "
        f"{', '.join(f'{x:.3f}' for x in run.grad_norms)}")
    # one more step of the run's program, profiled
    b = _full_batch(cfg, route, batch, seq, steps, dev)
    state = run.final_state
    del run
    t_chk = time.perf_counter()
    _first_moments_reached(tag, cfg, state)
    params = state.params
    if not (profiled or part == "a"):
        # the checks below read the parameters only: the moments go
        state = None
    _train_full_forward(part, tag, arch, cfg, model, params, b, dev)
    del params
    t_prof = time.perf_counter()
    if profiled:
        # the step's result (a training state) is dropped at once:
        # held, it would sit beside the next run's
        _, dev_ms, prof_ms, summ = device_busy(
            lambda: step_fn(state, b), top=5)
        del _
        ratio = ("not measured" if dev_ms is None else
                 f"{dev_ms:.2f} / {ms:.1f} ms = "
                 f"{100 * dev_ms / ms:.1f} %")
        say(f"[14] ({part}) {tag}: profiled step: "
            f"{busy_note(dev_ms, prof_ms)}; device ms of the profiled "
            f"step / median ms of the unprofiled steps: {ratio}; {summ}")
    t_prof, t_chk = time.perf_counter() - t_prof, t_prof - t_chk
    card = None
    if part == "a":
        from repro_torch.launch.step_cost import count_step
        _, card = count_step(lambda: step_fn(state, b), state.params,
                             state.opt, state.step, b)
        del _
        torch.cuda.synchronize()
    name = tag if layers == full.n_layers else f"{tag} ({layers} layers)"
    # phase 16 holds this share against its mfu, which counts
    # active_param_count(): the hybrid's leaves out tensors (ROADMAP
    # Queue 3), so zamba2's share is printed here only
    share = None if cfg.family == "hybrid" else mfu
    _roof_cell(record, f"{name} train", cfg, model, "train", seq, batch,
               ms, card=card, share=share)
    del state, step_fn, b, model
    torch.cuda.empty_cache()
    say(f"[14] ({part}) {tag}: {time.perf_counter() - t0:.1f} s in all "
        f"(the steps {wall:.1f} s, the body's checks {t_chk:.1f} s, "
        + (f"the profiled step {t_prof:.1f} s)" if profiled
           else "not profiled)"))


def _unused_leaves(cfg):
    """The top-level parameters the loss never reads: a model fed
    embeddings (qwen2-vl) skips its token table."""
    return {"embed"} if cfg.input_mode == "embeddings" else set()


def _first_moments_reached(tag, cfg, state):
    """(a) / (b): the zero head makes the run's losses ln V whatever the
    body computes, so every non-head leaf the loss reads has a non-zero
    first moment after the run (the body's gradients reached it)."""
    unused = _unused_leaves(cfg)
    still = [k for k, v in state.opt["mu"].items()
             if k not in unused | {"lm_head"}
             and not all(float(t.abs().max()) > 0 for t in _leaves(v))]
    check(not still, f"{tag}: a leaf of {still} had no gradient in the "
          f"whole run")


def _train_full_forward(part, tag, arch, cfg, model, params, b, dev):
    """(a) / (b), the model body at full width: with a seeded head on the
    trained parameters, ``Model.loss`` is held
    against the cross-entropy of the serving forward's logits (plain
    route, all positions) on the same batch at the serving bar, and
    every gradient leaf is finite and non-zero; with the same parameters
    in f32, the training forward's logits are held against the serving
    forward's at the f32 serving bar (the bf16 routes differ by design:
    the training forward rounds the softmax weights to bf16 before P.V,
    as the reference does).  A model fed embeddings (qwen2-vl) never reads
    its token table: that leaf is left out."""
    import torch
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import softmax_xent
    from repro_torch.train.train_step import make_grad_fn
    unused = _unused_leaves(cfg)
    params = dict(params)
    head = params["lm_head"]
    gen = torch.Generator(device=dev).manual_seed(1)
    params["lm_head"] = (torch.randn(head.shape, generator=gen, device=dev)
                         / math.sqrt(cfg.d_model)).to(head.dtype)
    grads, met = make_grad_fn(model)(params, b)
    loss = float(met["loss"])
    g_max = [float(g.abs().max()) for k, v in grads.items()
             if k not in unused for g in _leaves(v)]
    del grads
    check(all(math.isfinite(g) and g > 0 for g in g_max),
          f"{tag}: seeded head: a gradient leaf is zero or not finite "
          f"(max|g| per leaf {g_max})")
    with torch.no_grad():
        xent = float(softmax_xent(_serving_logits(model, params, b),
                                  b["labels"]))
    bar = SERVE_BARS[arch]
    l_rel = abs(loss / xent - 1)
    check(l_rel <= bar, f"{tag}: seeded head: Model.loss {loss} vs "
          f"serving-route cross-entropy {xent} (rel {l_rel}, bar {bar})")
    # the same parameters in f32 (but the unused): the training forward's
    # logits against the serving route's at the f32 serving bar
    params = {k: _tree_map(lambda t: t.float(), v)
              for k, v in params.items() if k not in unused}
    b = {k: (v.float() if v.is_floating_point() else v) for k, v in b.items()}
    fl = model.flags
    with torch.no_grad():
        x, pos = model._inputs(b, params)
        h, _ = tr.stack_apply(cfg, params["stack"], x, pos, remat="none",
                              attn_chunk=fl.attn_chunk,
                              ssm_chunk=fl.ssm_chunk, ssm_algo=fl.ssm_algo)
        lt = model._logits(params, h)
        del h, x, pos
        ls = _serving_logits(model, params, b)
        scale = float(ls.abs().max())
        e = float((lt - ls).abs().max())
        finite = bool(torch.isfinite(lt).all())
    del lt, ls, params
    check(finite and e <= SERVE_F32_BAR * scale,
          f"{tag}: f32 training vs serving logits max abs err {e} "
          f"(max|logit| {scale}, bar {SERVE_F32_BAR})")
    left = f" (but the unused {sorted(unused)})" if unused else ""
    say(f"[14] ({part}) {tag}: every non-head leaf's first moment "
        f"non-zero after the run{left}; seeded head: Model.loss {loss:.5f} "
        f"vs softmax_xent of the serving route's logits {xent:.5f} (bf16, "
        f"rel {l_rel:.3g}, bar {bar}); {len(g_max)} gradient leaves, all "
        f"finite and non-zero (least max|g| {min(g_max):.3g}); f32 "
        f"training vs serving logits max abs err {e:.4g} = "
        f"{e / scale:.3g} x max|logit| {scale:.4g} (bar {SERVE_F32_BAR})")


def _serving_logits(model, params, b):
    """Logits at every position through the serving forward
    (``stack_prefill``, plain route: no kernel launch)."""
    from repro_torch.models import transformer as tr
    x, pos = model._inputs(b, params)
    h, _ = tr.stack_prefill(model.cfg, params["stack"], x, pos, x.shape[1],
                            use_kernel=False)
    return model._logits(params, h)


def _parity_case(entry, dtype):
    """A reduced ``TRAIN_PARITY`` entry: (tag, config, model, CPU
    parameters in ``dtype`` with a random head, its batch maker ``(state,
    device) -> (state, batch)``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, PipelineState
    from repro_torch.data.pipeline import device_batch
    from repro_torch.models.model import ModelFlags, build_model
    arch, over, fl = entry
    batch, seq, _ = TRAIN_PARITY_SHAPE
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    tag = f"{arch} {fl['ssm_algo']}" if "ssm_algo" in fl else arch
    model = build_model(cfg, ModelFlags(attn_chunk=32, ssm_chunk=16, **fl))
    gen = torch.Generator().manual_seed(0)
    params = model.init(generator=gen, device="cpu")
    if dtype == torch.float32:
        params = _tree_map(lambda t: t.float(), params)
    # a random head, so every leaf's gradient is non-zero at step 0
    params["lm_head"] = (torch.randn(cfg.d_model, cfg.vocab, generator=gen)
                         / math.sqrt(cfg.d_model)).to(dtype)
    dcfg = DataConfig(cfg, batch, seq, seed=0)

    def next_batch(ps, d):
        if cfg.input_mode != "embeddings":
            return device_batch(dcfg, ps, d)
        return PipelineState(ps.seed, ps.step + 1), _vlm_batch(
            cfg, batch, seq, ps.step, 4, d, dtype)
    return tag, cfg, model, params, next_batch


def _train_card_equals_cpu(dev):
    """(c) every ``TRAIN_PARITY`` family reduced, f32 parameters (the MoE
    families at capacity factor 16): train steps from one state on the
    card and on the CPU."""
    import torch
    from repro_torch.data.pipeline import PipelineState
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainState, make_grad_fn,
                                              make_train_step)
    _, _, steps = TRAIN_PARITY_SHAPE
    bar = TRAIN_PARITY_BAR
    for entry in TRAIN_PARITY:
        t0 = time.perf_counter()
        tag, cfg, model, params, next_batch = _parity_case(entry,
                                                           torch.float32)
        step_fn = make_train_step(model, AdamWConfig(
            lr_peak=3e-3, warmup_steps=1, total_steps=steps))
        runs = {}
        for d in ("cpu", dev):
            # a copy per device: the train step updates its state in place
            p = _tree_map(lambda t: t.to(d, copy=True), params)
            _, b0 = next_batch(PipelineState(0, 0), d)
            grads, _ = make_grad_fn(model)(p, b0)
            state, ps, losses = TrainState.create(p), PipelineState(0, 0), []
            for _ in range(steps):
                ps, b = next_batch(ps, d)
                state, met = step_fn(state, b)
                losses.append(float(met["loss"]))
            runs[str(d)] = (losses, _leaves(grads))
        (lc, gc), (lg, gg) = runs["cpu"], runs[str(dev)]
        l_err = max(abs(a / b - 1) for a, b in zip(lg, lc))
        # err <= bar x max|g| per leaf: a leaf zero on the CPU (one the
        # loss does not read) must be exactly zero on the card
        errs = [(float((a.cpu() - b).abs().max()), float(b.abs().max()))
                for a, b in zip(gg, gc)]
        g_err = max(e / m for e, m in errs if m > 0)
        check(l_err <= bar and all(e <= bar * m for e, m in errs),
              f"{tag}: card vs CPU losses rel {l_err}, step-0 grads "
              f"(max abs err, max|g|) per leaf {errs} (bar {bar})")
        say(f"[14] (c) {tag} reduced, f32: {steps} steps card vs CPU: "
            f"losses rel {l_err:.3g}, step-0 grads {g_err:.3g} x max|g| "
            f"(bar {bar}); losses {', '.join(f'{x:.5f}' for x in lg)}; "
            f"{time.perf_counter() - t0:.1f} s")


def _train_deterministic(dev):
    """(f) every ``TRAIN_PARITY`` family reduced, bf16 parameters: two
    card runs of ``make_grad_fn`` from one state give the same loss and
    gradients bit for bit, and a third run under
    ``torch.use_deterministic_algorithms`` (which raises on an op with no
    deterministic form, on the card the MoE's gathers and ``index_put_``s
    among them) gives them too."""
    import torch
    from repro_torch.data.pipeline import PipelineState
    from repro_torch.train.train_step import make_grad_fn
    t0 = time.perf_counter()
    tags = []
    for entry in TRAIN_PARITY:
        tag, cfg, model, params, next_batch = _parity_case(entry,
                                                           torch.bfloat16)
        p = _tree_map(lambda t: t.to(dev), params)
        _, b = next_batch(PipelineState(0, 0), dev)
        grad_fn = make_grad_fn(model)
        runs = [grad_fn(p, b), grad_fn(p, b)]
        torch.use_deterministic_algorithms(True)
        try:
            runs.append(grad_fn(p, b))
        finally:
            torch.use_deterministic_algorithms(False)
        (g0, m0) = runs[0]
        for g, m in runs[1:]:
            same = [bool(torch.equal(x, y))
                    for x, y in zip(_leaves(g0), _leaves(g))]
            check(all(same) and torch.equal(m["loss"], m0["loss"]),
                  f"(f) {tag}: gradients differ between card runs "
                  f"({same.count(False)} of {len(same)} leaves), loss "
                  f"{float(m0['loss'])} / {float(m['loss'])}")
        tags.append(f"{tag} ({len(_leaves(g0))} leaves)")
    say(f"[14] (f) two card runs of make_grad_fn from one state, and a "
        f"third under torch.use_deterministic_algorithms, give bitwise "
        f"equal losses and gradients (bf16 parameters, reduced): "
        f"{', '.join(tags)}; {time.perf_counter() - t0:.1f} s")


def _train_fault_restart(dev):
    """(d) tests/test_fault_tolerance.py:111-126 on the card; returns the
    clean run's last loss (phase 17 (d) holds its restart to it)."""
    import tempfile
    from repro_torch.launch.train import train_loop
    from repro_torch.train.fault_tolerance import FailureInjector
    common = dict(steps=16, batch=4, seq=32, reduced=True, task="copy",
                  ckpt_every=4, log_every=100, device=dev,
                  log=lambda m: say(f"[14] (d) {m}"))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        clean = train_loop("granite-3-2b", ckpt_dir=f"{d}/clean", **common)
        faulty = train_loop("granite-3-2b", ckpt_dir=f"{d}/faulty",
                            injector=FailureInjector(
                                schedule={9: "node_failure"}), **common)
        wall = time.perf_counter() - t0
    rel = abs(faulty.losses[-1] / clean.losses[-1] - 1)
    check(faulty.restarts == 1 and faulty.steps_done == clean.steps_done
          == 16 and rel <= 1e-4,
          f"fault restart: {faulty.restarts} restarts, "
          f"{faulty.steps_done} steps, final loss {faulty.losses[-1]} vs "
          f"{clean.losses[-1]}")
    say(f"[14] (d) reduced granite, 16 steps, failure at 9: 1 restart "
        f"from the step-8 checkpoint, final loss {faulty.losses[-1]:.6f} "
        f"vs clean {clean.losses[-1]:.6f} (rel {rel:.3g}, bar 1e-4); "
        f"both runs {wall:.1f} s")
    return clean.losses[-1]


# ---------------------------------------------------------------------------
# phase 16: the roofline and dry-run layer on the card
# ---------------------------------------------------------------------------

# the ported examples (examples/torch/), run on the card in phase 16 (d)
EXAMPLES = ("quickstart", "carbon_aware_training", "green_window_planner",
            "scenario_replay", "multicloud_serve")
# examples run through their functions at a cut depth instead of as a
# script: green_window_planner's scene 1 over an eighth of its simulated
# year (the year alone took 490-592 s on the card, half the time limit;
# a quarter, 202.6 s, bounded phase 16 and paid for zamba2's training at
# 2 x 1024 and 4 x 1024 in phase 14)
EXAMPLE_CALLS = {
    "green_window_planner":
        "ex.scene_migration(epochs=1095); ex.scene_deferral()"}


def _roof_cell(record, key, cfg, model, kind, seq, batch, ms, *,
               cache_len=None, card=None, share=None, eager=None):
    """One measured cell for phase 16: its config and model, its shape
    (a decode step's ``seq`` is its cache length), the measured ms per
    step (a serving cell's: the captured step's, a prefill's synchronized
    alone), the ``Cost`` counted on
    the card (or None), phase 14's model-FLOP share (or None) and the
    eager step's ms (or None)."""
    from repro_torch.configs.base import ShapeSpec
    record[key] = dict(cfg=cfg, model=model, cache_len=cache_len, ms=ms,
                       card=card, share=share, eager=eager,
                       shape=ShapeSpec(key, kind, seq, batch))


def _count_serving(model, params, prompts, cache):
    """The card's prefill of ``prompts`` into ``cache``-long caches and one
    decode step after it, each counted by ``launch.step_cost`` with int32
    inputs (the dry run's batch dtypes)."""
    import torch
    from repro_torch.launch.step_cost import count_step
    B, P = prompts.shape
    batch = {"tokens": prompts.to(torch.int32)}
    (lk, caches), pre = count_step(
        lambda: model.prefill(params, batch, cache), params, batch)
    step = {"token": lk.argmax(-1).to(torch.int32),
            "positions": torch.full((B,), P, dtype=torch.int32,
                                    device=prompts.device)}
    _, dec = count_step(lambda: model.decode_step(params, caches, step),
                        params, caches, step)
    torch.cuda.synchronize()
    return pre, dec


def _start_examples():
    """Each ported example on the card in its own process, its output to
    a temporary file; a thread per process notes when it exits."""
    import os
    import tempfile
    import threading
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {}
    for name in EXAMPLES:
        log = tempfile.TemporaryFile(mode="w+")
        t0 = time.perf_counter()
        where = SRC.parent / "examples" / "torch"
        cmd = ([str(where / f"{name}.py")] if name not in EXAMPLE_CALLS
               else ["-c", f"import sys; sys.path.insert(0, {str(where)!r});"
                           f" import {name} as ex; {EXAMPLE_CALLS[name]}"])
        p = subprocess.Popen(
            [sys.executable, *cmd], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=SRC.parent)
        ended = {}
        threading.Thread(target=lambda p=p, ended=ended: ended.setdefault(
            "s", (p.wait(), time.perf_counter())[1]), daemon=True).start()
        procs[name] = (p, log, t0, ended)
    return procs


def _phase16_calibration(hw):
    """(a) ``for_workload`` over the 40 cells on the reference's TPU v5e
    row, held against ``BENCH_energy.json``, and on the card's row."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core.energy import DEFAULT_ENERGY
    rec = json.loads((SRC.parent / "BENCH_energy.json").read_text())
    want = rec["configs"][0]["calibration_chip_w"]
    held = 0
    for row in ("tpu-v5e", hw):
        for arch in ARCHS:
            ws = {s: DEFAULT_ENERGY.for_workload(
                ARCHS[arch], SHAPES[s], hw=row).chip_power_w
                for s in SHAPES}
            if row == "tpu-v5e":
                for s, w in ws.items():
                    key = f"{arch}/{s}"
                    if key in want:
                        check(round(w, 2) == want[key],
                              f"for_workload {key}: {w} W, "
                              f"BENCH_energy.json {want[key]} W")
                        held += 1
            tag = ("the reference's TPU v5e calibration" if row == "tpu-v5e"
                   else f"the port's H100 calibration ({row})")
            say(f"[16] (a) {tag}, {arch}: "
                + ", ".join(f"{s} {w:.2f}" for s, w in ws.items())
                + " W/chip")
    check(held == 20, f"{held} of BENCH_energy.json's 20 cells held")
    say(f"[16] (a) for_workload == BENCH_energy.json configs[0]."
        f"calibration_chip_w on all {held} cells (to 0.01 W)")


def _phase16_counts(record, hw, card):
    """(b) each step counted on the card == ``dryrun.count_cell`` on meta
    at the same shape; (c) each measured cell on the roofline of the
    card's row beside its measured time, ``roofline_fraction`` and
    ``mfu``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HARDWARE
    from repro_torch.launch.roofline import from_cost
    peak = HARDWARE[hw].peak_flops_bf16
    for key, e in record.items():
        t0 = time.perf_counter()
        _, _, meta = dryrun.count_cell(e["cfg"], e["shape"], e["model"],
                                       cache_len=e["cache_len"])
        c = meta.cost
        if e["card"] is not None:
            check((e["card"].flops, e["card"].bytes) == (c.flops, c.bytes),
                  f"{key}: the card's step counts {e['card'].flops} FLOPs, "
                  f"{e['card'].bytes} bytes; on meta {c.flops}, {c.bytes}")
            k = {n: v[0] for n, v in meta.by_op.items()
                 if n in ("flash_attention", "selective_scan")}
            say(f"[16] (b) {key}: counted on the card == on meta: "
                f"{c.flops:.6g} FLOPs, {c.bytes:.6g} bytes (K5/K6 by their "
                f"formulas: {k or 'none'}; meta count "
                f"{time.perf_counter() - t0:.1f} s)")
        roof = from_cost(c, 1, hw)
        mf = dryrun.model_flops(e["cfg"], e["shape"])
        mfu = mf / (peak * e["ms"] / 1e3)
        sh = e["shape"]
        eager = ("" if e["eager"] is None else
                 f"; the captured step; eager {e['eager']:.2f} ms")
        say(f"[16] (c) {key} ({sh.global_batch} x {sh.seq_len}): counted "
            f"{c.flops:.4g} FLOPs, {c.bytes:.4g} bytes -> roofline step "
            f"{roof.step_s * 1e3:.3f} ms ({roof.dominant}) on {hw}; "
            f"measured {e['ms']:.2f} ms ({100 * roof.step_s * 1e3 / e['ms']:.2f}"
            f" % of it{eager}); model FLOPs {mf:.4g} = {mf / c.flops:.3f} x counted;"
            f" roofline_fraction {roof.roofline_fraction(mf):.4f}; mfu "
            f"{mfu:.5f} on {card}")
        if e["share"] is not None:
            gap = mfu / e["share"] - 1
            n_el = _active_elements(e["cfg"], sum(t.numel() for t in _leaves(
                dryrun.meta_tree(e["model"].template()))))
            cause = ("active_param_count == the tensor elements"
                     if n_el == e["cfg"].active_param_count() else
                     f"active_param_count {e['cfg'].active_param_count()} vs "
                     f"{n_el} tensor elements (param_count's gaps, ROADMAP "
                     f"Queue 3)")
            # both shares divide by the same measured time: the gap is
            # active_param_count's against the tensor elements, no more
            check(abs(gap) <= 0.01, f"{key}: mfu {mfu} vs phase 14's share "
                  f"{e['share']} ({cause})")
            say(f"[16] (c) {key}: mfu {mfu:.6f} vs phase 14's model-FLOP "
                f"share {e['share']:.6f} (same measured time, so this holds "
                f"the parameter count): {100 * gap:+.4f} % ({cause})")


def _phase16_host_cost(dev):
    """What the custom op adds to a launch's host time: K5 and K6 at tiny
    shapes (the host is the bottleneck there), through the op and through
    the bare launch, 2,000 calls each."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    q = torch.randn(1, 2, 64, 64, device=dev).to(torch.bfloat16)
    scan = [torch.rand(1, 8, 64, device=dev) * 0.1,
            torch.randn(1, 8, 64, device=dev),
            torch.randn(1, 8, 16, device=dev),
            torch.randn(1, 8, 16, device=dev),
            -torch.rand(64, 16, device=dev)]
    for name, op, bare in (
            ("flash_attention", lambda: fa.flash_attention(q, q, q),
             lambda: fa.launch(q, q, q)),
            ("selective_scan", lambda: ss.selective_scan(*scan),
             lambda: ss.launch(*scan))):
        us = {}
        for tag, fn in (("op", op), ("bare", bare), ("op2", op),
                        ("bare2", bare)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            us[tag] = (time.perf_counter() - t0) / 2000 * 1e6
        o, b = min(us["op"], us["op2"]), min(us["bare"], us["bare2"])
        say(f"[16] {name}: host time per call through the custom op "
            f"{o:.1f} us, the bare launch {b:.1f} us: the op adds "
            f"{o - b:.1f} us (op, bare, op, bare: "
            f"{', '.join(f'{v:.1f}' for v in us.values())} us)")


def _finish_examples(procs, deadline_s=900.0):
    """(d) every example exited 0 (each waited for at most ``deadline_s``
    from its start)."""
    for name, (p, log, t0, ended) in procs.items():
        try:
            rc = p.wait(timeout=max(1.0, deadline_s
                                    - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            rc = None
        log.seek(0)
        tail = log.read()[-1500:]
        check(rc == 0, f"example {name} exited {rc}: {tail}")
        last = [ln for ln in tail.splitlines() if ln.strip()][-1]
        took = ended.get("s", time.perf_counter()) - t0
        how = f" ({EXAMPLE_CALLS[name]})" if name in EXAMPLE_CALLS else ""
        say(f"[16] (d) examples/torch/{name}.py{how} on the card: exit 0 "
            f"after {took:.1f} s; last line: {last[:120]}")


def _stop_examples(procs):
    for p, log, _, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def phase_roofline(name, record, examples):
    """Phase 16: (a) the energy calibration, (b) counts card == meta, (c)
    the measured cells on the roofline with ``mfu``, (d) the examples
    (``examples``: started just before, each in its own process) exit
    0, (e) the dry run of the production meshes on meta."""
    import tempfile
    t0 = time.perf_counter()
    hw = card_hw(name)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_cells, t_mesh = _start_mesh_dryruns(tmp)
        try:
            _phase16_calibration(hw)
            _phase16_counts(record, hw, _smi("name,power.limit"))
            _finish_mesh_dryruns(mesh_cells, t_mesh)
        finally:
            for p, _, _ in mesh_cells:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    _finish_examples(examples)
    say(f"[16] (a)-(e) took {time.perf_counter() - t0:.1f} s")


# (e): (arch, shape, mode, chips, budget in seconds from their start) of
# the mesh dry run's cells on meta; zamba2's optimized train cell runs the
# SSD route (ROADMAP F3): 70-74 s on the card's host beside the other
# three, which hold their 120 s; its own budget leaves room for a host
# 3x slower
P16_MESH_CELLS = (("granite-3-2b", "train_4k", "baseline", 256, 120.0),
                  ("llama3.2-3b", "train_4k", "int8", 512, 120.0),
                  ("nemotron-4-340b", "prefill_32k", "baseline", 256, 120.0),
                  ("zamba2-1.2b", "train_4k", "optimized", 256, 240.0))


def _start_mesh_dryruns(tmp):
    """(e) each cell of ``P16_MESH_CELLS`` through the dry-run CLI, in
    its own process, all started together: [(process, cell, result
    path)] and their start on the host clock."""
    import os
    out, t0 = [], time.perf_counter()
    for cell in P16_MESH_CELLS:
        arch, shape, mode, chips, _ = cell
        path = Path(tmp) / f"{arch}__{shape}__{chips}__{mode}.json"
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mode", mode, "--chips", str(chips),
             "--out", str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(SRC)))
        out.append((p, cell, path))
    return out, t0


def _finish_mesh_dryruns(cells, t0):
    """(e) every cell ends within its budget (from their start) with
    ``status: ok`` on its mesh, collective bytes > 0, nemotron's prefill
    through K5's meta form; prints each cell's terms and time."""
    for p, (arch, shape, mode, chips, budget), path in cells:
        try:
            log = p.communicate(timeout=max(
                budget - (time.perf_counter() - t0), 1.0))[0]
        except subprocess.TimeoutExpired:
            check(False, f"(e) the {arch} {shape} dry run on {chips} chips "
                  f"outlived its {budget:.0f} s budget")
        took = time.perf_counter() - t0
        check(p.returncode == 0 and path.exists(),
              f"(e) the {arch} {shape} {mode} dry run on {chips} chips "
              f"failed:\n{log.decode()[-2000:]}")
        r = json.loads(path.read_text())
        rf, mem = r["roofline"], r["memory"]
        check(r["status"] == "ok" and r["chips"] == chips
              and rf["collective_bytes_per_device"] > 0,
              f"(e) {arch} {shape}: {r['status']}, chips {r['chips']}, "
              f"collective bytes {rf['collective_bytes_per_device']}")
        if shape.startswith("prefill"):
            check(r["prefill_route"] == "kernels",
                  f"(e) {arch} prefill route {r['prefill_route']}")
        kinds = {k: f"{v / 1e9:.4g} GB"
                 for k, v in rf["collective_per_kind"].items()}
        say(f"[16] (e) {arch} {shape} {mode} on {chips} fake ranks (meta): "
            f"{rf['dominant']}-bound, roofline step {rf['step_s']:.4g} s "
            f"(compute {rf['compute_s']:.4g}, memory {rf['memory_s']:.4g}, "
            f"collective {rf['collective_s']:.4g} s at {rf['hw']}'s link), "
            f"collective bytes per device {kinds}, argument bytes per "
            f"device {mem['argument_bytes_per_device'] / 1e9:.4g} GB, "
            f"count_s {r['count_s']}"
            + (f", prefill route {r['prefill_route']}"
               if r["prefill_route"] else "")
            + f"; ended by {took:.1f} s (budget {budget:.0f} s)")
    say(f"[16] (e) {len(cells)} mesh cells, run side by side, took "
        f"{time.perf_counter() - t0:.1f} s")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]



# ---------------------------------------------------------------------------
# phase 17: more than one rank on the one card
# ---------------------------------------------------------------------------

# (b): granite-3-2b at full width, bf16, its depth cut to fit the phase's
# budget; (arch, layers, batch, seq, steps)
P17_TRAIN = ("granite-3-2b", 4, 4, 512, 2)
P17_BUDGET_S = 240.0
# the reference's bars (tests/test_multidevice.py:152-153, :185)
P17_LOSS_BAR, P17_GNORM_BAR, P17_SYNC_BAR = 5e-3, 5e-2, 5e-2
P17_WIRE = ("all_gather_into_tensor", "all_to_all_single", "all_reduce")


def _p17_dev(kind):
    """The rank's device: every rank's tensors on the one card."""
    import torch
    if kind == "cuda":
        torch.cuda.set_device(0)
        return torch.device("cuda", 0)
    return torch.device("cpu")


def p17_world(rank, world, kind, tasks):
    """A rank of phase 17: its tasks in order, results by name."""
    dev = _p17_dev(kind)
    return {name: globals()[fn](rank, world, dev, **kw)
            for name, fn, kw in tasks}


def _p17_wire(log):
    """Wrap the collectives the pod syncs call, logging (op, dtype,
    bytes) of each payload; returns the originals."""
    import torch.distributed as dist
    saved = {n: getattr(dist, n) for n in P17_WIRE}
    for n in P17_WIRE:
        def wrapped(*a, _o=saved[n], _n=n, **k):
            t = a[0] if _n == "all_reduce" else a[1]
            log.append((_n, str(t.dtype).split(".")[-1],
                        t.numel() * t.element_size()))
            return _o(*a, **k)
        setattr(dist, n, wrapped)
    return saved


def p17_syncs(rank, world, dev):
    """(a) the three pod means of a (2, 64, 32) f32 tree per rank, on the
    card and on the CPU; the card's wire log."""
    import torch
    import torch.distributed as dist
    from repro_torch.train import compression as C
    g = np.random.default_rng(17).standard_normal(
        (world, 2, 64, 32)).astype(np.float32)[rank]
    out = {}
    for kind, fn in (("int8", C.compressed_psum_mean),
                     ("int16", C.int16_psum_mean), ("fp32", C.psum_mean)):
        log: list = []
        saved = _p17_wire(log)
        try:
            card = fn({"g": torch.from_numpy(g).to(dev)})["g"].cpu().numpy()
        finally:
            for n, f in saved.items():
                setattr(dist, n, f)
        host = fn({"g": torch.from_numpy(g)})["g"].numpy()
        out[kind] = dict(card=card, cpu=host, wire=log)
    out["amax"] = float(np.abs(np.random.default_rng(17).standard_normal(
        (world, 2, 64, 32)).astype(np.float32)).max())
    return out


def _p17_state(model, mesh, dev, seed=0, rules=None):
    """The drawn state (every rank draws the same values from ``seed``,
    the head from ``seed + 1``) laid out on ``mesh`` by ``rules`` (the
    default rules when None; plain on one rank)."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.train_step import TrainState
    params = model.init(seed, device=dev)
    # a drawn head (the zero-init head gives every layout the loss ln V)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    head = params["lm_head"]
    params["lm_head"] = (torch.randn(head.shape, generator=gen, device=dev)
                         * 0.02).to(head.dtype)
    if mesh is not None:
        params = sh.distribute_tree(
            params, sh.tree_shardings(model.template(), mesh,
                                      rules or sh.Rules()), src_rank=None)
    return TrainState.create(params)


def p17_train(rank, world, dev, shape, sync, ckpt_dir=None,
              constrain=False):
    """(b) P17_TRAIN's steps on a ``make_host_mesh(*shape)`` mesh (shape
    (1, 1, 1): rank 0 alone, plain tensors); per-rank ms/step, peak
    memory, collective bytes per step (payloads, and the reference's
    weighted result bytes) and the gloo route's share.  ``constrain``
    (f): the state laid out by, and the steps run under
    ``activation_sharding`` with, the rules of the optimized llama3.2-3b
    train cell (``launch.settings``: the sequence split over ``model``,
    the weights whole over it); ``moved`` the redistributes the
    constraints issued per step."""
    import contextlib
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, PipelineState, host_batch
    from repro_torch.distributed import collectives as CL
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step
    arch, layers, batch, seq, steps = P17_TRAIN
    data, model_n, pod = shape
    n = data * model_n * pod
    mesh = make_host_mesh(data, model_n, pod, device=dev) if n > 1 else None
    if rank >= n:
        return None
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = build_model(cfg, ModelFlags(attn_chunk=min(512, seq)))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rules, ctx = sh.Rules(), contextlib.nullcontext()
    if constrain:
        from repro_torch.configs import get_shape
        from repro_torch.launch.settings import cell_settings
        st = cell_settings(get_config("llama3.2-3b"), get_shape("train_4k"),
                           "optimized")
        check(st.constrain_acts and st.rules != sh.Rules(),
              "(f) the optimized llama3.2-3b cell sets no rules of its own "
              "or no activation constraints")
        rules, ctx = st.rules, sh.activation_sharding(mesh, st.rules)
    state = _p17_state(model, mesh, dev, rules=rules)
    step = make_train_step(model, AdamWConfig(), grad_sync=sync,
                           mesh=mesh if sync != "auto" else None)
    dcfg = DataConfig(cfg, batch, seq, task="copy")
    bsh = None if mesh is None else sh.tree_shardings(
        {k: sh.Param((batch, seq), ("batch", None), dtype=torch.int32)
         for k in ("tokens", "labels")}, mesh, rules)
    ps, out = PipelineState(0, 0), dict(losses=[], gnorms=[], ms=[],
                                        bytes=[], eager=[], calls=[],
                                        weighted=[], moved=[])
    for _ in range(steps):
        ps, b = host_batch(dcfg, ps)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if bsh is not None:
            b = sh.distribute_tree(b, bsh, src_rank=None)
        _sync(dev)
        t0 = time.perf_counter()
        with CL.counting() as log, ctx:
            state, met = step(state, b)
            loss, gn = float(met["loss"]), float(met["grad_norm"])
        _sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        out["gnorms"].append(gn)
        out["bytes"].append(log.total_bytes)
        out["weighted"].append(log.weighted_bytes)
        out["eager"].append(log.eager_bytes)
        out["calls"].append(sum(log.calls.values()))
        out["moved"].append(getattr(ctx, "moved", 0) - sum(out["moved"]))
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else float("nan"))
    out["params"] = sum(p.numel() for p in sh.tree_leaves(state.params))
    if ckpt_dir is not None:
        tree = {"params": state.params, "opt": state.opt,
                "step": state.step}
        t0 = time.perf_counter()
        ckpt.save(ckpt_dir, tree, steps)
        out["save_s"] = time.perf_counter() - t0
        if rank == 0:
            # the (2, 2) state's values, for the restore onto one rank
            out["digest"] = _p17_digest(sh.local_tree(tree))
        else:
            sh.local_tree(tree)
    return out


def _p17_digest(tree):
    """sha256 of every leaf's bytes, in sorted key order."""
    import hashlib
    import torch
    from repro_torch.distributed import sharding as sh
    h = hashlib.sha256()
    for t in sh.tree_leaves(tree):
        t = t.detach().contiguous().cpu()
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def p17_restore(rank, world, dev, ckpt_dir):
    """(b) the (2, 2) checkpoint restored onto one rank (rank 0)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import opt_template
    if rank:
        return None
    arch, layers = P17_TRAIN[:2]
    tpl = build_model(dataclasses.replace(get_config(arch),
                                          n_layers=layers)).template()
    tree, step, _ = ckpt.restore(ckpt_dir, {"params": tpl, "opt":
                                            opt_template(tpl), "step": None},
                                 device=dev)
    return dict(step=step, digest=_p17_digest(tree))


def p17_ensemble(rank, world, dev):
    """(c) phase 9's lanes with ``shard=True``: each rank's lanes, its K4
    launches and ms per epoch; every lane's digest, counters and
    emissions."""
    from repro_torch.core import simulator as S
    from repro_torch.kernels import maizx_rank as mr
    cfg, grid = _p9_grid()
    specs = [spec for _, _, spec in _grid_runs(S, cfg, grid, SIM_N,
                                               ENS_SEEDS, dev)]
    _sync(dev)
    mr.maiz_topk_b.launches = 0
    t0 = time.perf_counter()
    lanes = S.simulate_fleet_ensemble(specs, shard=True)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / cfg.epochs
    k4 = mr.maiz_topk_b.launches
    return dict(ms=ms, k4=k4, lanes=[_p17_lane(r) for r in lanes])


def p17_ensemble_en(rank, world, dev, lanes):
    """(e) the first ``lanes`` of phase 9's lanes with ``shard="en"``:
    the ("e", "n") mesh of the world, each lane block's placement engine
    split over its n ranks by nodes, K4 on each rank's node shard; ms per
    epoch and K4 launches on this rank, every lane's digest, counters and
    emissions."""
    from repro_torch.core import simulator as S
    from repro_torch.kernels import maizx_rank as mr
    cfg, grid = _p9_grid()
    specs = [spec for _, _, spec in _grid_runs(S, cfg, grid, SIM_N,
                                               ENS_SEEDS, dev)][:lanes]
    _sync(dev)
    mr.maiz_topk_b.launches = 0
    t0 = time.perf_counter()
    out = S.simulate_fleet_ensemble(specs, shard="en")
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / cfg.epochs
    return dict(ms=ms, k4=mr.maiz_topk_b.launches,
                lanes=[_p17_lane(r) for r in out])


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _p17_lane(r):
    import hashlib
    keys = ("rank_sweeps", "arrivals_placed", "jobs_completed",
            "jobs_dropped", "jobs_deferred", "migrations", "evictions",
            "deadline_misses", "defer_delay_h", "migrations_failed",
            "jobs_active_end", "safe_epochs")
    dig = hashlib.sha256(np.concatenate(
        [r.node_log, r.first_node]).tobytes()).hexdigest()[:16]
    return dict(digest=dig, start=r.start_epoch.tobytes(),
                counters={k: getattr(r, k) for k in keys},
                emissions=float(r.emissions_g))


def p17_loop(rank, world, dev, ckpt_dir):
    """(d) reduced granite, ``train_loop(data_mesh=2)``, 16 steps, a
    checkpoint every 4, a node failure at step 9."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.fault_tolerance import FailureInjector
    t0 = time.perf_counter()
    run = train_loop("granite-3-2b", steps=16, batch=4, seq=32,
                     reduced=True, task="copy", ckpt_every=4,
                     log_every=100, data_mesh=2, ckpt_dir=ckpt_dir,
                     injector=FailureInjector(schedule={9: "node_failure"}),
                     device=dev, log=lambda m: None)
    return dict(losses=run.losses, restarts=run.restarts,
                steps_done=run.steps_done, s=time.perf_counter() - t0,
                member=run.final_state is not None)


def _p9_grid():
    """Phase 9's ensemble configuration and policy grid."""
    from repro_torch.core import simulator as S
    from repro_torch.core.policy import PolicyConfig
    cfg = S.SimConfig(epochs=24, arrival_rate=12.0, mean_duration_h=12.0,
                      migration_budget=2, deferrable_frac=0.1, shortlist=64,
                      use_kernel=True)
    return cfg, {f"reactive_g{f}": PolicyConfig(defer_green_factor=f)
                 for f in ENS_FACTORS}


def phase_multirank(dev, ens9, clean, kind="cuda"):
    """Phase 17: ranks that share the one card, over gloo.  (a) the pod
    syncs at 2 and 4 ranks, card == CPU bitwise, the bound and the wire
    format; (b) granite-3-2b at full width on (2, 2) and on (pod 2, data
    2) with the int8 sync against one rank, and the (2, 2) checkpoint
    restored onto one rank; (c) phase 9's lanes with ``shard=True`` on 2
    ranks == phase 9's; (d) the elastic restart.  Returns K4's launches
    on the ranks."""
    import tempfile
    import torch
    from repro_torch.distributed.ranks import run_ranks
    t_all = time.perf_counter()
    say("[17] ranks share the one card: NCCL refuses two ranks on one "
        "device, so the worlds run gloo, every rank's tensors on cuda:0; "
        "gloo copies CUDA tensors through host memory, and its functional "
        "collectives (DTensor's) run as eager c10d calls "
        "(distributed.collectives.gloo_cuda_collective)")
    arch, layers, batch, seq, steps = P17_TRAIN
    with tempfile.TemporaryDirectory() as tmp:
        w4 = [("sync", "p17_syncs", {}),
              ("one", "p17_train", dict(shape=(1, 1, 1), sync="auto")),
              ("22", "p17_train", dict(shape=(2, 2, 1), sync="auto",
                                      ckpt_dir=f"{tmp}/ckpt22")),
              ("pod_int8", "p17_train", dict(shape=(2, 1, 2),
                                            sync="int8")),
              ("restore", "p17_restore", dict(ckpt_dir=f"{tmp}/ckpt22")),
              ("22_opt", "p17_train", dict(shape=(2, 2, 1), sync="auto",
                                          constrain=True)),
              ("en2", "p17_ensemble_en", dict(lanes=2))]
        w2 = [("sync", "p17_syncs", {}), ("ens", "p17_ensemble", {}),
              ("loop", "p17_loop", dict(ckpt_dir=f"{tmp}/loop")),
              ("en1", "p17_ensemble_en", dict(lanes=1))]
        t0 = time.perf_counter()
        r2 = run_ranks(p17_world, 2, kind, w2, timeout=P17_BUDGET_S)
        t2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        r4 = run_ranks(p17_world, 4, kind, w4, timeout=P17_BUDGET_S)
        t4 = time.perf_counter() - t0
    # (a)
    for world, res in ((2, r2), (4, r4)):
        for kind_ in ("int8", "int16", "fp32"):
            for rank, r in enumerate(res):
                a = r["sync"][kind_]
                check(a["card"].tobytes() == a["cpu"].tobytes(),
                      f"(a) {kind_} sync at {world} ranks: rank {rank}'s "
                      "card result != its CPU result")
                err = float(np.abs(a["card"] - r["sync"]["fp32"]["card"])
                            .max())
                check(err <= r["sync"]["amax"] / 127.0 + 1e-6,
                      f"(a) {kind_} at {world} ranks: error {err}")
        wire = {k: res[0]["sync"][k]["wire"] for k in ("int8", "int16",
                                                       "fp32")}
        check(wire["int8"][0][1] == "int8"
              and all(w[1] == "uint8" for w in wire["int16"][1:]),
              f"(a) wire formats {wire}")
        errs = {k: float(np.abs(res[0]["sync"][k]["card"]
                                - res[0]["sync"]["fp32"]["card"]).max())
                for k in ("int8", "int16")}
        say(f"[17] (a) {world} ranks: int8 / int16 / fp32 pod means of a "
            f"(2, 64, 32) f32 tree per rank, card == CPU bitwise on every "
            f"rank; error vs the f32 mean int8 {errs['int8']:.3g}, int16 "
            f"{errs['int16']:.3g} (bound {res[0]['sync']['amax'] / 127:.3g}"
            f"); wire (op, dtype, bytes): int8 {wire['int8']}, int16 "
            f"{wire['int16']}, fp32 {wire['fp32']}")
    # (b)
    one = r4[0]["one"]
    for key, what in (("22", "(data 2, model 2) auto"),
                      ("pod_int8", "(pod 2, data 2) int8")):
        runs = [r[key] for r in r4]
        for r in runs:
            check(r["losses"] == runs[0]["losses"],
                  f"(b) {what}: ranks disagree on the loss")
        got = runs[0]
        bar = P17_SYNC_BAR if key == "pod_int8" else P17_LOSS_BAR
        for a, b in zip(got["losses"], one["losses"]):
            check(abs(a - b) < bar and math.isfinite(a),
                  f"(b) {what}: loss {got['losses']} vs one rank "
                  f"{one['losses']}")
        if key == "22":
            for a, b in zip(got["gnorms"], one["gnorms"]):
                check(abs(a - b) / b < P17_GNORM_BAR,
                      f"(b) {what}: grad norm {a} vs {b}")
        for rank, r in enumerate(runs):
            say(f"[17] (b) {what} rank {rank}: ms/step "
                f"{[round(x, 1) for x in r['ms']]}, peak "
                f"{r['peak_gib']:.2f} GiB, collective bytes/step "
                f"{r['bytes']} in {r['calls']} calls, all through gloo's "
                f"host staging; functional collectives run eagerly "
                f"{r['eager']} bytes/step")
        say(f"[17] (b) {what}: losses {got['losses']}, grad norms "
            f"{got['gnorms']} vs one rank {one['losses']}, "
            f"{one['gnorms']} ({one['ms'][-1]:.1f} ms/step, "
            f"{one['peak_gib']:.2f} GiB)")
    check(abs(r4[0]["pod_int8"]["losses"][-1] - r4[0]["22"]["losses"][-1])
          < P17_SYNC_BAR, "(b) int8 vs auto")
    check(r4[0]["restore"]["digest"] == r4[0]["22"]["digest"]
          and r4[0]["restore"]["step"] == steps,
          "(b) the (2, 2) checkpoint restored onto one rank differs")
    say(f"[17] (b) granite-3-2b at full width, {layers} of "
        f"{40} layers (depth cut to the phase's {P17_BUDGET_S:.0f} s), "
        f"bf16, batch {batch} x {seq}, {steps} steps, "
        f"{r4[0]['one']['params'] / 1e9:.3f} B parameters; the (2, 2) "
        f"state saved ({r4[0]['22']['save_s']:.1f} s) and restored onto "
        f"one rank: every leaf equal (digest {r4[0]['22']['digest']})")
    # (c)
    if ens9 is None:
        from repro_torch.core import simulator as S
        cfg, grid = _p9_grid()
        ens = S.simulate_fleet_ensemble(
            [sp for _, _, sp in _grid_runs(S, cfg, grid, SIM_N, ENS_SEEDS,
                                           dev)])
    else:
        ens = ens9[2]
    want = [_p17_lane(r) for r in ens]
    for rank, r in enumerate(r2):
        got = r["ens"]["lanes"]
        check(len(got) == len(want), "(c) lane count")
        for i, (a, b) in enumerate(zip(got, want)):
            check(a["digest"] == b["digest"] and a["start"] == b["start"]
                  and a["counters"] == b["counters"]
                  and abs(a["emissions"] / b["emissions"] - 1) <= 1e-4,
                  f"(c) rank {rank} lane {i} != phase 9's lane")
    k4 = sum(r["ens"]["k4"] for r in r2)
    check(all(r["ens"]["k4"] > 0 for r in r2), "(c) a rank launched no K4")
    say(f"[17] (c) phase 9's {len(want)} lanes x n={SIM_N} with "
        f"shard=True on 2 ranks ({len(want) // 2} lanes each): every lane "
        f"== phase 9's (digests {[w['digest'] for w in want[:2]]}..., "
        f"counters, emissions rel 1e-4) on both ranks; K4 launches per "
        f"rank {[r['ens']['k4'] for r in r2]}, ms/epoch per rank "
        f"{[round(r['ens']['ms'], 1) for r in r2]}")
    # (d)
    loop = [r["loop"] for r in r2]
    rel = (abs(loop[0]["losses"][-1] / clean - 1) if clean is not None
           else float("nan"))
    check(all(x["restarts"] == 1 and x["steps_done"] == 16
              and x["losses"] == loop[0]["losses"] for x in loop)
          and [x["member"] for x in loop] == [True, False],
          f"(d) elastic restart: {loop}")
    # the reference's mesh-vs-one-device bar: in bf16 a step split over
    # ranks rounds each rank's partial sums, so the 8 steps before the
    # restart drift from one device's at the 1e-4 level (PERF.md §6)
    check(clean is None or abs(loop[0]["losses"][-1] - clean)
          < P17_LOSS_BAR, f"(d) final loss {loop[0]['losses'][-1]} vs "
          f"phase 14 (d)'s clean {clean} (rel {rel:.3g})")
    say(f"[17] (d) reduced granite, train_loop(data_mesh=2) on 2 ranks, a "
        f"failure at step 9: 1 restart onto data=1 (rank 1 waits), final "
        f"loss {loop[0]['losses'][-1]:.6f} vs phase 14 (d)'s clean "
        f"{clean} (rel {rel:.3g}; bar {P17_LOSS_BAR} absolute), "
        f"{loop[0]['s']:.1f} s")
    k4 += _p17_en(dev, r2, r4)
    _p17_constrained(r4)
    took = time.perf_counter() - t_all
    say(f"[17] phase 17 took {took:.1f} s (4-rank world {t4:.1f} s, "
        f"2-rank world {t2:.1f} s; budget {P17_BUDGET_S:.0f} s)")
    check(took <= P17_BUDGET_S, f"phase 17 took {took:.1f} s")
    return {"maiz_topk_b": k4}


def _p17_en(dev, r2, r4):
    """(e) ``shard="en"``: one lane over 2 ranks (mesh (e 1, n 2)) and two
    over 4 ((e 2, n 2)), each lane == the same lanes run in one process
    here (placements, start epochs and counters bitwise, emissions within
    the ensemble's rel 1e-4: a row of one lane against the two lanes
    batched); returns the ranks' K4 launches."""
    from repro_torch.core import simulator as S
    cfg, grid = _p9_grid()
    specs = [spec for _, _, spec in _grid_runs(S, cfg, grid, SIM_N,
                                               ENS_SEEDS, dev)]
    k4 = 0
    for world, res, key, lanes, mesh in ((2, r2, "en1", 1, (1, 2)),
                                         (4, r4, "en2", 2, (2, 2))):
        _sync(dev)
        t0 = time.perf_counter()
        want = [_p17_lane(r) for r in
                S.simulate_fleet_ensemble(specs[:lanes])]
        _sync(dev)
        one_ms = (time.perf_counter() - t0) * 1e3 / cfg.epochs
        rel = 0.0
        for rank, r in enumerate(res):
            got = r[key]["lanes"]
            check(len(got) == lanes, f"(e) {key}: lane count")
            for i, (a, b) in enumerate(zip(got, want)):
                check(a["digest"] == b["digest"] and a["start"] == b["start"]
                      and a["counters"] == b["counters"],
                      f"(e) rank {rank} lane {i} of {key}: placements or "
                      "counters != the lane run in one process")
                rel = max(rel, abs(a["emissions"] / b["emissions"] - 1))
            check(r[key]["k4"] > 0, f"(e) rank {rank} launched no K4")
        # the ensemble's contract: emissions to f32 accumulation (a lane
        # block of one lane against the lanes batched in one process)
        check(rel <= 1e-4, f"(e) {key}: emissions rel {rel:.3g}")
        k4 += sum(r[key]["k4"] for r in res)
        say(f"[17] (e) shard='en', {lanes} lane(s) x n={SIM_N} on {world} "
            f"ranks, mesh (e {mesh[0]}, n {mesh[1]}): K4 on "
            f"{SIM_N // mesh[1]}-node shards; every lane == the lanes run "
            f"in one process (digests {[w['digest'] for w in want]}, "
            f"counters bitwise, emissions rel {rel:.3g}, bar 1e-4) on every "
            f"rank; K4 launches per "
            f"rank {[r[key]['k4'] for r in res]}, ms/epoch per rank "
            f"{[round(r[key]['ms'], 1) for r in res]} (one process "
            f"{one_ms:.1f}; every node reduction a gloo round trip "
            "through host memory)")
    return k4


def _p17_constrained(r4):
    """(f) the (data 2, model 2) granite step with the optimized
    llama3.2-3b cell's rules under activation_sharding: every step's
    constraints issue a redistribute on every rank, the collective plan
    differs from (b)'s, losses within the reference's 5e-3 of one rank;
    collective bytes per rank-step beside (b)'s."""
    one, auto = r4[0]["one"], r4[0]["22"]
    runs = [r["22_opt"] for r in r4]
    for rank, r in enumerate(runs):
        check(r["losses"] == runs[0]["losses"],
              "(f) ranks disagree on the loss")
        check(min(r["moved"]) > 0,
              f"(f) rank {rank}: a step whose constraints moved nothing "
              f"({r['moved']} redistributes per step)")
    check((runs[0]["calls"][-1], runs[0]["weighted"][-1])
          != (auto["calls"][-1], auto["weighted"][-1]),
          "(f) the constrained step's collectives are (b)'s")
    for a, b in zip(runs[0]["losses"], one["losses"]):
        check(abs(a - b) < P17_LOSS_BAR and math.isfinite(a),
              f"(f) loss {runs[0]['losses']} vs one rank {one['losses']}")
    say(f"[17] (f) (data 2, model 2) with the optimized llama3.2-3b "
        f"cell's sequence-parallel rules under activation_sharding: "
        f"{runs[0]['moved']} redistributes issued by the constraints per "
        f"step; losses {runs[0]['losses']} vs one rank "
        f"{one['losses']} (bar {P17_LOSS_BAR}); per rank-step collective "
        f"payload bytes {runs[0]['bytes'][-1] / 1e9:.4g} GB, the "
        f"reference's weighted result bytes "
        f"{runs[0]['weighted'][-1] / 1e9:.4g} GB, in "
        f"{runs[0]['calls'][-1]} calls, {runs[0]['ms'][-1]:.1f} ms/step; "
        f"(b)'s auto plan {auto['bytes'][-1] / 1e9:.4g} GB payload, "
        f"{auto['weighted'][-1] / 1e9:.4g} GB weighted, "
        f"{auto['calls'][-1]} calls")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    name, sfu = phase_card()
    rates = card_rates(name)
    phase_build()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    err, times = phase_kernels(dev, rates, flush)
    err_b, times_b = phase_batched_kernels(dev, rates, flush)
    err_m, times_m = phase_model_kernels(dev, rates, sfu, flush)
    err.update(err_b)
    err.update(err_m)
    times.update(times_b)
    del flush
    launches = {k: 0 for k in REPLACES}
    n3 = phase_ranking(dev)
    n4 = phase_placement(dev)
    n5 = phase_simulator(dev)
    phase_scenario_c(dev)
    n8 = phase_batched_ranking(dev)
    n9, ens9 = phase_ensemble(dev)
    record = {}
    n11 = phase_serving(dev, record)
    n12 = phase_policies(dev)
    n13 = phase_traffic(dev, ens9)
    n14, clean14 = phase_training(dev, rates, record)
    n15 = phase_families(dev, record)
    _phase16_host_cost(dev)
    # the examples start after every timed phase: they share the card and
    # the host with phase 16 (a)-(c) only, which time nothing
    examples = _start_examples()
    say(f"[16] (d) {len(examples)} examples started on the card, each in "
        f"its own process, after the timed phases")
    try:
        phase_roofline(name, record, examples)
    finally:
        _stop_examples(examples)
    n17 = phase_multirank(dev, ens9, clean14)
    for part in (n3, n4, n5, n8, n9, n11, n12, n13, n14, n15, n17):
        for k, v in part.items():
            launches[k] += v
    for k in launches:
        check(launches[k] > 0, f"{k} never launched on the main path")
    # the main path's shapes: K1 as the fused ranking runs it, K2 as the
    # placement engine's sweep runs it (k = shortlist + 1 = 65), K3 as the
    # batched ranking runs it, K4 as the ensemble's rounds run it (8 lanes
    # of 65,536 nodes, the 5-term score with w_m = 0, k = 65)
    main_key = {"maiz_lohi": ("maiz_lohi", N_BIG, "4term", 0),
                "maiz_topk": ("maiz_topk", N_BIG, "4term", 65),
                "maiz_lohi_b": ("maiz_lohi_b", N_BIG, "4term", 0),
                "maiz_topk_b": ("maiz_topk_b", SIM_N, "5term_wm0_L8", 65)}
    kernels = []
    for k, key in main_key.items():
        ms, plain, (b, by) = times[key]
        kernels.append({
            "name": k, "route": "cuda", "source": REPLACES[k][1],
            "replaces": REPLACES[k][0], "launches": launches[k],
            "max_abs_err": err[k][0], "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None})
    # K5 / K6 at the serving path's shapes (phase 10), launched by phase 11
    for k, (ms, plain, (b, by), lib) in times_m.items():
        kernels.append({
            "name": k, "route": "cuda", "source": REPLACES[k][1],
            "replaces": REPLACES[k][0], "launches": launches[k],
            "max_abs_err": err[k][0], "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib})
    say(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
