#!/usr/bin/env python3
"""Whether the training backwards that add rows at repeated indices are
deterministic on the card at full width: the moonshot-v1-16b-a3b and
phi3.5-moe-42b-a6.6b MoE layers (4 x 512 tokens, bf16; the dispatch
gather reads each token top_k times) and an embedding lookup over
repeated ids (163,840 x 2048 bf16, 4,096 ids of 1,000), each backward run
three times and its gradients compared bit for bit.  Needs one CUDA
device; run from the repository's root:

    python3 tools/train_probe.py

Prints one line a case and exits 1 if any gradients differ.  Phase 14
(f) of ``chip_smoke.py`` checks the same at reduced size for every
trained family, through the whole model."""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _moe_layers(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.models import moe
    out = []
    for arch in ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(arch)
        p = init_tree(moe.moe_template(cfg), 0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        x = (torch.randn(4, 512, cfg.d_model, generator=gen, device=dev)
             * 0.3).to(torch.bfloat16)
        grads = []
        for _ in range(3):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            xl = x.detach().requires_grad_(True)
            y, aux = moe.moe_apply(cfg, leaves, xl)
            (y.float().square().mean() + aux).backward()
            grads.append([xl.grad] + [leaves[k].grad for k in sorted(p)])
        same = all(torch.equal(a, b) for g in grads[1:]
                   for a, b in zip(grads[0], g))
        print(f"{arch} MoE layer, 4 x 512 bf16: the input's and "
              f"{sorted(p)}'s gradients bitwise equal on 3 runs: {same}",
              flush=True)
        out.append(same)
        del p, grads
        torch.cuda.empty_cache()
    return out


def _embedding(dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.randn(163_840, 2048, generator=gen, device=dev,
                        dtype=torch.bfloat16)
    ids = torch.randint(0, 1000, (4, 1024), generator=gen, device=dev)
    weight = torch.arange(2048, device=dev, dtype=torch.float32)
    grads = []
    for _ in range(3):
        t = table.detach().requires_grad_(True)
        (t[ids].float() * weight).sum().backward()
        grads.append(t.grad)
    same = all(torch.equal(grads[0], g) for g in grads[1:])
    print(f"embedding backward, 163,840 x 2048 bf16, 4,096 ids of 1,000: "
          f"bitwise equal on 3 runs: {same}", flush=True)
    return same


def main() -> int:
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    ok = _moe_layers(dev) + [_embedding(dev)]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
