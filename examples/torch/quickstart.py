"""Quickstart on the PyTorch port: the three layers of the framework in
~60 lines (``examples/quickstart.py`` on ``repro_torch``).

1. MAIZX ranks a fleet and picks the greenest pod            (the paper)
2. a model from the assigned-architecture zoo trains on it  (substrate)
3. the serving path decodes from the trained weights        (substrate)

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
(the card unless ``--device`` names another device).  Parameters are drawn
with ``torch.Generator``, so the losses and tokens differ from the JAX
example's.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.fleet import synthetic_fleet
from repro_torch.core.scheduler import place_jobs
from repro_torch.launch.train import train_loop
from repro_torch.models.model import ModelFlags, build_model
from repro_torch.serve.engine import ServeEngine


def main(device=None):
    # -- 1. carbon-aware placement (MAIZ_RANKING, Eq. 1) -------------------
    fleet = synthetic_fleet(128, seed=0, device=device)
    placement = place_jobs(fleet, demands=torch.tensor(
        [64], dtype=torch.int32, device=fleet.ci_now.device))
    pod = int(placement.node[0])
    print(f"MAIZX placed the job on pod {pod}: "
          f"CI={float(fleet.ci_now[pod]):.0f} gCO2/kWh, "
          f"PUE={float(fleet.pue[pod]):.2f} "
          f"(fleet mean CI {float(fleet.ci_now.mean()):.0f})")

    # -- 2. train a reduced llama3.2 on a zipf LM task ---------------------
    # ('random' = skewed unigram stream: visible learning within ~40 steps)
    run = train_loop("llama3.2-3b", steps=40, batch=8, seq=64, reduced=True,
                     task="random", log_every=10, lr=1e-3, device=device)
    print(f"loss: {run.losses[0]:.3f} -> {run.losses[-1]:.3f} "
          f"(ln V = {np.log(ARCHS['llama3.2-3b'].reduced().vocab):.3f})")

    # -- 3. serve from the trained weights ---------------------------------
    cfg = ARCHS["llama3.2-3b"].reduced()
    model = build_model(cfg, ModelFlags(attn_chunk=32))
    engine = ServeEngine(model, run.final_state.params, max_seq=96,
                         batch_slots=2, device=device)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab, (2, 12)).astype(
        np.int32)
    for r in engine.generate(prompts, max_new=8):
        print("generated:", r.tokens)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
