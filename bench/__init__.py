"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic
mix, driver, reference family or metric is a file of its own, found by
the name ``BENCHMARK.json`` or the cell's files give it:

- ``configs/<config>.json``: the sizes as run, the source, ``reduced``;
- ``traffic/<mix>.json``: the parameters the mix's driver reads;
- ``drivers/<driver>.py``: the entry a window drives (``run(ctx)``);
- ``reference/<family>.py``: the plain float32 forward (``logits``);
- ``costs/<family>.py``: the family's FLOPs, ``costs/kernels.py`` the
  kernels' operations and bytes, ``costs/peaks.json`` the card's peaks;
- ``metrics/<metric>.py``: one reader a metric (``read(run)``);
- ``limits/<cell>.json``: the limits of the cell's correctness check,
  with the readings ``calibrate.py`` took them from (``faults.py``: the
  faults it plants under the timed path).

Nothing here imports ``jax`` or the JAX package ``repro``.
"""
