"""Plain float32 forwards of each model family, in PyTorch alone: no JAX,
no ``repro``, nothing of ``repro_torch``.  ``<family>.logits(cfg,
params, tokens, first)`` gives the logits at positions ``first`` and
after of every row, recomputing every key, value and state from the
tokens.  ``precision="fp8"`` rounds the inputs of every product with a
weight to float8 e4m3 (the correctness check's control)."""
