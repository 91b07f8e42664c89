"""Kernels (CUDA for Hopper) with their plain torch versions: the rank
kernels K1-K4, flash attention K5, the selective scan K6."""
