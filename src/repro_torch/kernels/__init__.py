"""Rank kernels (CUDA for Hopper) with their plain torch twins."""
