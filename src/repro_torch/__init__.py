"""MAIZX on PyTorch + CUDA (Hopper): the port of ``src/repro``.

The layout mirrors the JAX package module by module (``core/``,
``kernels/``), so every ported file has a twin to be held against.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
GPU and no device given they raise (``_device.resolve_device``).
Functions that receive tensors run on those tensors' device.
"""
