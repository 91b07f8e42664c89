"""Checkpoint save/restore in the JAX package's on-disk format (twin of
``repro.train.checkpoint``).

Format: one ``.npy`` per tree leaf, named by its ``/``-joined key path
with ``/`` as ``__``, plus ``manifest.json`` (step, the caller's
``extra`` such as the data-pipeline state, and each leaf's file, shape
and dtype name).  numpy has no bfloat16, so bf16 leaves are stored as
their uint16 bits under the dtype name ``"bfloat16"`` (float8 likewise as
uint8), exactly as the JAX package stores them: a checkpoint written by
either package restores bit for bit in the other.

Writes are atomic (``step_<n>.tmp`` then a rename) and versioned
(``step_<n>``); the ``latest`` symlink flips last, so a crash mid-write
never corrupts the previous checkpoint.

A state of DTensors (laid out on a ``DeviceMesh``) saves to the same
files, byte for byte, as a one-device save of the same values: every rank
of the mesh gathers each leaf, global rank 0 writes, and the mesh's ranks
wait for the write before they return.  ``restore`` places every leaf on
one device (the card unless told otherwise), or, given ``shardings`` (a
tree of ``sharding.Sharding``, e.g. ``tree_shardings`` of the template on
any mesh), lays each leaf out on its mesh: a checkpoint written on one
mesh restores onto another, or onto one device — the reference's
migration and elastic-rescale primitive.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.convert import bf16_bits, bf16_from_bits
from repro_torch.distributed.sharding import (is_dtensor, replicated_local,
                                              tree_leaves)

# dtypes numpy cannot hold, stored as same-width unsigned ints
_BITS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
         "float8_e5m2": np.uint8}


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{key path: leaf} in ``jax.tree_util`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        flat: Dict[str, Any] = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).split(".")[-1]
        if name == "bfloat16":
            return bf16_bits(leaf), name
        if name in _BITS:
            return leaf.detach().cpu().view(torch.uint8).numpy(), name
        return leaf.detach().cpu().numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str,
                device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return bf16_from_bits(arr).to(device)
    if dtype_name in _BITS:
        t = torch.from_numpy(np.array(arr)).view(getattr(torch, dtype_name))
        return t.to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` has arrived: a barrier over each mesh
    dimension's group in turn covers the whole grid."""
    for d in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(d))


def save(ckpt_dir: str, state, step: int,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Write checkpoint atomically; returns the final directory.  With
    DTensor leaves every rank of their mesh calls it; rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    meshes = [x.device_mesh for x in tree_leaves(state) if is_dtensor(x)]
    writer = not meshes or dist.get_rank() == 0
    tmp = final + ".tmp"
    if writer:
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten(state).items():
        leaf = replicated_local(leaf)
        if not writer:
            continue
        arr, dtype_name = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype_name}
    if writer:
        _commit(ckpt_dir, tmp, final, manifest)
    if meshes:
        _mesh_barrier(meshes[0])
    return final


def _commit(ckpt_dir: str, tmp: str, final: str, manifest) -> None:
    """Manifest, rename, then the ``latest`` link."""
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest = os.path.join(ckpt_dir, "latest")
    tmp_link = latest + ".tmp"
    if os.path.lexists(tmp_link):
        os.remove(tmp_link)
    os.symlink(os.path.basename(final), tmp_link)
    os.replace(tmp_link, latest)


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(latest):
        return None
    with open(os.path.join(latest, "manifest.json")) as f:
        return json.load(f)["step"]


def restore(ckpt_dir: str, state_template, shardings=None, *,
            step: Optional[int] = None, device: DeviceLike = None
            ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore the ``latest`` (or the given ``step``) checkpoint.
    ``state_template`` gives the tree structure; a leaf with a ``shape``
    must match the stored shape.  ``shardings`` (same structure, a
    ``Sharding`` or ``None`` per leaf) lays each leaf out on its mesh, the
    rank's devices being ``device``; a ``None`` leaf, or no
    ``shardings``, lands whole on ``device`` (the card unless told
    otherwise).  Returns (tree, step, extra)."""
    dev = resolve_device(device)
    src = (os.path.join(ckpt_dir, "latest") if step is None
           else os.path.join(ckpt_dir, f"step_{step:08d}"))
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]

    def build(tpl, sh, prefix):
        if isinstance(tpl, dict):
            return {k: build(tpl[k], None if sh is None else sh[k],
                             f"{prefix}{k}/") for k in tpl}
        key = prefix[:-1]
        meta = leaves_meta[key]
        shape = getattr(tpl, "shape", None)
        if shape is not None and tuple(shape) != tuple(meta["shape"]):
            raise ValueError(f"{key}: checkpoint shape {meta['shape']} != "
                             f"template {tuple(shape)}")
        arr = np.load(os.path.join(src, meta["file"]), mmap_mode="r")
        full = _from_numpy(arr, meta["dtype"], dev)
        if sh is None:
            return full
        from torch.distributed.tensor import distribute_tensor
        # every rank read the same file: slice it locally, no traffic
        return distribute_tensor(full, sh.mesh, list(sh.placements),
                                 src_data_rank=None)

    return (build(state_template, shardings, ""), manifest["step"],
            manifest["extra"])
