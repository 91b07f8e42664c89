"""Mesh construction and the hardware constants of the roofline report
(twin of ``repro.launch.mesh``).

``make_production_mesh`` gives the reference's (16, 16) pod and (2, 16,
16) multi-pod shapes with its axis names, as a ``MeshShape``: no machine
here has 256 ranks.  ``make_host_mesh`` builds a ``DeviceMesh`` over the
ranks of the default process group (one process and one device per
rank), dropping a size-1 ``pod`` axis as the reference does.
``make_fake_mesh`` builds a production mesh in one process, over a world
of the ``"fake"`` backend (the dry run's mesh: DTensor plans and issues
every collective, and none moves data).

The TPU v5e constants (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW``,
``CHIPS_PER_POD``) are the reference's, kept as the parity default of
``launch.roofline`` and ``core.energy``.  ``HARDWARE`` holds one row per
device, selected by name: ``"tpu-v5e"`` and the NVIDIA H100 / H200 rows
the port runs on.  ``CARDS`` maps a CUDA device name
(``torch.cuda.get_device_name``) to its row, first match wins.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import MeshShape

def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16,16)=256 chips per pod; (2,16,16)=512 chips across 2 pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_fake_mesh(shape: MeshShape):
    """A ``DeviceMesh`` of ``shape`` in this process, over the first
    ``shape.size`` ranks of a ``"fake"``-backend world (this process is
    rank 0; the world is made, of ``shape.size`` ranks, when no process
    group is up).  Its device type is ``meta``: its tensors are meta
    DTensors, and DTensor issues a true all-to-all on it where a CPU mesh
    would fall back to an all-gather.  ``close_fake_world`` ends the
    world."""
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=shape.size)
    elif dist.get_backend() != "fake" or dist.get_world_size() < shape.size:
        raise ValueError(f"a fake {shape} mesh needs a fake world of "
                         f"{shape.size} ranks; the process group is "
                         f"{dist.get_backend()} of {dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("meta", torch.arange(shape.size).reshape(shape.sizes),
                      mesh_dim_names=shape.names)
    _topology(mesh)
    if "pod" in shape.names and len(shape.names) > 1:
        _topology(mesh[tuple(n for n in shape.names if n != "pod")])
    return mesh


# cards per host of the fake mesh, for DTensor's redistribute cost model
# (an H100 host holds 8)
CARDS_PER_HOST = 8


def _topology(mesh) -> None:
    """Fill DTensor's cached topology of ``mesh`` (its redistribute cost
    model asks the mesh's device module for the cards per host, and the
    meta device has none)."""
    from unittest import mock
    from torch.distributed.device_mesh import _mesh_resources
    from torch.distributed.tensor._collective_utils import MeshTopoInfo
    with mock.patch.object(type(_mesh_resources), "num_devices_per_host",
                           staticmethod(lambda device_type: CARDS_PER_HOST)):
        MeshTopoInfo.build_from_mesh(mesh)


def close_fake_world() -> None:
    """End the fake world ``make_fake_mesh`` made (a no-op otherwise)."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def host_mesh_shape(data: int = 1, model: int = 1,
                    pod: int = 1) -> MeshShape:
    """The axes ``make_host_mesh`` builds: ``pod`` only when above 1."""
    names, sizes = [], []
    for n, a in ((pod, "pod"), (data, "data"), (model, "model")):
        if n > 1 or a != "pod":
            names.append(a)
            sizes.append(n)
    return MeshShape(tuple(names), tuple(sizes))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1, *,
                   device: DeviceLike = None):
    """A ``DeviceMesh`` over the first ``pod * data * model`` ranks of the
    default process group, on the ranks' device type (the card unless
    ``device`` says otherwise).  Every rank of the world calls it (the
    mesh's groups are made collectively); ranks past the mesh hold no
    coordinate in it.  Raises ``ValueError`` naming the ranks it needs
    when the world is smaller."""
    shape = host_mesh_shape(data, model, pod)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if shape.size > world:
        raise ValueError(
            f"a {dict(zip(shape.names, shape.sizes))} mesh needs "
            f"{shape.size} ranks; the world has {world} (start one process "
            "per rank with torch.distributed.init_process_group)")
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(shape.size).reshape(shape.sizes)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=shape.names)


# Hardware constants (TPU v5e, per chip) — the reference's.
PEAK_FLOPS_BF16 = 197e12        # FLOP/s
HBM_BW = 819e9                  # B/s
ICI_BW = 50e9                   # B/s per link
CHIPS_PER_POD = 256


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peaks: dense bf16 matrix FLOP/s, device-memory B/s and
    the B/s of one link in one direction (the roofline's three terms),
    plus the f32 rate outside the tensor cores and the dense TF32 rate
    (0 where the device has none listed)."""
    name: str
    peak_flops_bf16: float
    hbm_bw: float
    link_bw: float
    peak_flops_f32: float = 0.0
    peak_flops_tf32: float = 0.0


# H100 / H200 rates: NVIDIA's data sheets (H100 Tensor Core GPU, H200
# Tensor Core GPU), dense (no sparsity), at the full power limit; the link
# is NVLink, per direction: 900 GB/s total on the SXM parts, 600 GB/s
# through the NVLink bridge of the PCIe and NVL parts
HARDWARE = {
    "tpu-v5e": Hardware("tpu-v5e", PEAK_FLOPS_BF16, HBM_BW, ICI_BW),
    "h100-sxm": Hardware("h100-sxm", 989e12, 3.35e12, 450e9, 67e12, 495e12),
    "h100-pcie": Hardware("h100-pcie", 756e12, 2.0e12, 300e9, 51e12,
                          378e12),
    "h100-nvl": Hardware("h100-nvl", 835e12, 3.9e12, 300e9, 60e12, 418e12),
    "h200-sxm": Hardware("h200-sxm", 989e12, 4.8e12, 450e9, 67e12, 495e12),
}

# CUDA device name substring -> HARDWARE row; first match wins
CARDS = (("H100 NVL", "h100-nvl"), ("H100 PCIe", "h100-pcie"),
         ("H100", "h100-sxm"), ("H200", "h200-sxm"))


def hardware_for(device_name: str) -> Optional[str]:
    """The ``HARDWARE`` row of a CUDA device name, or None."""
    for key, row in CARDS:
        if key in device_name:
            return row
    return None
