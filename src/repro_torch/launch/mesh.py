"""Hardware constants of the roofline report (the constants half of
``repro.launch.mesh``).

The TPU v5e constants (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW``,
``CHIPS_PER_POD``) are the reference's, kept as the parity default of
``launch.roofline`` and ``core.energy``.  ``HARDWARE`` holds one row per
device, selected by name: ``"tpu-v5e"`` and the NVIDIA H100 / H200 rows
the port runs on.  ``CARDS`` maps a CUDA device name
(``torch.cuda.get_device_name``) to its row, first match wins.

The mesh builders (``make_production_mesh``, ``make_host_mesh``) need
more than one device and wait for ROADMAP Queue 1 item 1(b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
