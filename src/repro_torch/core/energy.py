"""Unified two-part energy/carbon cost model (torch twin of
``repro.core.energy``).

Host instances hold python floats (exact f64, the host loop's accounting
values); :meth:`EnergyModel.device` returns a twin whose leaves are f32
0-d tensors on a device, the values the reference lowers to f32 for its
traced placement path.  ``for_workload``/``workload_roofline`` (the
roofline calibration) are not ported yet: ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.carbon import CHIP_POWER_W, HOST_POWER_W

#: Historical idle floor: an idle-but-on node draws this fraction of
#: nameplate power.
_IDLE_POWER_FRAC = 0.35


@dataclass(frozen=True)
class EnergyModel:
    """Two-part (dynamic + embodied) energy/carbon model.

    ``dyn_frac`` is stored explicitly rather than recomputed as
    ``1 - idle_frac`` on the device so the f64→f32 rounding happens once,
    host-side, exactly as in the reference."""

    idle_frac: float = _IDLE_POWER_FRAC
    chip_power_w: float = CHIP_POWER_W
    host_power_w: float = HOST_POWER_W
    #: Amortized embodied carbon charged per node-hour while powered on.
    embodied_g_per_node_h: float = 0.0
    #: Weight of the marginal-CFP ranking term (0 = historical ranking).
    w_marginal: float = 0.0
    #: Dynamic fraction; derived from ``idle_frac`` unless given.
    dyn_frac: Optional[float] = None
    #: Chips per host board (indexes the host-power share).
    chips_per_host: int = 8

    def __post_init__(self):
        if self.dyn_frac is None:
            object.__setattr__(self, "dyn_frac", 1.0 - self.idle_frac)

    # ---- per-job energy (mirrors carbon.job_energy_kwh op-for-op) ----

    def job_energy_kwh(self, step_time_s, steps, chips):
        wall_s = step_time_s * steps
        watts = chips * self.chip_power_w + (
            chips / float(self.chips_per_host)
        ) * self.host_power_w
        return wall_s / 3600.0 * watts / 1000.0

    @property
    def e_kwh_h(self):
        """kWh for one chip-hour (0.30625 for the default model)."""
        return self.job_energy_kwh(3600.0, 1, 1)

    def ckpt_kwh(self, overhead_h):
        """kWh for one chip checkpointing for ``overhead_h`` hours."""
        return self.job_energy_kwh(overhead_h * 3600.0, 1, 1)

    def req_kwh(self, service_s):
        """kWh for one served request (one chip busy ``service_s``)."""
        return self.job_energy_kwh(service_s, 1, 1)

    # ---- fleet-level power ----

    @property
    def chip_kw(self):
        """Chip-only kW (0.25 default) — nameplate unit for fleet power_kw."""
        return self.chip_power_w / 1000.0

    @property
    def watts_per_chip(self):
        """Full per-chip draw incl. amortized host share (306.25 default)."""
        return (self.chip_power_w
                + self.host_power_w / float(self.chips_per_host))

    def node_kw(self, chips):
        """Nameplate node kW incl. host share for ``chips`` chips."""
        return chips * self.watts_per_chip / 1000.0

    # ---- variants ----

    def with_marginal(self, w_marginal):
        return dataclasses.replace(self, w_marginal=float(w_marginal))

    def device(self, w_marginal=None, *, device: DeviceLike = None
               ) -> "EnergyModel":
        """f32 0-d-tensor twin on ``device``; optionally override
        ``w_marginal``."""
        dev = resolve_device(device)
        wm = self.w_marginal if w_marginal is None else float(w_marginal)

        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=dev)

        return EnergyModel(
            idle_frac=f32(self.idle_frac),
            chip_power_w=f32(self.chip_power_w),
            host_power_w=f32(self.host_power_w),
            embodied_g_per_node_h=f32(self.embodied_g_per_node_h),
            w_marginal=f32(wm),
            dyn_frac=f32(self.dyn_frac),
            chips_per_host=self.chips_per_host,
        )

    def for_workload(self, arch, shape, chips=8, floor=0.3):
        raise NotImplementedError(
            "EnergyModel.for_workload needs the roofline layer, which is "
            "not ported yet (ROADMAP Queue 1 item 11)")


#: Canonical default — reproduces all historical constants exactly.
DEFAULT_ENERGY = EnergyModel()
