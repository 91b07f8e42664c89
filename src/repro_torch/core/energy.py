"""Unified two-part energy/carbon cost model (torch twin of
``repro.core.energy``).

Host instances hold python floats (exact f64, the host loop's accounting
values); :meth:`EnergyModel.device` returns a twin whose leaves are f32
0-d tensors on a device, the values the reference lowers to f32 for its
traced placement path.  ``for_workload`` calibrates chip watts to a
model config's analytic roofline (``workload_roofline``), on the
reference's TPU v5e constants unless ``hw=`` names another row of
``launch.mesh.HARDWARE``.
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

    # ---- workload calibration ----

    def for_workload(self, arch, shape, chips=8, floor=0.3, *,
                     hw="tpu-v5e"):
        """Calibrate dynamic chip power to a model config's roofline util.

        Derives an analytic roofline step time from ``arch`` (a
        ``configs.base.ArchConfig``) and ``shape`` (a ``ShapeSpec``) on
        the ``hw`` row of ``launch.mesh.HARDWARE``; the compute fraction
        of the step scales chip watts between ``floor`` (fully
        memory/IO-bound) and 1.0 (compute-bound)."""
        r = workload_roofline(arch, shape, chips=chips, hw=hw)
        util = r.compute_s / r.step_s if r.step_s > 0 else 1.0
        scale = floor + (1.0 - floor) * min(1.0, util)
        return dataclasses.replace(self,
                                   chip_power_w=self.chip_power_w * scale)


#: Canonical default — reproduces all historical constants exactly.
DEFAULT_ENERGY = EnergyModel()


def workload_roofline(arch, shape, chips=8, *, hw="tpu-v5e"):
    """Analytic roofline for one step of ``arch`` at ``shape``: matmul
    FLOPs on active params + attention FLOPs, weight-pass HBM bytes, no
    compile or count.  The arithmetic is the reference's, in its order.
    The import lives inside the function, as in the reference (core ->
    launch)."""
    from repro_torch.launch.roofline import Roofline

    p_active = arch.active_param_count()
    tokens = shape.tokens
    train = shape.kind == "train"
    fb_mult = 3.0 if train else 1.0  # fwd + bwd ≈ 2x fwd

    # Matmul FLOPs: 2 * P_active per token per pass.
    flops = 2.0 * p_active * tokens * fb_mult
    # Attention FLOPs: 4 * L * d_attn * s_eff per token (QK^T + AV),
    # honoring sliding-window attention via the effective context length.
    if arch.has_attention:
        d_attn = arch.n_heads * arch.head_dim
        s_eff = float(
            min(shape.seq_len, arch.window)
            if arch.attention == "swa"
            else shape.seq_len
        )
        flops += 4.0 * arch.n_layers * d_attn * s_eff * tokens * fb_mult

    # HBM traffic: one weight pass per step (bf16), times seq_len passes
    # for token-by-token decode.
    weight_bytes = 2.0 * p_active
    passes = float(shape.seq_len) if shape.kind == "decode" else 1.0
    bytes_per_dev = weight_bytes * passes / chips

    return Roofline(
        flops_per_device=flops / chips,
        bytes_per_device=bytes_per_dev,
        collective_bytes_per_device=0.0,
        per_kind={},
        chips=chips,
        hw=hw,
    )
