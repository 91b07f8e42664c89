"""State carried into the port: the fleet, the energy model and the rank
weights, a model's parameters and a whole training state, from plain
numpy arrays / numbers (for example the fields of a reference object read
with ``np.asarray``), and a training state back out.  Feeding both
implementations the same state through here is how the port is held
against the reference."""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.energy import EnergyModel
from repro_torch.core.fleet import FIELDS, Fleet, fleet_tensors
from repro_torch.core.ranking import RankWeights

_ENERGY_FLOATS = ("idle_frac", "chip_power_w", "host_power_w",
                  "embodied_g_per_node_h", "w_marginal", "dyn_frac")
_WEIGHTS = ("w1", "w2", "w3", "w4", "marginal")


def _fields(src: Any, names) -> Dict[str, Any]:
    if isinstance(src, Mapping):
        return {k: src[k] for k in names}
    return {k: getattr(src, k) for k in names}


def fleet_from_numpy(arrays: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> Fleet:
    """The nine ``Fleet`` fields (numpy arrays) as a ``Fleet`` on
    ``device``, cast to the reference's dtypes."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"fleet arrays lack {missing}")
    return fleet_tensors(resolve_device(device), **arrays)


def energy_from_numpy(src: Any) -> EnergyModel:
    """An ``EnergyModel`` from a mapping or an object with its fields."""
    f = _fields(src, _ENERGY_FLOATS + ("chips_per_host",))
    return EnergyModel(**{k: float(np.asarray(f[k])) for k in _ENERGY_FLOATS},
                       chips_per_host=int(f["chips_per_host"]))


def weights_from(src: Any) -> RankWeights:
    """``RankWeights`` from a mapping or an object with w1..w4, marginal."""
    return RankWeights(**{k: float(v) for k, v in
                          _fields(src, _WEIGHTS).items()})


def bf16_from_bits(a: np.ndarray) -> torch.Tensor:
    """A CPU bfloat16 tensor whose bits are the 16-bit array ``a``
    (ml_dtypes' bfloat16, or the uint16 a checkpoint stores)."""
    return torch.from_numpy(
        np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """The bits of a bfloat16 tensor as a uint16 numpy array."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def tensor_from_numpy(a: np.ndarray, device: DeviceLike = None
                      ) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a tensor of the
    same dtype on ``device``."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: reuse bits
        return bf16_from_bits(a).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def params_from_numpy(tree: Mapping, cfg: ArchConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """A model's parameter tree (nested mappings of numpy arrays, e.g.
    ``np.asarray`` of each leaf of the JAX model's ``init``) as the port's
    parameters on ``device``: the same names, shapes and dtypes.  Raises
    when a name or shape differs from ``build_model(cfg).template()``."""
    from repro_torch.models.model import build_model
    dev = resolve_device(device)

    def conv(tpl, src, path):
        if isinstance(tpl, dict):
            if not isinstance(src, Mapping) or set(src) != set(tpl):
                got = sorted(src) if isinstance(src, Mapping) else type(src)
                raise KeyError(f"{path or 'params'}: expected keys "
                               f"{sorted(tpl)}, got {got}")
            return {k: conv(tpl[k], src[k], f"{path}/{k}") for k in tpl}
        a = np.asarray(src)
        if tuple(a.shape) != tuple(tpl.shape):
            raise ValueError(f"{path}: shape {a.shape} != {tpl.shape}")
        return tensor_from_numpy(a, dev)

    return conv(build_model(cfg).template(), tree, "")


def train_state_from_numpy(tree: Mapping, cfg: ArchConfig,
                           device: DeviceLike = None):
    """A training state ``{"params", "opt": {"mu", "nu"}, "step"}`` of
    numpy arrays (``np.asarray`` of each leaf of the JAX ``TrainState``)
    as the port's ``TrainState`` on ``device``, every leaf in its own
    dtype.  Raises when a name or shape differs from the model's
    template."""
    from repro_torch.train.train_step import TrainState
    dev = resolve_device(device)
    return TrainState(
        params=params_from_numpy(tree["params"], cfg, dev),
        opt={k: params_from_numpy(tree["opt"][k], cfg, dev)
             for k in ("mu", "nu")},
        step=torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                          device=dev))


def train_state_to_numpy(state) -> Dict[str, Any]:
    """The port's ``TrainState`` as ``{"params", "opt": {"mu", "nu"},
    "step"}`` of numpy arrays on the host.  bfloat16 leaves come out as
    float32 (exact: numpy has no bfloat16 of its own)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {"params": conv(state.params), "opt": conv(state.opt),
            "step": conv(state.step)}
