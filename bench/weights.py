"""The model's weights, drawn by the benchmark from the seed on the
device, in the parameter tree the port's ``Model`` takes (its
``template()``: names, shapes, dtypes and the kind of each leaf), with the
benchmark's own generator and scales.

Every normal leaf in the served dtype comes out of one ``torch.randn``
call on a ``torch.Generator`` on the device, a view each, scaled in
place: the embedding by 1, each product's weights by 1/sqrt(fan-in) (the
output head too, which the port starts at zero: a random head makes the
greedy tokens vary), conv taps by 0.5/sqrt(taps).  The float32 leaves
are the norms (1), Mamba's A_log (log 1..n), dt_bias (softplus of it
log-uniform in [1e-3, 0.1]) and D (1); zero-init leaves other than the
head stay 0."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

_NORMAL = ("embed", "fan_in", "fan_last", "small")


def _leaves(tpl: Dict, path: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k in sorted(tpl):
        v = tpl[k]
        out += _leaves(v, path + (k,)) if isinstance(v, dict) \
            else [(path + (k,), v)]
    return out


def _std(p) -> float:
    if p.init == "embed":
        return 1.0
    if p.init == "fan_last":
        return 0.5 / math.sqrt(p.shape[-1])
    if p.init == "small":
        return 0.02
    return 1.0 / math.sqrt(p.shape[-2])     # fan_in and the head


def _is_normal(path: Tuple[str, ...], p) -> bool:
    return p.init in _NORMAL or path[-1] == "lm_head"


def draw(template: Dict, seed: int, device) -> Dict:
    """The parameter tree of ``template`` drawn from ``seed`` on
    ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = _leaves(template)
    normal = [(path, p) for path, p in leaves if _is_normal(path, p)]
    dtypes = {p.dtype for _, p in normal}
    if len(dtypes) != 1:
        raise ValueError(f"normal leaves in several dtypes: {dtypes}")
    total = sum(math.prod(p.shape) for _, p in normal)
    flat = torch.randn(total, generator=gen, dtype=dtypes.pop(),
                       device=device)
    out: Dict = {}
    off = 0
    for path, p in leaves:
        if _is_normal(path, p):
            n = math.prod(p.shape)
            t = flat[off:off + n].view(p.shape).mul_(_std(p))
            off += n
        elif p.init == "ones":
            t = torch.ones(p.shape, dtype=p.dtype, device=device)
        elif p.init == "zeros":
            t = torch.zeros(p.shape, dtype=p.dtype, device=device)
        elif p.init == "s4d":
            row = torch.log(torch.arange(1, p.shape[-1] + 1,
                                         dtype=torch.float32, device=device))
            t = row.expand(p.shape).to(p.dtype).contiguous()
        elif p.init == "dt":
            lo, hi = math.log(1e-3), math.log(0.1)
            u = torch.rand(p.shape, generator=gen, dtype=torch.float32,
                           device=device)
            dt = torch.exp(lo + u * (hi - lo))
            t = (dt + torch.log(-torch.expm1(-dt))).to(p.dtype)
        else:
            raise ValueError(f"{'/'.join(path)}: no recipe for leaf kind "
                             f"{p.init!r}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out
