"""K6: the selective scan for Hopper (twin of
``repro.kernels.selective_scan``).

``selective_scan(dt, x, b, c, a)`` runs ``h_t = exp(dt_t·A) ⊙ h_{t-1} +
(dt_t·x_t) ⊗ B_t`` from h₀ = 0 and returns ``y_t = Σ_N h_t ⊙ C_t`` (B, S,
D) in x's dtype together with the final state h_S (B, D, N) in f32, which
prefill hands to the decode cache.  dt/x (B, S, D) share a dtype (f32 or
bf16); b/c (B, S, N) and a are f32.  a is (D, N), Mamba-1's decay per
(channel, state), or (D,), the per-channel form Mamba-2 takes (its decay
per head repeated over the head's channels, the same for every state):
then exp(dt·a) is one value per (b, t, d), bitwise the value the (D, N)
form computes N times over when a is broadcast.  On CUDA tensors it
launches the CUDA kernel ``csrc/selective_scan.cu`` (replaces
``_scan_kernel``; bound and design are noted there), built with ``nvcc``
at first use; on CPU tensors it runs the plain step-by-step loop
``selective_scan_plain``, the recurrence of
``repro.kernels.ref.selective_scan_ref``.  Meta tensors get the outputs'
shapes; any other device raises.
``selective_scan.launches`` counts kernel launches and
``selective_scan.route_launches`` splits them by the decay's form
(``"dn"``: (D, N); ``"per_channel"``: (D,)).

The public call goes through the custom op
``torch.ops.repro_torch.selective_scan``, so a ``TorchDispatchMode`` (the
step-cost counter, ``FlopCounterMode``) sees one op whose FLOPs and bytes
are ``k6_cost``'s, and meta tensors get the outputs' shapes with no
launch (the dry run).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "selective_scan.cu"
NVCC_FLAGS = _build.BASE_FLAGS
# the kernel's instantiated N: for a (D, N) decay (Mamba-1) and for a
# per-channel (D,) decay (Mamba-2: zamba2's 64, and 16 at reduced size)
STATE_SIZES = (8, 16)
PER_CHANNEL_STATE_SIZES = (16, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def k6_cost(B: int, S: int, D: int, N: int, dtype: torch.dtype,
            per_channel: bool = False):
    """(FLOPs, bytes) of one call: 5 FLOPs per (b, t, d, n) (the decay
    product, the input product, the state update and y's product and
    sum; the exps are not counted); dt, x and y (B, S, D) in ``dtype``,
    B and C (B, S, N), A (D, N), or (D,) in the per-channel form, and the
    final state (B, D, N) in f32, each moved once."""
    es = 2 if dtype == torch.bfloat16 else 4
    a = D if per_channel else D * N
    nbytes = 3 * es * B * S * D + 4 * (2 * B * S * N + a + B * D * N)
    return 5 * B * S * D * N, nbytes


def selective_scan_cost(dt, x, b, c, a):
    """``k6_cost`` of a call on these tensors."""
    B, S, D = x.shape
    return k6_cost(B, S, D, b.shape[-1], x.dtype, a.dim() == 1)


def variant(dtype: torch.dtype, D: int, aligned: bool = True) -> str:
    """How the launcher stages dt/x for their dtype and channel count:
    ``"<dtype>-cp.async"`` (16-byte copies) when a row of D channels is a
    whole number of 16-byte copies and every tensor is 16-byte aligned
    (``aligned``), else ``"<dtype>-elementwise"`` (the same kernel,
    staging element by element).  Raises for a dtype the kernel does not
    take."""
    if dtype not in _DTYPES:
        raise ValueError(f"selective_scan takes dt/x in f32 or bf16, not "
                         f"{dtype}")
    name = "f32" if dtype == torch.float32 else "bf16"
    per_copy = 16 // (4 if dtype == torch.float32 else 2)
    vec = D % per_copy == 0 and aligned
    return f"{name}-" + ("cp.async" if vec else "elementwise")


def selective_scan_plain(dt, x, b, c, a
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence step by step over S in plain torch: (y in x's dtype,
    h_S f32).  a (D, N), or (D,) for one decay per channel (its exp taken
    once per (b, t, d) and broadcast over the N states)."""
    Bsz, S, D = x.shape
    dtf, xf, bf, cf = dt.float(), x.float(), b.float(), c.float()
    h = torch.zeros((Bsz, D, b.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        if a.dim() == 1:
            da = torch.exp(dtf[:, t] * a)[..., None]       # (B, D, 1)
        else:
            da = torch.exp(dtf[:, t, :, None] * a)         # (B, D, N)
        dbx = (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.sum(h * cf[:, t, None, :], dim=-1))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, D))
    return y.to(x.dtype), h


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_launch.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.selective_scan_launch.restype = i


def _check_shapes(dt, x, b, c, a) -> None:
    """What the kernel refuses besides the device: shapes, dtypes, state
    sizes (the meta route checks these too)."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"dt/x must be (B, S, D); got {tuple(dt.shape)}, "
                         f"{tuple(x.shape)}")
    B, S, D = x.shape
    N = b.shape[-1]
    if (b.shape != (B, S, N) or c.shape != (B, S, N)
            or a.shape not in ((D, N), (D,))):
        raise ValueError(f"b/c must be ({B}, {S}, N) and a (D={D}, N) or "
                         f"(D,); got {tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(a.shape)}")
    sizes = PER_CHANNEL_STATE_SIZES if a.dim() == 1 else STATE_SIZES
    if N not in sizes:
        raise ValueError(f"state size N={N} is not one of {sizes} for a "
                         f"of shape {tuple(a.shape)}")
    if (x.dtype not in _DTYPES or dt.dtype != x.dtype
            or {b.dtype, c.dtype, a.dtype} != {torch.float32}):
        raise ValueError("selective_scan takes dt/x of one dtype, f32 or "
                         "bf16, and f32 b/c/a; got "
                         f"{[t.dtype for t in (dt, x, b, c, a)]}")


def _check_args(dt, x, b, c, a) -> None:
    _check_shapes(dt, x, b, c, a)
    for t in (dt, x, b, c, a):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("selective_scan's kernel takes contiguous "
                             f"CUDA tensors; got one on {t.device}")


def launch(dt, x, b, c, a) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch on CUDA tensors, without the custom op's
    dispatch (``selective_scan`` calls it through the op)."""
    _check_args(dt, x, b, c, a)
    B, S, D = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (dt, x, b, c, a, y, h_last))
    vec = variant(x.dtype, D, aligned).endswith("cp.async")
    lib = _build.load(SOURCE, NVCC_FLAGS, _bind)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.selective_scan_launch(
        dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), y.data_ptr(), h_last.data_ptr(), _DTYPES[x.dtype],
        B, S, D, N, int(a.dim() == 1), int(vec), stream), "selective_scan")
    selective_scan.launches += 1
    selective_scan.route_launches["per_channel" if a.dim() == 1
                                  else "dn"] += 1
    return y, h_last


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _selective_scan_op(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return selective_scan_plain(dt, x, b, c, a)
    return launch(dt, x, b, c, a)


@_selective_scan_op.register_fake
def _(dt, x, b, c, a):
    _check_shapes(dt, x, b, c, a)
    B, S, D = x.shape
    return (torch.empty_like(x),
            x.new_empty((B, D, b.shape[-1]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.selective_scan, get_raw=True)
def _(dt, x, b, c, a, *, out_val=None):
    return selective_scan_cost(dt, x, b, c, a)[0]


def selective_scan(dt, x, b, c, a) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, D) in x's dtype, h_S (B, D, N) f32).  CPU tensors: the
    plain version; CUDA tensors: the kernel (built at first use, or the
    call raises); meta tensors: the outputs' shapes."""
    return torch.ops.repro_torch.selective_scan(dt, x, b, c, a)


selective_scan.launches = 0
selective_scan.route_launches = {"dn": 0, "per_channel": 0}
