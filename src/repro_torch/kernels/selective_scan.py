"""K6: the selective scan for Hopper (twin of
``repro.kernels.selective_scan``).

``selective_scan(dt, x, b, c, a)`` runs ``h_t = exp(dt_t·A) ⊙ h_{t-1} +
(dt_t·x_t) ⊗ B_t`` from h₀ = 0 and returns ``y_t = Σ_N h_t ⊙ C_t`` (B, S,
D) in x's dtype together with the final state h_S (B, D, N) in f32, which
prefill hands to the decode cache.  dt and x share a dtype (f32 or bf16);
b/c (B, S, N) and a are f32.  Two forms:

- a (D, N) with dt (B, S, D): Mamba-1's decay per (channel, state);
- a (H,) with dt (B, S, H), D a multiple of H: Mamba-2's per-head form,
  one step and one decay per head of P = D / H channels, the same for
  every state.  Channel d takes head d // P; exp(dt·a) is one value per
  (b, t, head), bitwise the value the (D, N) form computes P·N times over
  on dt repeated over each head's channels and a broadcast to (D, N).
  H = D (dt (B, S, D), a (D,)) is the per-channel case.

On CUDA tensors it launches the CUDA kernel ``csrc/selective_scan.cu``
(replaces ``_scan_kernel``; bound and design are noted there), built with
``nvcc`` at first use; on CPU tensors it runs the plain step-by-step loop
``selective_scan_plain``, the recurrence of
``repro.kernels.ref.selective_scan_ref``.  Meta tensors get the outputs'
shapes; any other device raises.  ``selective_scan.launches`` counts
kernel launches and ``selective_scan.route_launches`` splits them by the
decay's form (``"dn"``: (D, N); ``"per_channel"``: the per-head form); a
CUDA graph that captured launches adds them on each replay
(``count_launches``).

The public call goes through the custom op
``torch.ops.repro_torch.selective_scan``, so a ``TorchDispatchMode`` (the
step-cost counter, ``FlopCounterMode``) sees one op whose FLOPs and bytes
are ``k6_cost``'s, and meta tensors get the outputs' shapes with no
launch (the dry run).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "selective_scan.cu"
NVCC_FLAGS = _build.BASE_FLAGS
# the kernel's instantiated N: for a (D, N) decay (Mamba-1) and for a
# per-head (H,) decay (Mamba-2: zamba2's 64, and 16 at reduced size)
STATE_SIZES = (8, 16)
PER_HEAD_STATE_SIZES = (16, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def k6_cost(B: int, S: int, D: int, N: int, dtype: torch.dtype,
            heads: Optional[int] = None):
    """(FLOPs, bytes) of one call: 5 FLOPs per (b, t, d, n) (the decay
    product, the input product, the state update and y's product and
    sum; the exps are not counted); x and y (B, S, D) in ``dtype``, B and
    C (B, S, N), the final state (B, D, N) in f32, and dt (B, S, D) in
    ``dtype`` with A (D, N) f32, or in the per-head form (``heads`` H) dt
    (B, S, H) with A (H,), each moved once."""
    es = 2 if dtype == torch.bfloat16 else 4
    steps, a = (D, D * N) if heads is None else (heads, heads)
    nbytes = (es * B * S * (2 * D + steps)
              + 4 * (2 * B * S * N + a + B * D * N))
    return 5 * B * S * D * N, nbytes


def selective_scan_cost(dt, x, b, c, a):
    """``k6_cost`` of a call on these tensors."""
    B, S, D = x.shape
    return k6_cost(B, S, D, b.shape[-1], x.dtype,
                   a.shape[0] if a.dim() == 1 else None)


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
    h_S f32).  a (D, N) with dt (B, S, D), or a (H,) with dt (B, S, H):
    then exp(dt·a) is taken once per (b, t, head) and broadcast over the
    head's P = D / H channels and the N states, and dt·x takes the head's
    dt for each of its channels."""
    Bsz, S, D = x.shape
    N = b.shape[-1]
    dtf, xf, bf, cf = dt.float(), x.float(), b.float(), c.float()
    h = torch.zeros((Bsz, D, N), dtype=torch.float32, device=x.device)
    H = a.shape[0]
    ys = []
    for t in range(S):
        if a.dim() == 1:
            da = torch.exp(dtf[:, t] * a)[:, :, None, None]   # (B, H, 1, 1)
            dtx = (dtf[:, t, :, None]
                   * xf[:, t].reshape(Bsz, H, D // H)).reshape(Bsz, D)
            dah = (da * h.view(Bsz, H, D // H, N)).view(Bsz, D, N)
        else:
            dtx = dtf[:, t] * xf[:, t]
            dah = torch.exp(dtf[:, t, :, None] * a) * h        # (B, D, N)
        h = dah + dtx[..., None] * bf[:, t, None, :]
        ys.append(torch.sum(h * cf[:, t, None, :], dim=-1))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, D))
    return y.to(x.dtype), h


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_launch.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.selective_scan_launch.restype = i


def _check_shapes(dt, x, b, c, a) -> None:
    """What the kernel refuses besides the device: shapes, dtypes, state
    sizes (the meta and CPU routes check these too)."""
    if x.dim() != 3 or dt.dim() != 3 or dt.shape[:2] != x.shape[:2]:
        raise ValueError(f"dt/x must be (B, S, H) / (B, S, D); got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    B, S, D = x.shape
    N = b.shape[-1]
    if (b.shape != (B, S, N) or c.shape != (B, S, N)
            or a.dim() not in (1, 2)):
        raise ValueError(f"b/c must be ({B}, {S}, N) and a (D={D}, N) or "
                         f"(H,); got {tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(a.shape)}")
    if a.dim() == 2 and (a.shape != (D, N) or dt.shape[-1] != D):
        raise ValueError(f"a (D, N) takes dt (B, S, D) and a ({D}, {N}); "
                         f"got dt {tuple(dt.shape)}, a {tuple(a.shape)}")
    if a.dim() == 1:
        H = a.shape[0]
        if dt.shape[-1] != H:
            raise ValueError(f"dt's last dim {dt.shape[-1]} is not a's "
                             f"length {H} (the heads)")
        if H == 0 or D % H:
            raise ValueError(f"D={D} channels are no multiple of H={H} "
                             f"heads")
    sizes = PER_HEAD_STATE_SIZES if a.dim() == 1 else STATE_SIZES
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
        B, S, D, N, a.shape[0] if a.dim() == 1 else 0, int(vec), stream),
        "selective_scan")
    count_launches("per_channel" if a.dim() == 1 else "dn")
    return y, h_last


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _selective_scan_op(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        _check_shapes(dt, x, b, c, a)
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
    """(y (B, S, D) in x's dtype, h_S (B, D, N) f32) of dt (B, S, D) and a
    (D, N), or dt (B, S, H) and a (H,).  CPU tensors: the
    plain version; CUDA tensors: the kernel (built at first use, or the
    call raises); meta tensors: the outputs' shapes."""
    return torch.ops.repro_torch.selective_scan(dt, x, b, c, a)


def count_launches(route: str, n: int = 1) -> None:
    """Add ``n`` launches of ``route`` to ``selective_scan``'s counters: one
    for each launch here, and a CUDA graph's captured launches on each of
    its replays (``repro_torch._graphs``; its capture takes back, with a
    negative ``n``, what it counted while nothing ran)."""
    selective_scan.launches += n
    selective_scan.route_launches[route] += n


selective_scan.launches = 0
selective_scan.route_launches = {"dn": 0, "per_channel": 0}
