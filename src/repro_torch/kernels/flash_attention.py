"""K5: causal GQA flash attention for Hopper (twin of
``repro.kernels.flash_attention``).

``flash_attention(q, k, v, window=...)`` takes q (B, H, S, hd) and k/v
(B, K, S, hd) with H % K == 0 (query head h reads kv head h // (H / K)),
masks causally and, with ``window > 0``, to the band row - window < col <=
row, accumulates in f32 and returns q's dtype.  On CUDA tensors it launches
a CUDA kernel of ``csrc/flash_attention.cu`` (replaces ``_flash_kernel``;
bound and design are noted there), built with ``nvcc`` at first use: bf16
runs on the tensor cores (``mma.sync``), f32 as register-tiled FMAs on the
FP32 pipes; ``variant`` names the kernel a call takes.  On CPU tensors it
runs the plain torch version ``attention_plain``, the math of
``repro.kernels.ref.attention_ref``.  Meta tensors get the output's
shape; any other device raises.
``flash_attention.launches`` counts kernel launches, and
``flash_attention.route_launches`` splits them by route (``"bf16"``,
``"f32"``).

The public call goes through the custom op
``torch.ops.repro_torch.flash_attention``, so a ``TorchDispatchMode`` (the
step-cost counter, ``FlopCounterMode``) sees one op whose FLOPs and bytes
are ``k5_cost``'s, and a meta tensor gets its output shape with no launch
(the dry run).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "flash_attention.cu"
NVCC_FLAGS = _build.BASE_FLAGS
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def k5_cost(B: int, H: int, K: int, S: int, hd: int, window: int,
            dtype: torch.dtype):
    """(FLOPs, bytes) of one call: the two products over the live (row,
    key) pairs of the causal (banded, with ``window > 0``) mask, 4 FLOPs
    per (pair, head, dim); q and o (B, H, S, hd) and k and v (B, K, S, hd)
    each moved once in ``dtype``."""
    es = 2 if dtype == torch.bfloat16 else 4
    nbytes = es * S * hd * (2 * B * H + 2 * B * K)
    if window > 0:
        m = min(S, window)          # rows r < window see r + 1 keys
        pairs = m * (m + 1) // 2 + (S - m) * window
    else:
        pairs = S * (S + 1) // 2
    return 4 * B * H * hd * pairs, nbytes


def flash_attention_cost(q, k, v, window: int = 0):
    """``k5_cost`` of a call on these tensors."""
    B, H, S, hd = q.shape
    return k5_cost(B, H, k.shape[1], S, hd, int(window), q.dtype)


def variant(dtype: torch.dtype, hd: int, aligned: bool = True) -> str:
    """The kernel the launcher runs for q's dtype and head dim, as
    ``route-kernel-HD[-staging]``: bf16 on the tensor cores (``mma``), f32
    on the FP32 pipes (``fma``), each with 16-byte ``cp.async`` copies when
    its rows are 16-byte multiples (``hd % 8 == 0`` in bf16, ``hd % 4 ==
    0`` in f32) and every tensor is 16-byte aligned (``aligned``), else the
    same kernel staging element by element (``-elementwise``).  HD is the
    instantiated head dim (64 or 128) that hd is padded to.  Raises for a
    dtype or head dim no kernel takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes f32 or bf16, not {dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is not in [1, {MAX_HEAD_DIM}]")
    HD = 64 if hd <= 64 else 128
    f32 = dtype == torch.float32
    vec = hd % (4 if f32 else 8) == 0 and aligned
    return (f"f32-fma-{HD}" if f32 else f"bf16-mma-{HD}") + (
        "" if vec else "-elementwise")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal (optionally banded) GQA attention in plain torch: f32 scores,
    softmax and products, q's dtype out."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    g = H // K
    qf = q.reshape(B, K, g, S, hd).float()
    s = torch.einsum("bkgsh,bkth->bkgst", qf, k.float()) * (hd ** -0.5)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bkth->bkgsh", w, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p] * 4 + [i] * 7 + [
        ctypes.c_float, i, p]
    lib.flash_attention_launch.restype = i


def _check_shapes(q, k, v) -> None:
    """What the kernel refuses besides the device: shapes, dtypes, head
    dims (the meta route checks these too)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q (B, H, S, hd) and k/v "
                         f"(B, K, S, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    if k.shape[0] != B or k.shape[2:] != (S, hd) or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (need H % K == 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention takes q/k/v of one dtype, f32 or "
                         f"bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    variant(q.dtype, hd)


def _check_args(q, k, v) -> None:
    _check_shapes(q, k, v)
    for t in (q, k, v):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("flash_attention's kernel takes contiguous "
                             f"CUDA tensors; got one on {t.device}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int = 0) -> torch.Tensor:
    """The kernel's launch on CUDA tensors, without the custom op's
    dispatch (``flash_attention`` calls it through the op)."""
    _check_args(q, k, v)
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    vec = not variant(q.dtype, hd, aligned).endswith("elementwise")
    lib = _build.load(SOURCE, NVCC_FLAGS, _bind)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, H, k.shape[1], S, hd, int(window),
        hd ** -0.5, int(vec), stream), "flash_attention")
    flash_attention.launches += 1
    flash_attention.route_launches[_ROUTES[q.dtype]] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_plain(q, k, v, window=window)
    return launch(q, k, v, window)


@_flash_attention_op.register_fake
def _(q, k, v, window):
    _check_shapes(q, k, v)
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _(q, k, v, window, *, out_val=None):
    return flash_attention_cost(q, k, v, window)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal GQA attention: q (B, H, S, hd), k/v (B, K, S, hd) -> (B, H,
    S, hd) in q's dtype.  CPU tensors: the plain version; CUDA tensors:
    the kernel (built at first use, or the call raises); meta tensors: the
    output's shape."""
    return torch.ops.repro_torch.flash_attention(q, k, v, int(window))


flash_attention.launches = 0
flash_attention.route_launches = {"bf16": 0, "f32": 0}
