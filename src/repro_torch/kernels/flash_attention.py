"""K5: causal GQA flash attention for Hopper (twin of
``repro.kernels.flash_attention``).

``flash_attention(q, k, v, window=...)`` takes q (B, H, S, hd) and k/v
(B, K, S, hd) with H % K == 0 (query head h reads kv head h // (H / K)),
masks causally and, with ``window > 0``, to the band row - window < col <=
row, accumulates in f32 and returns q's dtype.  On CUDA tensors it launches
a CUDA kernel of ``csrc/flash_attention.cu`` (replaces ``_flash_kernel``;
bound and design are noted there), built with ``nvcc`` at first use, and
routed by shape before the launch (``variant`` names the route): bf16
tensors that TMA can describe (``tma_plan``: any strides with a last stride
of 1 and the others 16-byte multiples, 16-byte aligned bases) go as they
are to ``flash_wgmma_kernel`` (``wgmma`` on a TMA-fed K/V ring), and the
output keeps q's layout; other bf16 tensors go as contiguous copies to
``flash_mma_kernel`` (``mma.sync``, element-wise staging) where hd % 8 or a
base's alignment rules TMA out, else to the wgmma kernel; f32 goes as
contiguous copies to the FMA kernel on the FP32 pipes.  On CPU tensors it
runs the plain torch version ``attention_plain``, the math of
``repro.kernels.ref.attention_ref``.  Meta tensors get the output's
shape; any other device raises.
``flash_attention.launches`` counts kernel launches, and
``flash_attention.route_launches`` splits them by kernel
(``"bf16-wgmma"``, ``"bf16-mma"``, ``"f32"``); a CUDA graph that captured
launches adds them on each replay (``count_launches``).

The public call goes through the custom op
``torch.ops.repro_torch.flash_attention``, so a ``TorchDispatchMode`` (the
step-cost counter, ``FlopCounterMode``) sees one op whose FLOPs and bytes
are ``k5_cost``'s, and a meta tensor gets its output shape with no launch
(the dry run).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "flash_attention.cu"
NVCC_FLAGS = _build.BASE_FLAGS
MAX_HEAD_DIM = 192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the TMA box of flash_wgmma_kernel: 64 dims (128 bytes, the swizzle span)
# x 64 rows of one head of one batch row
TMA_BOX = (64, 64, 1, 1)


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
    ``route-kernel-HD[-staging]``.  bf16: ``wgmma`` (TMA-fed) where its rows
    are 16-byte multiples (``hd % 8 == 0``) and every tensor is 16-byte
    aligned (``aligned``), else ``mma`` staging element by element
    (``-elementwise``).  f32: ``fma`` on the FP32 pipes, with 16-byte
    ``cp.async`` copies where ``hd % 4 == 0`` and ``aligned``, else
    element-wise.  HD is the instantiated head dim (64, 128 or 192) that hd
    is padded to.  Raises for a dtype or head dim no kernel takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes f32 or bf16, not {dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is not in [1, {MAX_HEAD_DIM}]")
    HD = 64 if hd <= 64 else 128 if hd <= 128 else 192
    if dtype == torch.bfloat16:
        if hd % 8 == 0 and aligned:
            return f"bf16-wgmma-{HD}"
        return f"bf16-mma-{HD}-elementwise"
    return f"f32-fma-{HD}" + ("" if hd % 4 == 0 and aligned
                              else "-elementwise")


def _route(name: str) -> str:
    """The counter a variant's launches go to: its kernel."""
    return ("f32" if name.startswith("f32") else
            "bf16-wgmma" if "wgmma" in name else "bf16-mma")


class TmaPlan(NamedTuple):
    """A (B, heads, S, hd) bf16 tensor as a 4-D TMA tensor map takes it:
    ``dims`` innermost first (hd, S, heads, B), ``strides`` the byte
    strides of S, heads and B, ``box`` the tile one copy moves."""
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int] = TMA_BOX


def tma_refusal(t: torch.Tensor) -> Optional[str]:
    """Why TMA cannot describe ``t`` as it is, or None: TMA takes bf16 with
    a last stride of 1, byte strides that are positive 16-byte multiples
    (a dim of size 1 is never stepped over, so any stride does there) and
    a 16-byte aligned base."""
    if t.dtype != torch.bfloat16:
        return f"TMA route is bf16, not {t.dtype}"
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        return f"last stride {t.stride(-1)} is not 1"
    es = t.element_size()
    for n, st in zip(t.shape[:-1], t.stride()[:-1]):
        if n > 1 and (st <= 0 or st * es % 16):
            return f"stride {st * es} bytes is no positive 16-byte multiple"
    if t.data_ptr() % 16:
        return "base is not 16-byte aligned"
    return None


def tma_plan(t: torch.Tensor) -> TmaPlan:
    """``t`` (B, heads, S, hd) as ``flash_wgmma_kernel``'s tensor maps take
    it, from its own strides; raises ValueError where ``tma_refusal``
    says why not.  A dim of size 1 gets the row pitch rounded up to 16
    bytes as its stride."""
    why = tma_refusal(t)
    if why is not None:
        raise ValueError(f"TMA cannot describe {tuple(t.shape)} strides "
                         f"{t.stride()}: {why}")
    B, heads, S, hd = t.shape
    es = t.element_size()
    pitch = -(-hd * es // 16) * 16
    strides = tuple(st * es if n > 1 else pitch
                    for n, st in zip((S, heads, B),
                                     (t.stride(2), t.stride(1), t.stride(0))))
    return TmaPlan((hd, S, heads, B), strides)


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
    u64 = ctypes.POINTER(ctypes.c_ulonglong)
    lib.flash_wgmma_launch.argtypes = [p] * 4 + [u64, u64, i,
                                                 ctypes.c_float, p]
    lib.flash_wgmma_launch.restype = i


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
    """What the launcher refuses: besides ``_check_shapes``, tensors off
    the card.  Strides are the route's business: the wgmma kernel reads
    whatever TMA describes, and the rest goes as contiguous copies."""
    _check_shapes(q, k, v)
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError("flash_attention's kernel takes CUDA tensors; "
                             f"got one on {t.device}")


def _staged(q, k, v):
    """q, k, v as the kernel reads them: as they are where TMA describes
    all three (bf16), else contiguous."""
    if all(tma_refusal(t) is None for t in (q, k, v)):
        return q, k, v
    return tuple(t.contiguous() for t in (q, k, v))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int = 0) -> torch.Tensor:
    """The kernel's launch on CUDA tensors, without the custom op's
    dispatch (``flash_attention`` calls it through the op).  The output
    is ``torch.empty_like(q)`` on every route (q's layout where q is
    dense), as the meta and CPU forms give it."""
    _check_args(q, k, v)
    out = torch.empty_like(q)
    q, k, v = _staged(q, k, v)
    B, H, S, hd = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    name = variant(q.dtype, hd, aligned)
    lib = _build.load(SOURCE, NVCC_FLAGS, _bind)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name.startswith("bf16-wgmma"):
        plans = [tma_plan(t) for t in (q, k, v, out)]
        dims = (ctypes.c_ulonglong * 16)(*(d for p in plans for d in p.dims))
        strides = (ctypes.c_ulonglong * 12)(
            *(st for p in plans for st in p.strides))
        status = lib.flash_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims,
            strides, int(window), hd ** -0.5, stream)
        dst = out
    else:
        # the element-wise mma and the FMA kernels write contiguous rows
        dst = out if out.is_contiguous() else torch.empty_like(q)
        status = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dst.data_ptr(),
            _DTYPES[q.dtype], B, H, k.shape[1], S, hd, int(window),
            hd ** -0.5, int(name.startswith("f32-fma")
                            and not name.endswith("elementwise")), stream)
    _build.check(status, "flash_attention")
    count_launches(_route(name))
    return out if dst is out else out.copy_(dst)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int) -> torch.Tensor:
    if q.device.type == "cpu":
        # q's layout, as the card's and the meta form's outputs
        return torch.empty_like(q).copy_(attention_plain(q, k, v,
                                                         window=window))
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


def count_launches(route: str, n: int = 1) -> None:
    """Add ``n`` launches of ``route`` to ``flash_attention``'s counters: one
    for each launch here, and a CUDA graph's captured launches on each of
    its replays (``repro_torch._graphs``; its capture takes back, with a
    negative ``n``, what it counted while nothing ran)."""
    flash_attention.launches += n
    flash_attention.route_launches[route] += n


flash_attention.launches = 0
flash_attention.route_launches = {"bf16-wgmma": 0, "bf16-mma": 0,
                                  "f32": 0}
