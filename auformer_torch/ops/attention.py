"""Fused attention for short token sequences (counterpart of
auformer/ops/attention.py).

avformer's attention sites are all tiny: 49 spatial tokens x (B*16) frames,
17 temporal tokens, 12 AU tokens. ``fused_attention`` launches the CUDA
kernel ``csrc/attention.cu`` for CUDA tensors: one warp per (batch*head)
row, Q K^T and P V on tensor cores, strided q, k, v read in place and the
output written as (B, N, H, D), so the caller's head split and merge are
views. ``attention_reference`` is its plain PyTorch version with the same
arithmetic (all f32, P.V included, output cast to the input dtype, as the
Pallas kernel does; the JAX package's ``_xla_attention`` instead casts P to
V's dtype before P.V, so in bf16 the two JAX paths differ and the port
follows the kernel).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import check, library

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_TOKENS = 144          # the kernel's limits (csrc/attention.cu)
MAX_DIM = 64


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, N, D) softmax(Q K^T * scale) V in f32, cast to q's dtype.
    ``mask``: (B, N) bool, True = keep (outer-product i/j mask)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if mask is not None:
        m = mask[:, None, :, None] & mask[:, None, None, :]
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vf).to(q.dtype)


class _Params(ctypes.Structure):
    """``AttnParams`` of csrc/attention.cu: pointers, then the (batch, head,
    token) strides in elements of q, k, v and o, then the sizes."""
    _fields_ = [("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("o", ctypes.c_void_p),
                ("q_stride", ctypes.c_longlong * 3),
                ("k_stride", ctypes.c_longlong * 3),
                ("v_stride", ctypes.c_longlong * 3),
                ("o_stride", ctypes.c_longlong * 3),
                ("rows", ctypes.c_int), ("heads", ctypes.c_int),
                ("n", ctypes.c_int), ("d", ctypes.c_int),
                ("scale", ctypes.c_float)]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("attention")
    lib.attention_forward.argtypes = [ctypes.POINTER(_Params), ctypes.c_int,
                                      ctypes.c_void_p]
    lib.attention_forward.restype = ctypes.c_int
    lib.attention_launch_shape.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.attention_launch_shape.restype = ctypes.c_int
    return lib


def output_buffer(q: torch.Tensor) -> torch.Tensor:
    """The (B, H, N, D) result as a view of a new (B, N, H, D) tensor, the
    layout the kernel writes: merging the heads afterwards is a view."""
    b, h, n, d = q.shape
    return torch.empty((b, n, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise unless the kernel takes q, k, v as they are: one (B, H, N, D)
    shape, 1 <= N <= 144, D a multiple of 8 up to 64, one dtype (float32 or
    bfloat16), one device, the last dimension of stride 1 and every token
    row on 16 bytes (pointer and the batch, head and token strides)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention: q, k, v must share one (B, H, N, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention: float32 or bfloat16 q, k, v "
                        f"expected, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("fused_attention: q, k, v on different devices")
    _, _, n, d = q.shape
    if not (1 <= n <= MAX_TOKENS and 8 <= d <= MAX_DIM and d % 8 == 0):
        raise ValueError(f"fused_attention: the kernel takes 1 <= N <= "
                         f"{MAX_TOKENS} and D in 8, 16, ..., {MAX_DIM}; got "
                         f"N={n}, D={d}")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"fused_attention: {name}.stride(-1) is "
                             f"{t.stride(-1)}, the kernel needs 1")
        if t.data_ptr() % 16 or any(
                t.stride(i) * size % 16 for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"fused_attention: {name}'s token rows are not "
                             f"16-byte aligned (strides {t.stride()})")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, N, D) -> (B, H, N, D), a view of a (B, N, H, D) tensor.

    A CPU tensor takes ``attention_reference``. A CUDA tensor takes the
    kernel or raises (``check_kernel_inputs``), with no mask (no model on
    the path passes one). q, k and v may be strided views, such as the
    head split of a fused QKV projection: the kernel reads them in place.
    ``fused_attention.launches`` counts kernel launches.
    """
    out = output_buffer(q)
    if q.device.type == "cpu":
        return out.copy_(attention_reference(q, k, v, scale, mask))
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    if mask is not None:
        raise NotImplementedError("fused_attention: the CUDA kernel takes "
                                  "no mask")
    check_kernel_inputs(q, k, v)
    b, h, n, d = q.shape
    if b * h == 0:
        return out
    params = _Params(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (ctypes.c_longlong * 3)(*q.stride()[:3]),
        (ctypes.c_longlong * 3)(*k.stride()[:3]),
        (ctypes.c_longlong * 3)(*v.stride()[:3]),
        (ctypes.c_longlong * 3)(*out.stride()[:3]),
        b * h, h, n, d, float(scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _library().attention_forward(ctypes.byref(params),
                                           _DTYPE_CODE[q.dtype], stream)
    check(err, "attention kernel")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
