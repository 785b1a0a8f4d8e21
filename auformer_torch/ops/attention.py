"""Fused attention for short token sequences (counterpart of
auformer/ops/attention.py).

avformer's attention sites are all tiny: 49 spatial tokens x (B*16) frames,
17 temporal tokens, 12 AU tokens. ``fused_attention`` launches the CUDA
kernel ``csrc/attention.cu`` for CUDA tensors: one CTA per (batch*head)
row, the whole (N, N) score tile in shared memory. ``attention_reference``
is its plain PyTorch version with the same arithmetic (all f32, P.V
included, output cast to the input dtype, as the Pallas kernel does; the
JAX package's ``_xla_attention`` instead casts P to V's dtype before P.V,
so in bf16 the two JAX paths differ and the port follows the kernel).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import check, library

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024   # a launch without the dynamic-smem opt-in


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("attention")
    lib.attention_forward.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.attention_forward.restype = ctypes.c_int
    lib.attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.attention_smem_bytes.restype = ctypes.c_int
    return lib


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, N, D) -> (B, H, N, D).

    A CPU tensor takes ``attention_reference``. A CUDA tensor takes the
    kernel or raises: it must be contiguous float32 or bfloat16, q, k and v
    alike, with no mask (no model on the path passes one).
    ``fused_attention.launches`` counts kernel launches.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    if mask is not None:
        raise NotImplementedError("fused_attention: the CUDA kernel takes "
                                  "no mask")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention: q, k, v must share one (B, H, N, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention: float32 or bfloat16 q, k, v "
                        f"expected, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention: q, k, v must be contiguous")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("fused_attention: q, k, v on different devices")
    b, h, n, d = q.shape
    lib = _library()
    if lib.attention_smem_bytes(n, d) > _SMEM_LIMIT:
        raise ValueError(f"fused_attention: N={n}, D={d} needs more than "
                         f"{_SMEM_LIMIT} bytes of shared memory")
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, n, d, float(scale), _DTYPE_CODE[q.dtype], stream)
    check(err, "attention kernel")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
