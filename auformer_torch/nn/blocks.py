"""Shared transformer building blocks (counterpart of auformer/nn/blocks.py).

Reference block semantics (vformer.py:22-114, heads.py:164-256): pre-LayerNorm
residual encoder with tanh-approximate GELU, bias-free fused QKV, per-head
scale dim_head**-0.5, and an output projection unless (heads == 1 and
dim_head == dim). Modules nest as the reference's
``Residual(PreNorm(...))`` so parameter names match its ``.pth`` layout:
``layers.{i}.0.fn.norm``, ``layers.{i}.0.fn.fn.to_qkv``,
``layers.{i}.1.fn.fn.net.0``.

Numeric choices that follow the JAX package, not the upstream torch code:
  * LayerNorm eps is 1e-6 (flax's default; the reference's torch LayerNorm
    uses 1e-5)
  * BatchNorm is torch's own, eps 1e-5 and momentum 0.1, as in the JAX
    package's ``BatchNorm``
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention

LAYER_NORM_EPS = 1e-6


class FeedForward(nn.Module):
    """Linear -> GELU (tanh approximation, reference vformer.py:22-24)
    -> Dropout -> Linear -> Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(approximate="tanh"),
            nn.Dropout(dropout), nn.Linear(hidden_dim, dim),
            nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Attention(nn.Module):
    """Multi-head self-attention (reference vformer.py:61-97) over
    ``fused_attention``, which takes contiguous heads-first tensors. No
    model on the path passes a mask (reference vformer.py:87)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = (nn.Sequential(nn.Linear(inner, dim),
                                     nn.Dropout(dropout))
                       if project_out else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.to_qkv(x).reshape(b, n, 3, self.heads, self.dim_head)
        # one copy to (3, B, H, N, D): q, k, v come out contiguous
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        out = fused_attention(q, k, v, self.scale)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(x)


class TransformerBlock(nn.ModuleList):
    """[Residual(PreNorm(Attention)), Residual(PreNorm(FeedForward))]."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0):
        super().__init__([
            Residual(PreNorm(dim, Attention(dim, heads, dim_head, dropout))),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dropout)))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](self[0](x))


class Transformer(nn.Module):
    """Depth-stacked pre-norm encoder (reference vformer.py:100-114)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(dim, heads, dim_head, mlp_dim, dropout)
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def token_projection(x: torch.Tensor,
                     linears: Sequence[nn.Linear]) -> torch.Tensor:
    """The JAX package's ``TokenProjection``: N per-token linears (the
    reference's ``AU_linear_p*``, heads.py:264-275) run as ONE matmul,
    (B, D) -> (B, N, E)."""
    weight = torch.cat([lin.weight for lin in linears])
    bias = torch.cat([lin.bias for lin in linears])
    return F.linear(x, weight, bias).reshape(x.shape[0], len(linears), -1)


def token_logits(tokens: torch.Tensor,
                 linears: Sequence[nn.Linear]) -> torch.Tensor:
    """The JAX package's ``TokenLogits``: N per-token bias-free scalar
    linears (``AU_linear_last*``, heads.py:278-289) as one f32 contraction,
    (B, N, E) -> (B, N)."""
    weight = torch.cat([lin.weight for lin in linears])          # (N, E)
    return torch.einsum("bne,ne->bn", tokens.float(), weight.float())
