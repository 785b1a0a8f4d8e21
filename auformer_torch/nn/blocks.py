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
  * BatchNorm (``BatchNorm1d`` / ``BatchNorm2d``): eps 1e-5, momentum 0.1,
    as the JAX package's ``BatchNorm``. In eval it is torch's own. In train
    mode it normalizes with the biased batch variance, as torch does, and
    also updates ``running_var`` with the BIASED one, as flax's
    ``nn.BatchNorm`` does (torch's own would use the unbiased one)
  * Dropout draws its mask from an explicit ``torch.Generator`` that the
    train step hands every ``Dropout`` (``set_dropout_generator``), never
    from the global RNG; in train mode with p > 0 and no generator it
    raises
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention

LAYER_NORM_EPS = 1e-6


class _FlaxRunningVar:
    """Train-mode BatchNorm whose running variance takes the biased batch
    variance. torch updates ``rv <- (1 - m) rv + m * var * n / (n - 1)``;
    running that update on ``rv * n / (n - 1)`` and scaling the result by
    (n - 1) / n turns it into ``(1 - m) rv + m * var``, flax's update,
    without a second pass over the input. The update runs on a copy, as
    autograd keeps the tensor the op was given. Parameter and buffer names
    stay torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.numel() // x.shape[1]
        if not (self.training and self.track_running_stats) or n < 2:
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        running_var = self.running_var * (n / (n - 1))
        out = F.batch_norm(x, self.running_mean, running_var, self.weight,
                           self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(running_var * ((n - 1) / n))
        return out


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    pass


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from ``self.generator`` (set by
    ``set_dropout_generator``): identity in eval or at p == 0."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode draws from an explicit "
                               "generator: call set_dropout_generator first")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_generator(model: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Hand every ``Dropout`` of ``model`` the generator its masks come
    from (None detaches them)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class FeedForward(nn.Module):
    """Linear -> GELU (tanh approximation, reference vformer.py:22-24)
    -> Dropout -> Linear -> Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(approximate="tanh"),
            Dropout(dropout), nn.Linear(hidden_dim, dim), Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Attention(nn.Module):
    """Multi-head self-attention (reference vformer.py:61-97) over
    ``fused_attention``, which reads the head split of the fused QKV
    projection in place and writes tokens-first, so neither side copies.
    No model on the path passes a mask (reference vformer.py:87)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = (nn.Sequential(nn.Linear(inner, dim), Dropout(dropout))
                       if project_out else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.to_qkv(x).reshape(b, n, 3, self.heads, self.dim_head)
        # (B, H, N, D) views of the projection; the result is a (B, H, N, D)
        # view of a (B, N, H, D) tensor, so the merge below is a view too
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
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


def _autocast_dtype(x: torch.Tensor) -> torch.dtype | None:
    """The dtype autocast computes in on ``x``'s device, None where it is
    off."""
    kind = x.device.type
    return (torch.get_autocast_dtype(kind)
            if torch.is_autocast_enabled(kind) else None)


def _f32_product(x: torch.Tensor, weight: torch.Tensor,
                 equation: str) -> torch.Tensor:
    """``einsum(equation, x, weight)`` with an f32 result, as the JAX
    package's ``preferred_element_type=float32`` contractions give it: under
    autocast both operands are first rounded to its dtype (products of bf16
    values are exact in f32, so the f32 einsum equals an f32-accumulating
    bf16 one); otherwise they are taken in their own dtypes."""
    dtype = _autocast_dtype(x)
    if dtype is not None:
        x, weight = x.to(dtype), weight.to(dtype)
    with torch.autocast(x.device.type, enabled=False):
        return torch.einsum(equation, x.float(), weight.float())


def token_projection(x: torch.Tensor,
                     linears: Sequence[nn.Linear]) -> torch.Tensor:
    """The JAX package's ``TokenProjection``: N per-token linears (the
    reference's ``AU_linear_p*``, heads.py:264-275) run as ONE matmul,
    (B, D) -> (B, N, E). Under autocast the result is f32, as JAX's is
    (f32 accumulation plus the f32 bias), so the AU heads' residual stream
    stays f32 as in JAX; otherwise it is in the parameters' dtype."""
    weight = torch.cat([lin.weight for lin in linears])
    bias = torch.cat([lin.bias for lin in linears])
    if _autocast_dtype(x) is None:
        y = F.linear(x, weight, bias)
    else:
        y = _f32_product(x, weight, "bd,ed->be") + bias.float()
    return y.reshape(x.shape[0], len(linears), -1)


def token_logits(tokens: torch.Tensor,
                 linears: Sequence[nn.Linear]) -> torch.Tensor:
    """The JAX package's ``TokenLogits``: N per-token bias-free scalar
    linears (``AU_linear_last*``, heads.py:278-289) as one contraction with
    an f32 result, (B, N, E) -> (B, N)."""
    weight = torch.cat([lin.weight for lin in linears])          # (N, E)
    return _f32_product(tokens, weight, "bne,ne->bn")
