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
  * ``BatchNorm3d`` is the same BatchNorm over (B, C, T, H, W); its eps
    and momentum are set per module (i3d's ``Unit3D``: eps 1e-3, torch
    momentum 0.01 = flax 0.99)
  * in a data-parallel step (``set_step_mesh``) train-mode BatchNorm
    takes the statistics of the global batch of every rank
    (``_CrossReplicaNorm``), as the JAX package's GSPMD step does;
    ``instance_norm`` is per sample and stays local
  * Dropout (and ``DropPath``, stochastic depth) draws its mask from an
    explicit ``torch.Generator`` that the train step hands every
    ``Dropout`` (``set_dropout_generator``), never from the global RNG; in
    train mode with p > 0 and no generator it raises; in a data-parallel
    step it keeps this rank's rows of the global batch's mask

The convolution families' helpers: ``ConvSame`` and ``max_pool_same``
pad as flax's ``padding="SAME"`` and the JAX package's TF-SAME pool do,
asymmetrically where the stride asks for it (torch's own ``padding`` is
symmetric); ``instance_norm`` is EmoNet's affine-free InstanceNorm.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mesh import draw_rows
from ..ops.attention import fused_attention

LAYER_NORM_EPS = 1e-6


class _CrossReplicaNorm(torch.autograd.Function):
    """Train-mode batch normalisation over the global batch of a mesh's
    ranks: the forward all-reduces the per-channel sums and the row count
    (the global mean), then the centred sums of squares (the two-pass
    biased variance); the backward all-reduces sum(dy) and sum(dy * x_hat),
    the global sums the input gradient needs. The weight and bias
    gradients are this rank's sums: the step's gradient all-reduce adds
    the ranks'. Statistics and arithmetic in f32; the output in the
    input's dtype, as the local path's under autocast."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh, eps):
        c = x.shape[1]
        dims = [0, *range(2, x.ndim)]
        shape = (1, c) + (1,) * (x.ndim - 2)
        xf = x.float()
        sums = torch.cat([xf.sum(dims), xf.new_full((1,), x.numel() // c)])
        mesh.all_reduce(sums, "batch_norm")
        n = sums[c]
        mean = sums[:c] / n
        d = xf - mean.view(shape)
        sq = (d * d).sum(dims)
        mesh.all_reduce(sq, "batch_norm")
        var = sq / n
        invstd = torch.rsqrt(var + eps)
        x_hat = d * invstd.view(shape)
        y = x_hat if weight is None else \
            x_hat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(x_hat, invstd, weight)
        ctx.mesh, ctx.n, ctx.dims, ctx.shape = mesh, n, dims, shape
        ctx.x_dtype = x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x_hat, invstd, weight = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        dyf = dy.float()
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * x_hat).sum(dims)
        dweight = sum_dy_xhat.clone() if ctx.needs_input_grad[1] else None
        dbias = sum_dy.clone() if ctx.needs_input_grad[2] else None
        dx = None
        if ctx.needs_input_grad[0]:
            c = sum_dy.shape[0]
            sums = ctx.mesh.all_reduce(torch.cat([sum_dy, sum_dy_xhat]),
                                       "batch_norm")
            scale = invstd if weight is None else invstd * weight
            dx = (dyf - (sums[:c] / ctx.n).view(shape)
                  - x_hat * (sums[c:] / ctx.n).view(shape)) \
                * scale.view(shape)
            dx = dx.to(ctx.x_dtype)
        return dx, dweight, dbias, None, None


class _FlaxRunningVar:
    """Train-mode BatchNorm whose running variance takes the biased batch
    variance. torch updates ``rv <- (1 - m) rv + m * var * n / (n - 1)``;
    running that update on ``rv * n / (n - 1)`` and scaling the result by
    (n - 1) / n turns it into ``(1 - m) rv + m * var``, flax's update,
    without a second pass over the input. The update runs on a copy, as
    autograd keeps the tensor the op was given. Parameter and buffer names
    stay torch's.

    Under a mesh (``mesh``, set by ``set_step_mesh`` for a step), train
    mode normalises with the statistics of the global batch
    (``_CrossReplicaNorm``) and updates the running ones with them,
    flax's biased rule."""

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.numel() // x.shape[1]
        if self.training and self.mesh is not None:
            return self._cross_replica(x, n * self.mesh.world)
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

    def _cross_replica(self, x: torch.Tensor, n: int) -> torch.Tensor:
        self._check_input_dim(x)
        if n < 2:
            raise ValueError(f"BatchNorm in train mode over {n} value per "
                             "channel of the global batch")
        out, mean, var = _CrossReplicaNorm.apply(x, self.weight, self.bias,
                                                 self.mesh, self.eps)
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return out


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxRunningVar, nn.BatchNorm3d):
    pass


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from ``self.generator`` (set by
    ``set_dropout_generator``): identity in eval or at p == 0."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode draws from an explicit "
                               "generator: call set_dropout_generator first")
        keep = self._draw(x.shape, x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)

    def _draw(self, shape, device) -> torch.Tensor:
        """Uniform draws of ``shape`` from the generator; under a mesh this
        rank's rows of the global batch's draw (the leading axis is
        batch-major at every dropout site)."""
        return draw_rows(lambda s: torch.rand(s, generator=self.generator,
                                              device=device),
                         shape, self.mesh)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class DropPath(Dropout):
    """Stochastic depth (timm's DropPath, auformer/nn/van.py:26-33): one
    keep/drop draw per sample, kept samples scaled by 1 / (1 - p)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in train mode draws from an "
                               "explicit generator: call "
                               "set_dropout_generator first")
        keep = self._draw((x.shape[0],) + (1,) * (x.ndim - 1),
                          x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Hand every ``Dropout`` (and ``DropPath``) of ``model`` the generator
    its masks come from (None detaches them)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_step_mesh(model: nn.Module, mesh) -> None:
    """Hand every train-mode BatchNorm and ``Dropout`` of ``model`` the
    mesh of a data-parallel step (core/mesh.py; None detaches it): the
    BatchNorms then reduce their statistics over the global batch and the
    dropout masks are this rank's rows of the global batch's."""
    for m in model.modules():
        if isinstance(m, (_FlaxRunningVar, Dropout)):
            m.mesh = mesh


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


# -- the convolution families' helpers -------------------------------------

def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> list[tuple[int, int]]:
    """(before, after) per spatial axis of flax's / TF's ``padding="SAME"``
    (``lax.padtype_to_pads``, dilation 1): the output has ceil(size /
    stride) samples, and an odd total pads one more after than before."""
    pads = []
    for size, k, s in zip(sizes, kernel, stride):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads: Sequence[tuple[int, int]]) -> list[int]:
    """``F.pad``'s argument for (before, after) per axis, first axis first."""
    return [p for before_after in reversed(pads) for p in before_after]


class ConvSame(nn.Conv3d):
    """``Conv3d`` with flax's ``padding="SAME"`` (i3d's ``Unit3D``): padded
    by the convolution itself where the padding is symmetric, by ``F.pad``
    first where it is not (stride 2 over an even size pads (k//2 - 1,
    k//2): the I3D stem at 16x112x112 pads (2, 3) on every axis, where
    ``Conv3d(padding=3)`` would shift every output by a sample)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], stride: Sequence[int] = (1, 1, 1),
                 bias: bool = False):
        super().__init__(in_channels, out_channels, tuple(kernel),
                         tuple(stride), padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = same_pads(x.shape[2:], self.kernel_size, self.stride)
        if all(a == b for a, b in pads):
            return F.conv3d(x, self.weight, self.bias, self.stride,
                            [a for a, _ in pads])
        return F.conv3d(F.pad(x, _torch_pad(pads)), self.weight, self.bias,
                        self.stride)


def max_pool_same(x: torch.Tensor, kernel: Sequence[int],
                  stride: Sequence[int]) -> torch.Tensor:
    """TF-SAME max pool over (T, H, W) of a (B, C, T, H, W) tensor
    (auformer/nn/i3d.py:46-58): padded with -inf, asymmetrically where the
    stride asks for it ((0, 1) for the (1,3,3)/(1,2,2) pools at 56).
    Under deterministic algorithms on CUDA it trains through
    ``max_pool3d_separable``."""
    pads = same_pads(x.shape[2:], kernel, stride)
    if all(a == b and 2 * a <= k for (a, b), k in zip(pads, kernel)):
        return _max_pool3d(x, tuple(kernel), tuple(stride),
                           tuple(a for a, _ in pads))
    return _max_pool3d(F.pad(x, _torch_pad(pads), value=float("-inf")),
                       tuple(kernel), tuple(stride), (0, 0, 0))


def _max_pool3d(x: torch.Tensor, kernel: tuple, stride: tuple,
                padding: tuple) -> torch.Tensor:
    """``F.max_pool3d``; on CUDA under ``torch.use_deterministic_algorithms``
    with a gradient to take, ``max_pool3d_separable``: max_pool3d's CUDA
    backward scatters with atomics and has no deterministic implementation
    (PyTorch only warns), so two runs of i3d's train step would differ."""
    if (x.is_cuda and x.requires_grad and torch.is_grad_enabled()
            and torch.are_deterministic_algorithms_enabled()):
        return max_pool3d_separable(x, kernel, stride, padding)
    return F.max_pool3d(x, kernel, stride, padding)


def max_pool3d_separable(x: torch.Tensor, kernel: Sequence[int],
                         stride: Sequence[int],
                         padding: Sequence[int]) -> torch.Tensor:
    """``F.max_pool3d`` of a (B, C, T, H, W) tensor as two ``max_pool2d``:
    over (H, W), then over T. The values are equal, and each window's
    gradient goes to the same element (the first maximum in (T, H, W)
    order on both routes); max_pool2d's backward gathers, so the sums of
    a gradient's terms are deterministic, in another order than the
    atomics'."""
    b, c, t, h, w = x.shape
    y = F.max_pool2d(x.reshape(b, c * t, h, w), tuple(kernel[1:]),
                     tuple(stride[1:]), tuple(padding[1:]))
    ho, wo = y.shape[2:]
    z = F.max_pool2d(y.reshape(b, c, t, ho * wo), (kernel[0], 1),
                     (stride[0], 1), (padding[0], 0))
    return z.reshape(b, c, z.shape[2], ho, wo)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch ``InstanceNorm2d(affine=False)`` as the JAX package computes it
    (auformer/nn/emonet.py:29-33) on a (B, C, H, W) tensor: per sample and
    channel over (H, W), with the biased variance. The mean and variance
    are taken in f32 and rounded once to ``x``'s dtype, the normalisation
    runs in that dtype, as ``jnp.mean`` / ``jnp.var`` of a bf16 array and
    the bf16 arithmetic after them do."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, correction=0)
    return (x - mean.to(x.dtype)) / torch.sqrt(var.to(x.dtype) + eps)
