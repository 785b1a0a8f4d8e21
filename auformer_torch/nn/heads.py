"""AU prediction heads (counterpart of auformer/nn/heads.py).

``AUFormerHead`` is the reference's AU-correlation transformer ``AU_former``
(heads.py:258-339): BatchNorm on the 512-dim embedding, 12 per-AU linear
projections to 128-dim AU tokens, a learned positional embedding, a depth-2
encoder over the 12 tokens, and 12 per-AU bias-free scalar logits.

``VAFormerHead`` is its 2-token valence/arousal analog ``VA_former``
(heads.py:341-372): ``VA_BN1``, ``VA_linear_p{1,2}``, a depth-2 encoder
with an MLP of 128, ``VA_linear_last{1,2}``.

``FormerAUHead`` is the JAX package's reconstruction of the reference's
missing ``former_AU_head`` (SURVEY.md §2.4-1): ``tformer_AU_head``
(tformer.py:362-403) at emb_dim 256 over the fused (B, 12, 256) A/V tokens.

These keep the reference's parameter names (``AU_BN1``, ``AU_linear_p{i}``,
``AU_linear_last{i}``, ``corr_transformer``).

``AUMultihead`` / ``EXPHead`` / ``VAHead`` / ``MultiTaskHead`` complete the
inventory (heads.py:11-162). No registry model uses them. The reference's
EXP/VA heads crash on construction (SURVEY.md §2.4-6); as in the JAX
package they implement the evident intent with ``input_dim``. Their
parameter names follow the JAX package's module names (``bn1``, ``fc1``,
``inter``, ``bn2``, ``fc2``), with the per-AU linears and ``AU_inter`` of
the reference's ``AU_multihead``.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import (BatchNorm1d, Transformer, token_logits,
                     token_projection)


class _TokenFormer(nn.Module):
    """BatchNorm -> N per-token linears -> + positional embedding -> encoder
    -> N per-token scalar logits, the parameters named by ``stem``
    (``{stem}_BN1``, ``{stem}_linear_p{i}``, ``{stem}_linear_last{i}``)."""

    stem = ""

    def __init__(self, input_dim: int, emb_dim: int, dropout: float,
                 n_tokens: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int):
        super().__init__()
        self.n_tokens = n_tokens
        setattr(self, f"{self.stem}_BN1", BatchNorm1d(input_dim))
        for i in range(1, n_tokens + 1):
            setattr(self, f"{self.stem}_linear_p{i}",
                    nn.Linear(input_dim, emb_dim))
        self.pos_embedding = nn.Parameter(torch.randn(1, n_tokens, emb_dim))
        self.corr_transformer = Transformer(emb_dim, depth, heads, dim_head,
                                            mlp_dim, dropout)
        for i in range(1, n_tokens + 1):
            setattr(self, f"{self.stem}_linear_last{i}",
                    nn.Linear(emb_dim, 1, bias=False))

    def forward(self, emb: torch.Tensor):
        n = range(1, self.n_tokens + 1)
        tokens = token_projection(
            getattr(self, f"{self.stem}_BN1")(emb),
            [getattr(self, f"{self.stem}_linear_p{i}") for i in n])
        x = self.corr_transformer(tokens + self.pos_embedding.to(tokens.dtype))
        logits = token_logits(x, [getattr(self, f"{self.stem}_linear_last{i}")
                                  for i in n])
        return logits, x


class AUFormerHead(_TokenFormer):
    """reference AU_former: (B, D) -> (logits (B, 12), tokens (B, 12, E))."""

    stem = "AU"

    def __init__(self, input_dim: int = 512, emb_dim: int = 128,
                 dropout: float = 0.0, n_tokens: int = 12, depth: int = 2,
                 heads: int = 8, dim_head: int = 32, mlp_dim: int = 256):
        super().__init__(input_dim, emb_dim, dropout, n_tokens, depth, heads,
                         dim_head, mlp_dim)


class VAFormerHead(_TokenFormer):
    """reference VA_former: (B, D) -> (logits (B, 2), tokens (B, 2, E))."""

    stem = "VA"

    def __init__(self, input_dim: int = 512, emb_dim: int = 128,
                 dropout: float = 0.0):
        super().__init__(input_dim, emb_dim, dropout, n_tokens=2, depth=2,
                         heads=8, dim_head=32, mlp_dim=128)


class FormerAUHead(nn.Module):
    """Reconstructed ``former_AU_head``: (B, 12, E) -> (B, 12) logits."""

    def __init__(self, emb_dim: int = 256, dropout: float = 0.0,
                 depth: int = 3, heads: int = 8, dim_head: int = 32,
                 mlp_dim: int = 256):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.randn(1, 12, emb_dim))
        self.corr_transformer = Transformer(emb_dim, depth, heads, dim_head,
                                            mlp_dim, dropout)
        for i in range(1, 13):
            setattr(self, f"AU_linear_last{i}",
                    nn.Linear(emb_dim, 1, bias=False))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.reshape(tokens.shape[0], 12, -1)
        x = self.corr_transformer(tokens + self.pos_embedding.to(tokens.dtype))
        return token_logits(x, [getattr(self, f"AU_linear_last{i}")
                                for i in range(1, 13)])


class AUMultihead(nn.Module):
    """reference AU_multihead: per-AU logits without the correlation
    transformer, (B, D) -> (B, 12); with ``inter`` also a 64-dim inter-task
    embedding of the flattened tokens."""

    def __init__(self, input_dim: int = 512, emb_dim: int = 16,
                 inter: bool = False):
        super().__init__()
        self.inter = inter
        self.AU_BN1 = BatchNorm1d(input_dim)
        for i in range(1, 13):
            setattr(self, f"AU_linear_p{i}", nn.Linear(input_dim, emb_dim))
            setattr(self, f"AU_linear_last{i}",
                    nn.Linear(emb_dim, 1, bias=False))
        if inter:
            self.AU_inter = nn.Linear(12 * emb_dim, 64)

    def forward(self, emb: torch.Tensor):
        n = range(1, 13)
        tokens = token_projection(
            self.AU_BN1(emb), [getattr(self, f"AU_linear_p{i}") for i in n])
        logits = token_logits(tokens, [getattr(self, f"AU_linear_last{i}")
                                       for i in n])
        if not self.inter:
            return logits
        return logits, self.AU_inter(tokens.flatten(1))


class _DenseHead(nn.Module):
    """BN -> Linear(64) -> ReLU [-> concat the 64-dim inter embedding in
    front] -> BN -> Linear(out_dim)."""

    def __init__(self, input_dim: int, out_dim: int, inter: bool):
        super().__init__()
        self.inter_in = inter
        hidden = 128 if inter else 64
        self.bn1 = BatchNorm1d(input_dim)
        self.fc1 = nn.Linear(input_dim, 64)
        self.bn2 = BatchNorm1d(hidden)
        self.fc2 = nn.Linear(hidden, out_dim)

    def hidden(self, emb: torch.Tensor,
               inter_emb: torch.Tensor | None) -> torch.Tensor:
        h = torch.relu(self.fc1(self.bn1(emb)))
        if self.inter_in:
            if inter_emb is None:
                raise ValueError("an inter head needs the inter embedding")
            h = torch.cat([inter_emb.to(h.dtype), h], dim=1)
        return h


class EXPHead(_DenseHead):
    """reference EXP_head intent: (B, D) -> (B, 7) expression logits; with
    ``inter`` it takes the AU head's 64-dim embedding and also returns its
    own."""

    def __init__(self, input_dim: int = 512, inter: bool = False):
        super().__init__(input_dim, 7, inter)
        if inter:
            self.inter = nn.Linear(128, 64)

    def forward(self, emb: torch.Tensor,
                inter_emb: torch.Tensor | None = None):
        h = self.hidden(emb, inter_emb)
        out = self.fc2(self.bn2(h))
        return (out, self.inter(h)) if self.inter_in else out


class VAHead(_DenseHead):
    """reference VA_head intent: (B, D) -> (B, 2) valence/arousal."""

    def __init__(self, input_dim: int = 512, inter: bool = False):
        super().__init__(input_dim, 2, inter)

    def forward(self, emb: torch.Tensor,
                inter_emb: torch.Tensor | None = None) -> torch.Tensor:
        return self.fc2(self.bn2(self.hidden(emb, inter_emb)))


class MultiTaskHead(nn.Module):
    """reference MultiTask_head: AU -> EX -> VA chained through 64-dim
    inter embeddings; returns (AU (B, 12), EX (B, 7), VA (B, 2))."""

    def __init__(self, input_dim: int = 512):
        super().__init__()
        self.au_head = AUMultihead(input_dim, inter=True)
        self.exp_head = EXPHead(input_dim, inter=True)
        self.va_head = VAHead(input_dim, inter=True)

    def forward(self, emb: torch.Tensor):
        au_out, au_inter = self.au_head(emb)
        ex_out, ex_inter = self.exp_head(emb, au_inter)
        return au_out, ex_out, self.va_head(emb, ex_inter)
