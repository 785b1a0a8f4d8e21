"""AU prediction heads (counterpart of auformer/nn/heads.py).

``AUFormerHead`` is the reference's AU-correlation transformer ``AU_former``
(heads.py:258-339): BatchNorm on the 512-dim embedding, 12 per-AU linear
projections to 128-dim AU tokens, a learned positional embedding, a depth-2
encoder over the 12 tokens, and 12 per-AU bias-free scalar logits.

``FormerAUHead`` is the JAX package's reconstruction of the reference's
missing ``former_AU_head`` (SURVEY.md §2.4-1): ``tformer_AU_head``
(tformer.py:362-403) at emb_dim 256 over the fused (B, 12, 256) A/V tokens.

Both keep the reference's parameter names (``AU_BN1``, ``AU_linear_p{i}``,
``AU_linear_last{i}``, ``corr_transformer``).
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import (BatchNorm1d, Transformer, token_logits,
                     token_projection)


class AUFormerHead(nn.Module):
    """reference AU_former: (B, D) -> (logits (B, 12), tokens (B, 12, E))."""

    def __init__(self, input_dim: int = 512, emb_dim: int = 128,
                 dropout: float = 0.0, n_tokens: int = 12, depth: int = 2,
                 heads: int = 8, dim_head: int = 32, mlp_dim: int = 256):
        super().__init__()
        self.n_tokens = n_tokens
        self.AU_BN1 = BatchNorm1d(input_dim)
        for i in range(1, n_tokens + 1):
            setattr(self, f"AU_linear_p{i}", nn.Linear(input_dim, emb_dim))
        self.pos_embedding = nn.Parameter(torch.randn(1, n_tokens, emb_dim))
        self.corr_transformer = Transformer(emb_dim, depth, heads, dim_head,
                                            mlp_dim, dropout)
        for i in range(1, n_tokens + 1):
            setattr(self, f"AU_linear_last{i}",
                    nn.Linear(emb_dim, 1, bias=False))

    def forward(self, emb: torch.Tensor):
        n = range(1, self.n_tokens + 1)
        tokens = token_projection(
            self.AU_BN1(emb), [getattr(self, f"AU_linear_p{i}") for i in n])
        x = self.corr_transformer(tokens + self.pos_embedding.to(tokens.dtype))
        logits = token_logits(x, [getattr(self, f"AU_linear_last{i}")
                                  for i in n])
        return logits, x


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
