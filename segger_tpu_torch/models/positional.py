"""Sinusoidal 2D positional embedding.

Per-axis sinusoidal frequency embedding of tile-normalized coordinates
through a Linear-SiLU-Linear MLP, concatenated across the two axes (the
reference's ``Positional2dEmbedder``).  Coordinates are normalized per
tile, by a masked min/max over its valid rows, unless the caller passes
them already in [0, 1] (``prenormalized``: the shards of a whole slide,
normalized once in the slide's frame, since per-shard min/max would
differ between shards).
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


def sinusoidal_embedding(
    x: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """(...,) -> (..., dim) sinusoidal features, cos first."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    args = x[..., None].float() * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


def dense(layer: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``flax.linen.Dense``: ``x @ W + b`` with input, kernel and bias
    cast to ``dtype`` when given, rounded once after the product and once
    after the bias, as flax does."""
    w, b = layer.weight, layer.bias
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return F.linear(x, w) + b


class Positional2dEmbedder(nn.Module):
    """Embed (x, y) positions into ``2 * (hidden_size // 2)`` features."""

    def __init__(self, hidden_size: int,
                 frequency_embedding_size: int = 256):
        super().__init__()
        dim = hidden_size // 2
        self.frequency_embedding_size = frequency_embedding_size
        # names follow the flax parameter tree (Dense_0, Dense_1)
        self.Dense_0 = nn.Linear(frequency_embedding_size, dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, pos: torch.Tensor, valid: torch.Tensor,
                prenormalized: bool = False) -> torch.Tensor:
        if prenormalized:
            p = pos
        else:
            vm = valid[:, None]
            mins = torch.where(vm, pos, 1e30).amin(dim=0)
            maxs = torch.where(vm, pos, -1e30).amax(dim=0)
            p = (pos - mins) / (maxs - mins + 1e-8)
        freq = sinusoidal_embedding(p, self.frequency_embedding_size)
        emb = dense(self.Dense_1, F.silu(dense(self.Dense_0, freq)))
        return emb.reshape(emb.shape[0], -1)                # (N, 2*dim)
