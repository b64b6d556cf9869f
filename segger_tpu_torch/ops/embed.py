"""Embedding lookup (forward).

``jnp.take`` in the JAX package wraps a negative id once, so an unknown
gene (-1) reads the table's last row; ``F.embedding`` would raise on it.
This lookup gives what JAX gives.
"""
from __future__ import annotations

import torch


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.long()
    return table[torch.where(ids < 0, ids + table.shape[0], ids)]
