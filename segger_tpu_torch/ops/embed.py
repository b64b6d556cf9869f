"""Embedding lookup with the JAX package's semantics, forward and
backward.

``jnp.take`` in the JAX package wraps a negative id once, so an unknown
gene (-1) reads the table's last row; ``F.embedding`` would raise on it.
The JAX backward is a one-hot matmul (``segger_tpu/ops/embed.py``), so an
id outside ``[0, V)`` sends no gradient anywhere.  This lookup gives what
JAX gives in both directions; its backward is a plain ``index_add_`` of
the valid rows, accumulated in float32.
"""
from __future__ import annotations

import torch


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_vocab = table.shape[0]
        return table[torch.where(ids < 0, ids + table.shape[0], ids)]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        v = ctx.n_vocab
        # ids outside [0, V) add into a spare row V that is dropped, so no
        # step of the backward depends on how many there are (a CUDA
        # graph can capture it)
        rows = torch.where((ids >= 0) & (ids < v), ids, v)
        grad = torch.zeros((v + 1, g.shape[-1]), dtype=torch.float32,
                           device=g.device)
        grad.index_add_(0, rows, g.float())
        return grad[:v].to(g.dtype), None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return _EmbedLookup.apply(table, ids.long())
