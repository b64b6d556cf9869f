"""GATv2 convolution over padded-CSR adjacency, with attention dropout.

Math of PyG's ``GATv2Conv`` with ``concat=True``,
``negative_slope=0.2`` (``share_weights=True`` makes ``W_r, b_r`` the
same parameters as ``W_l, b_l``, as the JAX package's ``lin_r = lin_l``):

    x_l = W_l x_src + b_l                        (per source node)
    x_r = W_r x_dst + b_r                        (per destination node)
    e_ij = a_h . leaky_relu(x_l[j] + x_r[i])     (per edge, per head h)
    alpha = softmax_j(e_ij)                      (over i's in-edges)
    out_i = concat_h( sum_j alpha_ij keep_ij x_l[j,h] ) + bias

The projections are ``F.linear``.  The edge stage has two paths, as in
the JAX package:

- **fused** (given ``segments``): the CUDA kernel pair of
  ``ops/postgather.py`` (their plain versions on the CPU), launched once
  per degree-bucket segment of the destination rows through
  ``EdgeStageFunction``; it never forms the attention coefficients;
- **unfused** (no ``segments``, or ``capture_attention=True``): plain
  torch ops over the whole padded table (gather with index clipping,
  leaky-ReLU, per-head logits, ``csr_softmax``, the weighted sum).  It
  records the attention ``(N_dst, K, H)`` before dropout in
  ``intermediates``, the analogue of the reference's forward-hook
  capture.

Destinations with no in-edge output ``bias`` only.

Dropout follows the JAX package: when it is on, every fused launch takes
two fresh 32-bit seed words from ``seeds`` (one per tt segment, in
segment order, then one per launch of the next conv), and the keep
multipliers are hashed from them inside the kernels; the unfused path
takes one pair per call and draws flax's ``Dropout`` mask on the
coefficients from a ``torch.Generator`` seeded with it.  The words are
host ints (:func:`torch_seed_source`) or rows of a device tensor
(:class:`BufferSeedSource`), which the kernels read where they lie: the
fused path then takes no host value, as a CUDA graph's replay needs.

Types follow ``flax.linen.Dense(dtype=...)``: with a compute dtype, the
projections and ``att`` run in it, and adding the float32 ``bias``
promotes each conv's output to float32.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.gather_agg import csr_gather, csr_softmax
from ..ops.padded_csr import PaddedCSR
from ..ops.postgather import gatv2_edge_stage
from .positional import dense

# one launch of the edge stage: destination rows [start, stop), their
# contiguous (stop - start, K) idx / mask tables and the segment's
# transpose table (flat slot positions; None without one)
Segment = Tuple[int, int, torch.Tensor, torch.Tensor, Optional[PaddedCSR]]
# yields the next launch's two seed words: two ints, or a (2,) int32
# tensor of their bit patterns
SeedSource = Callable[[], Union[Tuple[int, int], torch.Tensor]]


def torch_seed_source(generator: Optional[torch.Generator] = None
                      ) -> SeedSource:
    """Seed words drawn from a CPU ``torch.Generator`` (the default one
    when None), two per call."""
    def draw():
        w = torch.randint(0, 2**32, (2,), dtype=torch.int64,
                          generator=generator)
        return int(w[0]), int(w[1])
    return draw


class BufferSeedSource:
    """Seed words read from the rows of an (n, 2) int32 tensor, one row a
    call in order; ``used`` counts the rows handed out.  Running past the
    last row raises."""

    def __init__(self, words: torch.Tensor):
        self.words = words
        self.used = 0

    def __call__(self) -> torch.Tensor:
        if self.used >= self.words.shape[0]:
            raise IndexError(f"seed buffer of {self.words.shape[0]} "
                             "launches exhausted")
        self.used += 1
        return self.words[self.used - 1]


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> None:
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)


class GATv2Conv(nn.Module):
    """Single-edge-type GATv2 attention convolution (bipartite-capable)."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 negative_slope: float = 0.2, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 share_weights: bool = False):
        super().__init__()
        hc = heads * out_channels
        self.heads, self.out_channels = heads, out_channels
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.dtype = dtype
        self.share_weights = share_weights
        self.lin_l = nn.Linear(in_channels, hc)
        # with shared weights there is no lin_r parameter (the flax tree
        # has none): the destination side reads lin_l
        if not share_weights:
            self.lin_r = nn.Linear(in_channels, hc)
        self.att = nn.Parameter(torch.empty(1, heads, out_channels))
        self.bias = nn.Parameter(torch.empty(hc))

    @property
    def lin_dst(self) -> nn.Linear:
        """The destination side's projection."""
        return self.lin_l if self.share_weights else self.lin_r

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax init: glorot-uniform kernels and ``att``, zero biases."""
        for lin in dict.fromkeys((self.lin_l, self.lin_dst)):
            glorot_uniform_(lin.weight, lin.in_features, lin.out_features,
                            generator)
            nn.init.zeros_(lin.bias)
        glorot_uniform_(self.att, self.heads, self.out_channels, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x_src: torch.Tensor, x_dst: torch.Tensor,
                csr: PaddedCSR, deterministic: bool = True,
                seeds: Optional[SeedSource] = None,
                segments: Optional[Sequence[Segment]] = None,
                capture_attention: bool = False,
                intermediates: Optional[Dict[str, torch.Tensor]] = None,
                name: str = "attention") -> torch.Tensor:
        """``csr`` is the whole (N_dst, K) table.  ``segments`` cover its
        destination rows in order (one segment for an unbucketed table)
        and select the fused path, unless ``capture_attention``.  The
        unfused path stores its attention under ``intermediates[name]``
        when a dict is given.  With ``deterministic=False`` and a dropout
        rate, each launch draws its seed words from ``seeds``.

        ``x_src`` is one tensor, or a tuple of pieces of a halo-extended
        source (``[local | from_left | from_right ...]``,
        ``parallel/halo.py``): each piece is projected on its own and the
        projections concatenated, as the JAX package does, so that the
        local rows' projection does not wait for the exchange."""
        if isinstance(x_src, (tuple, list)):
            xl = torch.cat([dense(self.lin_l, p, self.dtype) for p in x_src])
        else:
            xl = dense(self.lin_l, x_src, self.dtype)
        xr = dense(self.lin_dst, x_dst, self.dtype)
        att = self.att[0].to(xl.dtype)
        dropout_on = self.dropout > 0.0 and not deterministic
        if dropout_on and seeds is None:
            seeds = torch_seed_source()
        if segments is None or capture_attention:
            out, alpha = self.unfused(
                xl, xr, att, csr, seeds() if dropout_on else None)
            if intermediates is not None:
                intermediates[name] = alpha
            return out + self.bias
        outs = [
            gatv2_edge_stage(
                xl, xr[a:b], att, idx, mask, self.heads,
                self.negative_slope, csr_t,
                seed=seeds() if dropout_on else None,
                rate=self.dropout if dropout_on else 0.0,
            )
            for a, b, idx, mask, csr_t in segments
        ]
        return torch.cat(outs, dim=0) + self.bias

    def unfused(self, xl: torch.Tensor, xr: torch.Tensor, att: torch.Tensor,
                csr: PaddedCSR, seed: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The edge stage in plain torch ops, in the feature dtype
        (``segger_tpu/models/gatv2.py``'s unfused branch).  Returns
        ``(out (N_dst, HC) without bias, alpha (N_dst, K, H))``, alpha
        before dropout; ``seed`` (two words) turns dropout on."""
        n, k = csr.idx.shape
        h, c = self.heads, self.out_channels
        g = csr_gather(xl, csr)                            # (N, K, HC)
        s = g + xr[:, None, :]
        slope = torch.tensor(self.negative_slope, dtype=s.dtype,
                             device=s.device)
        s = torch.where(s >= 0, s, slope * s)
        logits = (s.view(n, k, h, c) * att).sum(-1)        # (N, K, H)
        alpha = csr_softmax(logits, csr)
        a = alpha
        if seed is not None:
            s0, s1 = (int(w) & 0xFFFFFFFF for w in seed)
            gen = torch.Generator(device=alpha.device)
            gen.manual_seed((s0 << 32) | s1)
            keep_p = 1.0 - self.dropout
            keep = torch.rand(alpha.shape, generator=gen,
                              device=alpha.device) < keep_p
            a = torch.where(keep, alpha / keep_p, 0.0)
        out = torch.einsum("nkh,nkhc->nhc", a, g.view(n, k, h, c))
        return out.reshape(n, h * c), alpha
