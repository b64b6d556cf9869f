"""Training losses: cluster-CDF triplet sampling, triplet/metric losses,
and the segmentation link loss (``segger_tpu/models/losses.py``).

Semantics of the reference:

- ``FastTripletSelector`` inverse-CDF cluster sampling;
- ``TripletLoss``: margin triplet loss on the sampled triplets;
- ``MetricLoss``: MSE of anchor/positive/negative cosine similarity
  against the cluster-similarity targets;
- the segmentation loss with modular-shift negatives, triplet or BCE.

The samplers are pure functions of their random numbers: the triplet
sampler takes four ``(N,)`` uniforms in ``[0, 1)`` (positive cluster,
negative cluster, positive member, negative member), the segmentation
loss its ``(E,)`` shifts.  :func:`draw_loss_randoms` draws them from a
``torch.Generator``, so tests can feed JAX's draws instead.  Losses return
``(sum, count)`` pairs, so the tiles of a step combine into the exact
joint masked mean.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Uniforms = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class TripletSample(NamedTuple):
    positives: torch.Tensor   # (N,) int64 anchor indices of positives
    negatives: torch.Tensor   # (N,) int64
    dists_pos: torch.Tensor   # (N,) float32: 1 - sim(cluster_a, cluster_p)
    dists_neg: torch.Tensor   # (N,) float32
    ok: torch.Tensor          # (N,) bool: anchor had a valid sample


class LossRandoms(NamedTuple):
    """The random numbers of one tile's losses."""

    tx: Uniforms              # tx triplet sampler
    bd: Uniforms              # bd metric sampler
    sg_shift: torch.Tensor    # (E,) int64 segmentation negative shifts


def prepare_similarity(similarity: torch.Tensor) -> torch.Tensor:
    """Fill the diagonal with 1."""
    c = similarity.shape[0]
    eye = torch.eye(c, dtype=torch.bool, device=similarity.device)
    return torch.where(eye, 1.0, similarity.float())


def sample_triplets(
    u_pos: torch.Tensor,
    u_neg: torch.Tensor,
    u_mem_p: torch.Tensor,
    u_mem_n: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    similarity: torch.Tensor,
    sort_structure: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> TripletSample:
    """One positive and one negative per anchor.

    Positive/negative clusters are drawn by inverse CDF over the
    (dis)similarity row of the anchor's cluster, restricted to clusters
    present among valid nodes; members are drawn uniformly within the
    cluster.  ``sort_structure`` is the tile's host-built ``(sorted
    rows, per-cluster counts)``; without it both are computed here."""
    eps = 1e-8
    c = similarity.shape[0]
    sim = prepare_similarity(similarity)
    sim_p = sim.clamp(min=eps)
    dis_p = (-sim).clamp(min=eps)
    lab = torch.where(valid, labels, 0).long()
    if sort_structure is not None:
        sorted_idx, counts = sort_structure
        counts = counts.long()
    else:
        counts = torch.bincount(lab[valid], minlength=c)[:c]
        sort_key = torch.where(valid, lab, c)
        sorted_idx = torch.argsort(sort_key, stable=True)
    sorted_idx = sorted_idx.long()
    present = counts > 0
    offsets = torch.cumsum(counts, 0) - counts
    # inclusive prefix sum as a matmul, as the JAX package forms it
    cum_u = torch.triu(torch.ones((c, c), device=sim.device))

    def draw(weights, u_cluster, u_member):
        w = weights[lab] * present[None, :].float()
        tot = w.sum(dim=1, keepdim=True)
        cdf = (w @ cum_u) / tot.clamp(min=1e-30)
        cl = (cdf < u_cluster[:, None]).sum(dim=1).clamp(0, c - 1)
        size = counts[cl]
        j = torch.floor(u_member * size.float()).long()
        j = torch.minimum(j.clamp(min=0), (size - 1).clamp(min=0))
        pos = offsets[cl] + j
        m = sorted_idx.shape[0]
        member = torch.where(pos < m, sorted_idx[pos.clamp(max=m - 1)], 0)
        ok = (tot[:, 0] > 0) & (size > 0)
        return member, cl, ok

    positives, pos_cl, ok_p = draw(sim_p, u_pos, u_mem_p)
    negatives, neg_cl, ok_n = draw(dis_p, u_neg, u_mem_n)
    dists = 1.0 - sim.clamp(min=eps)
    return TripletSample(positives, negatives, dists[lab, pos_cl],
                         dists[lab, neg_cl], valid & ok_p & ok_n)


def _masked_sum(values: torch.Tensor, mask: torch.Tensor):
    return torch.where(mask, values, 0.0).sum(), mask.sum()


def _dist(a, b):
    return torch.sqrt(((a - b) ** 2).sum(dim=-1) + 1e-12)


def triplet_loss(uniforms: Uniforms, embeddings, labels, valid, similarity,
                 margin: float = 0.3, sort_structure=None):
    """Margin triplet loss (p = 2) on sampled triplets: ``(sum, count)``."""
    s = sample_triplets(*uniforms, labels, valid, similarity, sort_structure)
    a = embeddings
    per = (_dist(a, a[s.positives]) - _dist(a, a[s.negatives])
           + margin).clamp(min=0.0)
    return _masked_sum(per, s.ok)


def metric_loss(uniforms: Uniforms, embeddings, labels, valid, similarity,
                sort_structure=None):
    """MSE of anchor-positive / anchor-negative cosine similarity against
    the cluster-similarity targets: ``(sum_pos + sum_neg, count)``."""
    s = sample_triplets(*uniforms, labels, valid, similarity, sort_structure)
    a = embeddings

    def cos(u, v):
        nu = torch.sqrt(((u * u).sum(-1)).clamp(min=1e-16))
        nv = torch.sqrt(((v * v).sum(-1)).clamp(min=1e-16))
        return (u * v).sum(-1) / (nu * nv)

    se_pos = (cos(a, a[s.positives]) - (1.0 - s.dists_pos)) ** 2
    se_neg = (cos(a, a[s.negatives]) - (1.0 - s.dists_neg)) ** 2
    sum_p, cnt = _masked_sum(se_pos, s.ok)
    sum_n, _ = _masked_sum(se_neg, s.ok)
    return sum_p + sum_n, cnt


def segmentation_loss(shift, emb_tx, emb_bd, sg_src, sg_dst, sg_mask,
                      n_bd_valid, loss_type: str = "triplet",
                      margin: float = 0.4):
    """Segmentation link loss over the supervision edges.

    Negatives are the reference's modular shift ``(dst + shift) % nb``
    with ``shift`` in ``[1, nb)``, ``nb = max(n_bd_valid, 2)``; valid
    boundary nodes occupy rows ``[0, n_bd_valid)``.  When ``n_bd_valid
    <= 1`` the loss contributes 0.  Returns ``(sum, count)``."""
    nb = torch.clamp(torch.as_tensor(n_bd_valid), min=2)
    dst_neg = (sg_dst.long() + shift) % nb
    m = sg_mask & (torch.as_tensor(n_bd_valid) > 1)
    a = emb_tx[sg_src.long()]
    p = emb_bd[sg_dst.long()]
    ng = emb_bd[dst_neg]
    if loss_type == "triplet":
        per = (_dist(a, p) - _dist(a, ng) + margin).clamp(min=0.0)
        return _masked_sum(per, m)
    if loss_type == "bce":
        sum_p, cnt_p = _masked_sum(F.softplus(-(a * p).sum(-1)), m)
        sum_n, cnt_n = _masked_sum(F.softplus((a * ng).sum(-1)), m)
        return sum_p + sum_n, cnt_p + cnt_n
    raise ValueError(f"Unrecognized segmentation loss: '{loss_type}'.")


def cosine_weight_schedule(epoch: int, max_epochs: int, w_start, w_end,
                           normalize: bool = True) -> np.ndarray:
    """Cosine ramp of the loss weights from start to end over the epochs:
    a (3,) float32 array."""
    me = max(1, max_epochs - 1)
    t = min(epoch, me) / me
    alpha = 0.5 * (1.0 + np.cos(np.pi * t))
    w = np.asarray(w_end) + (np.asarray(w_start) - np.asarray(w_end)) * alpha
    if normalize:
        w = w / (w.sum() + 1e-8)
    return w.astype(np.float32)


def draw_loss_uniforms(n_tx: int, n_bd: int, n_sg: int,
                       generator: torch.Generator):
    """One tile's loss random numbers from a CPU generator, in a fixed
    order (tx sampler, bd sampler, segmentation shifts): ``(4, n_tx)`` and
    ``(4, n_bd)`` float32 uniforms and ``(n_sg,)`` float64 uniforms, on
    the CPU."""
    def uniforms(n):
        return torch.stack([torch.rand(n, generator=generator)
                            for _ in range(4)])

    tx = uniforms(n_tx)
    bd = uniforms(n_bd)
    return tx, bd, torch.rand(n_sg, generator=generator, dtype=torch.float64)


def loss_randoms(tile, tx_u: torch.Tensor, bd_u: torch.Tensor,
                 sg_u: torch.Tensor) -> LossRandoms:
    """The tile's :class:`LossRandoms` from its uniforms (on the tile's
    device, as :func:`draw_loss_uniforms` lays them out): the samplers'
    four rows each, and the segmentation shifts in ``[1, nb)``, computed
    on the device from the tile's boundary count."""
    nb = tile.bd_valid.sum().clamp(min=2)
    shift = (1 + torch.floor(sg_u * (nb - 1)).long()).clamp(max=nb - 1)
    return LossRandoms(tuple(tx_u), tuple(bd_u), shift)


def draw_loss_randoms(tile, generator: torch.Generator) -> LossRandoms:
    """One tile's loss random numbers from a CPU generator
    (:func:`draw_loss_uniforms`), on the tile's device."""
    dev = tile.tx_valid.device
    uniforms = draw_loss_uniforms(tile.tx_valid.shape[0],
                                  tile.bd_valid.shape[0],
                                  tile.sg_src.shape[0], generator)
    return loss_randoms(tile, *(u.to(dev) for u in uniforms))


def loss_stats(randoms: LossRandoms, emb, tile, tx_similarity,
               bd_similarity, *, tx_margin: float, sg_margin: float,
               sg_loss_type: str, use_interior: bool = True,
               sg_tx: Optional[torch.Tensor] = None):
    """Stacked ``(sum, count)`` statistics of the three losses for one
    tile: ``[s_tx, c_tx, s_bd, c_bd, s_sg, c_sg]`` float32, summable
    across tiles (or shards) before forming the masked means.
    ``use_interior`` restricts the tx/bd masks to tile interiors (margin
    tiles; whole-slide shards have none).  ``sg_tx`` replaces the tx
    embeddings of the link loss: a shard's supervision sources address
    its halo-extended tx rows."""
    tx_mask = tile.tx_valid & (tile.tx_cluster >= 0)
    bd_mask = tile.bd_valid & (tile.bd_cluster >= 0)
    if use_interior:
        tx_mask = tx_mask & tile.tx_interior
        bd_mask = bd_mask & tile.bd_interior
    tx_sort = ((tile.tx_sampler_sorted, tile.tx_sampler_counts)
               if tile.tx_sampler_sorted is not None else None)
    bd_sort = ((tile.bd_sampler_sorted, tile.bd_sampler_counts)
               if tile.bd_sampler_sorted is not None else None)
    s_tx, c_tx = triplet_loss(randoms.tx, emb["tx"], tile.tx_cluster,
                              tx_mask, tx_similarity, margin=tx_margin,
                              sort_structure=tx_sort)
    s_bd, c_bd = metric_loss(randoms.bd, emb["bd"], tile.bd_cluster,
                             bd_mask, bd_similarity, sort_structure=bd_sort)
    s_sg, c_sg = segmentation_loss(
        randoms.sg_shift, emb["tx"] if sg_tx is None else sg_tx,
        emb["bd"], tile.sg_src, tile.sg_dst,
        tile.sg_mask, tile.bd_valid.sum(), loss_type=sg_loss_type,
        margin=sg_margin)
    return torch.stack([s_tx, c_tx.float(), s_bd, c_bd.float(), s_sg,
                        c_sg.float()])
