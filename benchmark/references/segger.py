"""Plain PyTorch reference of segger on one tile: the encoder, the three
training losses, Adam and the candidate scoring.

segger (dpeerlab/segger) embeds transcripts (tx) and cells (bd) with a
stack of heterogeneous GATv2 layers (PyG ``GATv2Conv``, ``concat=True``,
negative slope 0.2, attention dropout 0.2) and trains them with a margin
triplet loss on transcripts, a cosine metric loss on cells and a triplet
link loss on the tx->cell supervision edges; prediction gives each
transcript its most similar candidate cell.  This file writes that down
once more in plain operations over edge lists, in float32 (the caller
turns TF32 off), with no kernel, no padding layout and no code of the
program.  It reads a tile as a dict of tensors (its node arrays, the
``tt``, ``tb`` and ``cand`` tables as ``*_idx`` / ``*_mask``, the
supervision edges, the sampler blocks and the degree segments' bounds),
parameters as a dict named as ``param_shapes`` lists them, and the
step's random numbers as the step drew them.

``precision="fp8"`` rounds every matmul and gather input to float8
(e4m3) and back: the control, one precision below the bfloat16 the
configuration states, that the comparison has to reject.

The writer's per-gene thresholds (``gene_thresholds``) are plain NumPy:
segger's writer takes, for each gene, the lesser of Yen's and Li's
thresholds (skimage's ``threshold_yen`` and ``threshold_li``) over the
similarities of its assigned transcripts, and gives a gene whose Li
iteration does not converge in 250 steps, or that has no assigned
transcript, the median of the other genes' thresholds.  They run in
float64, the writer's precision; ``np.float32`` is their control.

Departures from a textbook segger, each the semantics the benchmarked
program states and the comparison holds it to:

- a gene code of -1 (a gene that the features stage dropped) reads the
  embedding's last row and sends it no gradient;
- the attention dropout keeps a slot when a 32-bit hash of its flat
  position in its launch's table, under the launch's two seed words, is
  at most ``round(0.8 * 2**31) - 1``, and then scales it by 1.25;
- the triplet samplers draw a cluster by inverse CDF over the anchor's
  cluster-similarity row (dissimilarity for negatives) restricted to the
  clusters present, then a member uniformly from the tile's sampler
  blocks, from four uniforms per anchor.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_SLOPE = 0.2
DROPOUT = 0.2
FREQ_DIM = 256
MAX_PERIOD = 10000.0
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


# -- parameters -------------------------------------------------------------
def param_shapes(model: dict, n_genes: int, n_bd_features: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape (torch layout: a Linear weight is
    (out, in))."""
    ic, heads = model["in_channels"], model["n_heads"]
    half = ic // 2
    s = {"gene_embedding.embedding": (n_genes, ic),
         "bd_linear.weight": (ic, n_bd_features), "bd_linear.bias": (ic,),
         "pos_emb.Dense_0.weight": (half, FREQ_DIM),
         "pos_emb.Dense_0.bias": (half,),
         "pos_emb.Dense_1.weight": (half, half),
         "pos_emb.Dense_1.bias": (half,)}
    width = ic + 2 * half
    widths = ([model["hidden_channels"]] * (1 + model["n_mid_layers"])
              + [model["out_channels"]])
    for i, w in enumerate(widths):
        hc = heads * w
        for conv in ("tt", "tb"):
            p = f"conv_{i}.{conv}."
            s[p + "att"] = (1, heads, w)
            s[p + "bias"] = (hc,)
            for lin in ("lin_l", "lin_r"):
                s[p + lin + ".weight"] = (hc, width)
                s[p + lin + ".bias"] = (hc,)
        width = hc
    for t in ("tx", "bd"):
        s[f"lin_last_{t}.weight"] = (model["out_channels"], width)
        s[f"lin_last_{t}.bias"] = (model["out_channels"],)
    return s


def make_params(shapes: Dict[str, Tuple[int, ...]], seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """Weights from ``seed``: one normal draw on ``device`` for all of
    them, scaled per tensor (1/sqrt(fan in) for matrices, 1/sqrt(C) for
    attention vectors, 0.1 for biases, 1 for the gene embedding)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        if name.endswith("embedding"):
            scale = 1.0
        elif name.endswith("att"):
            scale = shape[-1] ** -0.5
        elif name.endswith("bias"):
            scale = 0.1
        else:
            scale = shape[1] ** -0.5
        out[name] = (flat[off:off + n] * scale).view(shape)
        off += n
    return out


# -- numerics ---------------------------------------------------------------
def _q(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision``; in float8 with the gradient passed
    straight through, as float8 training casts."""
    if precision == "f32":
        return x
    if precision == "fp8":
        return x + (x.to(torch.float8_e4m3fn).to(torch.float32) - x).detach()
    raise ValueError(f"unknown precision {precision!r}")


def _linear(x, p, name, precision):
    return _q(x, precision) @ _q(p[name + ".weight"], precision).T \
        + p[name + ".bias"]


def _positional(p, pos, valid, precision):
    """Per-axis sinusoidal features of tile-normalized coordinates
    through Linear-SiLU-Linear, both axes concatenated."""
    vm = valid[:, None]
    lo = torch.where(vm, pos, math.inf).amin(0)
    hi = torch.where(vm, pos, -math.inf).amax(0)
    x = (pos - lo) / (hi - lo + 1e-8)
    half = FREQ_DIM // 2
    freqs = torch.exp(-math.log(MAX_PERIOD) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / half)
    a = x[..., None] * freqs
    emb = torch.cat([torch.cos(a), torch.sin(a)], -1)       # (N, 2, 256)
    h = F.silu(_linear(emb, p, "pos_emb.Dense_0", precision))
    h = _linear(h, p, "pos_emb.Dense_1", precision)
    return h.reshape(h.shape[0], -1)


def _fmix32(x):
    m = 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & m
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & m
    return x ^ (x >> 16)


def keep_multipliers(n_rows: int, k: int, heads: int, words, device
                     ) -> torch.Tensor:
    """(n_rows, k, heads) dropout multipliers of one launch from its two
    seed words (ints, as unsigned 32-bit values)."""
    s0, s1 = (int(w) & 0xFFFFFFFF for w in words)
    m = 0xFFFFFFFF
    pos = torch.arange(n_rows * k * heads, dtype=torch.int64,
                       device=device)
    bits = _fmix32(_fmix32(pos ^ s0) ^ ((s1 + 0x9E3779B9) & m)) & 0x7FFFFFFF
    keep_p = 1.0 - DROPOUT
    thresh = min(round(keep_p * 2**31), 2**31) - 1
    return torch.where(bits <= thresh, 1.0 / keep_p, 0.0).float().view(
        n_rows, k, heads)


def tt_bounds(tile) -> List[Tuple[int, int, int]]:
    """(start, stop, K) of the tt table's launches (``counts.tt_bounds``,
    the benchmark's one statement of the degree buckets)."""
    from counts import tt_bounds as bounds

    return bounds(*tile["tt_idx"].shape, tile["n_lo"], tile["k_lo"],
                  tile["n_xlo"], tile["k_xlo"])


def _conv(p, name, x_src, x_dst, idx, mask, keep, heads, precision):
    """One GATv2 convolution over the valid slots of a padded table
    (rows: destinations, idx: sources)."""
    rows, slots = mask.nonzero(as_tuple=True)
    src = idx[rows, slots].long()
    xl = _linear(x_src, p, name + ".lin_l", precision)
    xr = _linear(x_dst, p, name + ".lin_r", precision)
    n, hc = xr.shape
    c = hc // heads
    gathered = _q(xl, precision)[src]
    s = F.leaky_relu(gathered + _q(xr, precision)[rows], NEG_SLOPE)
    att = _q(p[name + ".att"][0], precision)
    e = (_q(s, precision).view(-1, heads, c) * att).sum(-1)   # (E, H)
    r = rows[:, None].expand(-1, heads)
    emax = torch.full((n, heads), -math.inf, device=e.device).scatter_reduce(
        0, r, e.detach(), "amax")
    ez = torch.exp(e - emax[rows])
    den = torch.zeros((n, heads), device=e.device).index_add(0, rows, ez)
    alpha = ez / den[rows]
    if keep is not None:
        alpha = alpha * keep[rows, slots]
    msg = alpha[..., None] * gathered.view(-1, heads, c)
    out = torch.zeros((n, heads, c), device=e.device).index_add(0, rows, msg)
    return out.reshape(n, hc) + p[name + ".bias"]


def forward(p, tile, model: dict, seeds: Optional[Sequence] = None,
            precision: str = "f32") -> Dict[str, torch.Tensor]:
    """Unit-norm embeddings ``{"tx": (N_tx, out), "bd": (N_bd, out)}`` of
    one tile.  ``seeds``: the (2,) words of every edge-stage launch in
    order (layer by layer: the tt launches, then tb), for dropout."""
    heads = model["n_heads"]
    table = p["gene_embedding.embedding"]
    gene = tile["tx_gene"].long()
    known = (gene >= 0)[:, None]
    x_tx = torch.where(known, table[gene.clamp(min=0)],
                       table.detach()[-1])
    x_bd = _linear(tile["bd_x"], p, "bd_linear", precision)
    x_tx = F.gelu(torch.cat(
        [x_tx, _positional(p, tile["tx_pos"], tile["tx_valid"], precision)],
        -1))
    x_bd = F.gelu(torch.cat(
        [x_bd, _positional(p, tile["bd_pos"], tile["bd_valid"], precision)],
        -1))
    n_tx, k_tt = tile["tt_idx"].shape
    n_bd, k_tb = tile["tb_idx"].shape
    words = iter(seeds) if seeds is not None else None
    n_layers = model["n_mid_layers"] + 2
    for i in range(n_layers):
        keep_tt = keep_tb = None
        if words is not None:
            keep_tt = torch.zeros((n_tx, k_tt, heads), device=x_tx.device)
            for a, b, k in tt_bounds(tile):
                keep_tt[a:b, :k] = keep_multipliers(b - a, k, heads,
                                                    next(words), x_tx.device)
            keep_tb = keep_multipliers(n_bd, k_tb, heads, next(words),
                                       x_tx.device)
        o_tx = _conv(p, f"conv_{i}.tt", x_tx, x_tx, tile["tt_idx"],
                     tile["tt_mask"], keep_tt, heads, precision)
        o_bd = _conv(p, f"conv_{i}.tb", x_tx, x_bd, tile["tb_idx"],
                     tile["tb_mask"], keep_tb, heads, precision)
        x_tx, x_bd = F.gelu(o_tx), F.gelu(o_bd)
    e_tx = _linear(x_tx, p, "lin_last_tx", precision)
    e_bd = _linear(x_bd, p, "lin_last_bd", precision)
    return {"tx": F.normalize(e_tx, dim=-1, eps=1e-12),
            "bd": F.normalize(e_bd, dim=-1, eps=1e-12)}


# -- losses -----------------------------------------------------------------
def _sample(u, labels, valid, similarity, sorted_rows, counts):
    """Positive and negative members per anchor: ``(pos, neg, d_pos,
    d_neg, ok)``."""
    eps = 1e-8
    c = similarity.shape[0]
    sim = similarity.float().clone()
    sim.fill_diagonal_(1.0)
    lab = torch.where(valid, labels, 0).long()
    counts = counts.long()
    present = (counts > 0).float()
    offsets = torch.cumsum(counts, 0) - counts
    m = sorted_rows.shape[0]

    def draw(weights, u_cluster, u_member):
        w = weights[lab] * present[None, :]
        tot = w.sum(1)
        cdf = torch.cumsum(w, 1) / tot.clamp(min=1e-30)[:, None]
        cl = (cdf < u_cluster[:, None]).sum(1).clamp(0, c - 1)
        size = counts[cl]
        j = torch.floor(u_member * size.float()).long().clamp(min=0)
        j = torch.minimum(j, (size - 1).clamp(min=0))
        at = offsets[cl] + j
        member = torch.where(at < m, sorted_rows.long()[at.clamp(max=m - 1)],
                             0)
        return member, cl, (tot > 0) & (size > 0)

    pos, pcl, ok_p = draw(sim.clamp(min=eps), u[0], u[2])
    neg, ncl, ok_n = draw((-sim).clamp(min=eps), u[1], u[3])
    dist = 1.0 - sim.clamp(min=eps)
    return pos, neg, dist[lab, pcl], dist[lab, ncl], valid & ok_p & ok_n


def _dist(a, b):
    return torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12)


def loss_parts(emb, tile, tx_u, bd_u, sg_u, tx_similarity, bd_similarity,
               model: dict) -> torch.Tensor:
    """``[sum_tx, n_tx, sum_bd, n_bd, sum_sg, n_sg]`` of one tile: the tx
    triplet loss and the bd metric loss over interior clustered nodes,
    the link loss over the supervision edges with modular-shift
    negatives."""
    tx_mask = tile["tx_valid"] & (tile["tx_cluster"] >= 0) \
        & tile["tx_interior"]
    bd_mask = tile["bd_valid"] & (tile["bd_cluster"] >= 0) \
        & tile["bd_interior"]
    a = emb["tx"]
    pos, neg, _, _, ok = _sample(tx_u, tile["tx_cluster"], tx_mask,
                                 tx_similarity, tile["tx_sampler_sorted"],
                                 tile["tx_sampler_counts"])
    per = (_dist(a, a[pos]) - _dist(a, a[neg])
           + model["tx_margin"]).clamp(min=0)
    s_tx, c_tx = torch.where(ok, per, 0.0).sum(), ok.sum()

    b = emb["bd"]
    pos, neg, dp, dn, ok = _sample(bd_u, tile["bd_cluster"], bd_mask,
                                   bd_similarity, tile["bd_sampler_sorted"],
                                   tile["bd_sampler_counts"])

    def cos(x, y):
        return (x * y).sum(-1) / (x.norm(dim=-1).clamp(min=1e-8)
                                  * y.norm(dim=-1).clamp(min=1e-8))

    se = (cos(b, b[pos]) - (1 - dp)) ** 2 + (cos(b, b[neg]) - (1 - dn)) ** 2
    s_bd, c_bd = torch.where(ok, se, 0.0).sum(), ok.sum()

    n_valid = tile["bd_valid"].sum()
    nb = n_valid.clamp(min=2)
    shift = (1 + torch.floor(sg_u * (nb - 1)).long()).clamp(max=nb - 1)
    dst = tile["sg_dst"].long()
    neg = (dst + shift) % nb
    src = tile["sg_src"].long()
    per = (_dist(a[src], b[dst]) - _dist(a[src], b[neg])
           + model["sg_margin"]).clamp(min=0)
    m = tile["sg_mask"] & (n_valid > 1)
    s_sg, c_sg = torch.where(m, per, 0.0).sum(), m.sum()
    return torch.stack([s_tx, c_tx.float(), s_bd, c_bd.float(), s_sg,
                        c_sg.float()])


def step_loss(stats: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The weighted sum of the three masked means."""
    parts = stats[0::2] / stats[1::2].clamp(min=1.0)
    return (weights * parts).sum()


def loss_weights(epoch: int, max_epochs: int, model: dict) -> torch.Tensor:
    """The cosine ramp of the three loss weights from their start to
    their end values over the epochs, normalized to sum to one."""
    keys = ("tx", "bd", "sg")
    start = torch.tensor([model[f"{k}_weight_start"] for k in keys],
                         dtype=torch.float64)
    end = torch.tensor([model[f"{k}_weight_end"] for k in keys],
                       dtype=torch.float64)
    me = max(1, max_epochs - 1)
    t = min(epoch, me) / me
    w = end + (start - end) * 0.5 * (1.0 + math.cos(math.pi * t))
    return (w / (w.sum() + 1e-8)).float()


def train_step(p, state, tiles, weights, tx_similarity, bd_similarity,
               model: dict, precision: str = "f32", exchange: bool = True):
    """One training step over a batch of tiles: each tile's forward with
    dropout and its ``loss_parts``, the statistics summed over the tiles
    (the joint masked means), the step loss, its gradient, one Adam
    update of ``p`` (a dict of leaf tensors) with ``state`` (``{"t": int,
    "m": {}, "v": {}}``).  ``tiles``: per tile, ``(tile, seeds, tx_u,
    bd_u, sg_u)``, its launches' seed words and its loss uniforms.  A
    tile with no valid node (a batch's padding) has no statistics and is
    left out: its forward over no rows is undefined.  ``exchange=False``
    takes the gradient through the first tile's statistics alone (the
    others' enter the loss as constants).  Returns ``(loss, grads)``
    before the update."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    stats = None
    for tile, seeds, tx_u, bd_u, sg_u in tiles:
        if not (tile["tx_valid"].any() or tile["bd_valid"].any()):
            continue
        emb = forward(leaves, tile, model, seeds, precision)
        parts = loss_parts(emb, tile, tx_u, bd_u, sg_u, tx_similarity,
                           bd_similarity, model)
        if stats is not None and not exchange:
            parts = parts.detach()
        stats = parts if stats is None else stats + parts
    loss = step_loss(stats, weights)
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True)))
    grads = {k: torch.zeros_like(p[k]) if g is None else g
             for k, g in grads.items()}
    adam(p, grads, state, model["learning_rate"])
    return float(loss.detach()), grads


def adam(p, grads, state, lr: float) -> None:
    """Adam (Kingma & Ba) with bias correction, in place on ``p``."""
    b1, b2 = ADAM_BETAS
    state["t"] += 1
    t = state["t"]
    with torch.no_grad():
        for k, g in grads.items():
            m = state["m"].setdefault(k, torch.zeros_like(g))
            v = state["v"].setdefault(k, torch.zeros_like(g))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt() + ADAM_EPS
            p[k] = p[k] - lr * (m / (1 - b1 ** t)) / denom


# -- prediction -------------------------------------------------------------
def score(emb, tile, precision: str = "f32"):
    """Each transcript's best candidate cell: ``(similarity (N,), cell
    encoding (N,) with -1 where it has no candidate, and the (N, K)
    similarity of every candidate slot, -inf on masked slots)``."""
    idx, mask = tile["cand_idx"].long(), tile["cand_mask"]
    tx = _q(emb["tx"], precision)
    bd = _q(emb["bd"], precision)
    sims = (tx[:, None, :] * bd[idx.clamp(0, bd.shape[0] - 1)]).sum(-1)
    sims = torch.where(mask, sims, -math.inf)
    best, slot = sims.max(1)
    cell = tile["bd_index"].long()[idx.gather(1, slot[:, None])[:, 0]]
    has = mask.any(1)
    return (torch.where(has, best, -math.inf),
            torch.where(has, cell, -1), sims)


# -- the writer's per-gene thresholds -----------------------------------------
LI_MAX_ITER = 250
LI_TOL = 1e-6              # of the values' range: where Li's iteration stops


def threshold_yen(values: np.ndarray, dtype=np.float64,
                  nbins: int = 256) -> float:
    """Yen's maximum-correlation threshold: the centre of the histogram
    bin t (``nbins`` over the values' range) that maximizes
    2 ln(P(1 - P)) - ln(S_b S_f), with P the mass of the bins up to t,
    S_b the sum of their squared masses and S_f that of the bins above;
    cuts with P at 0 or 1 (or logs of 0) left out."""
    v = np.asarray(values, dtype)
    lo, hi = v.min(), v.max()
    if lo == hi:
        return float(lo)
    hist, edges = np.histogram(v, bins=nbins, range=(lo, hi))
    centres = (edges[:-1] + edges[1:]) / 2
    pmf = (hist / hist.sum()).astype(dtype)
    p1 = np.cumsum(pmf)
    p1_sq = np.cumsum(pmf ** 2)
    p2_sq = np.cumsum(pmf[::-1] ** 2)[::-1]
    p, s_b, s_f = p1[:-1], p1_sq[:-1], p2_sq[1:]
    tiny = 1e-30
    crit = (2.0 * np.log(np.clip(p * (1.0 - p), tiny, None))
            - np.log(np.clip(s_b * s_f, tiny, None)))
    inside = (p > 0) & (p < 1)
    if not inside.any():
        return float(centres[len(centres) // 2])
    return float(centres[int(np.argmax(np.where(inside, crit, -np.inf)))])


def threshold_li(values: np.ndarray, dtype=np.float64) -> Optional[float]:
    """Li's minimum cross-entropy threshold by its iteration from the
    mean, t <- (mu_b - mu_f) / (ln mu_b - ln mu_f) over the values moved
    to start at 0, until t moves by under ``LI_TOL`` of the range; None
    where ``LI_MAX_ITER`` steps do not get there."""
    v = np.asarray(values, dtype)
    lo, hi = v.min(), v.max()
    if lo == hi:
        return float(lo)
    v = v - lo
    span = hi - lo
    floor = span * 1e-9            # keeps both means above 0 for the log
    t = v.mean()
    for _ in range(LI_MAX_ITER):
        fore = v > t
        mu_b = v[~fore].mean() if (~fore).any() else 0.0
        mu_f = v[fore].mean() if fore.any() else span
        mu_b, mu_f = max(mu_b, floor), max(mu_f, floor)
        if abs(np.log(mu_b) - np.log(mu_f)) < 1e-12:
            return float(t + lo)
        t_next = (mu_b - mu_f) / (np.log(mu_b) - np.log(mu_f))
        if abs(t_next - t) < span * LI_TOL:
            return float(t_next + lo)
        t = t_next
    return None


def gene_thresholds(sim: np.ndarray, gene: np.ndarray, dtype=np.float64,
                    fault: Optional[str] = None) -> Tuple[dict, float]:
    """Each gene's threshold over its assigned transcripts' similarities
    (``sim`` and ``gene`` in the table's row order), and the median of
    them that the other genes take: ``({gene: threshold}, median)``.

    ``fault`` plants a wrong threshold, a shortcut a writer could take:
    ``"yen"`` Yen's alone, ``"sample"`` from every tenth similarity of a
    gene, ``"median"`` one median for every gene."""
    out, failed = {}, []
    order = np.argsort(gene, kind="stable")
    g_sorted = gene[order]
    starts = np.flatnonzero(np.r_[True, g_sorted[1:] != g_sorted[:-1]])
    for a, b in zip(starts, np.r_[starts[1:], g_sorted.size]):
        vals = sim[order[a:b]]
        if fault == "sample":
            vals = vals[::10]
        yen = threshold_yen(vals, dtype)
        li = yen if fault == "yen" else threshold_li(vals, dtype)
        if li is None:
            failed.append(g_sorted[a])
        else:
            out[g_sorted[a]] = min(yen, li)
    median = float(np.quantile(list(out.values()), 0.5)) if out else 0.0
    if fault == "median":
        out = {}
    for g in failed:
        out[g] = median
    return out, median
