"""The comparison that decides ``correct``: what the window's path
produced against the plain reference (``references/``), at the timed
sizes.

- ``fit``: the first ``compare_steps`` training steps of the set-up
  epoch, which ran through ``fit``'s own staging and compiled step (on a
  mesh, every shard's), are followed by the reference from the
  benchmark's weights, on every tile's table and the random numbers
  those steps were staged with: the first step's loss, each leaf's
  first gradient (from Adam's first moment after one step) and each
  leaf's change over the steps, by the norms' gap.
- ``predict``: after the window, the written table's rows of a sample of
  tiles (the largest and others drawn from the seed) against the
  reference's forward and scoring on those tiles' tables: each row's
  similarity, and how far below the reference's best candidate the
  written cell lies; and every row's similarity threshold against the
  reference's per-gene Yen and Li over the written similarities of the
  assigned rows, each row's gene taken from the raw slide.
- both: the compared tiles' tables against the raw slide: every valid
  transcript row holds its transcript's gene and position, and every
  neighbour edge joins two valid transcripts within the kNN distance (a
  transcript's edge to itself included: GATv2's self-loop).

The same readings are taken of the control: the reference computed in
float8 put in the program's place (the thresholds: in float32).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

GRAD_FLOOR = 1e-3          # leaves whose reference gradient norm lies under
                           # this share of the median leaf's are left out of
                           # the change


def _float32():
    """The reference's float32: no TF32 in its matmuls."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _norm(t) -> float:
    return float(t.double().norm())


def table_faults(env, tiles: List[dict]) -> int:
    """Rows and edges of the compared tiles' tables that disagree with
    the raw slide."""
    tx = env.slide.transcripts
    order = np.argsort(tx["row_index"].to_numpy())
    raw_gene = tx["feature_name"].to_numpy()[order]
    raw_xy = tx[["x", "y"]].to_numpy(np.float64)[order]
    max_dist = env.config["pipeline"]["transcripts_graph_max_dist"]
    faults = 0
    for t in tiles:
        v = t["tx_valid"]
        rows = t["tx_index"][v].astype(np.int64)
        faults += int((env.gene_names[t["tx_gene"][v]] != raw_gene[rows]).sum())
        faults += int((t["tx_pos"][v].astype(np.float32)
                       != raw_xy[rows].astype(np.float32)).any(1).sum())
        d, s = np.nonzero(t["tt_mask"])
        src = t["tt_idx"][d, s].astype(np.int64)
        bad = ~v[src] | ~v[d]
        # the program holds positions in float32 and joins within the
        # distance in float64 on them: so does the check
        xy = raw_xy.astype(np.float32).astype(np.float64)
        gd, gs = t["tx_index"][d].astype(np.int64), t["tx_index"][src]
        d2 = ((xy[gd] - xy[gs.astype(np.int64)]) ** 2).sum(1)
        bad |= d2 > max_dist ** 2
        faults += int(bad.sum())
    return faults


# -- fit ----------------------------------------------------------------------
def step_tiles(step) -> List[dict]:
    """Every tile of a recorded step's batch, in global tile order."""
    from harness import tile_dict

    return [tile_dict(step["batch"], b)
            for b in range(step["batch"].tx_gene.shape[0])]


def reference_fit(env, precision: str, half: bool = False,
                  half_tiles: bool = False, exchange: bool = True) -> dict:
    """The reference's steps on the recorded steps' tables and random
    numbers, from the benchmark's weights: ``{"losses", "grad1",
    "params_after", "params_before"}`` (leaves on the CPU).  Each step
    takes every tile of its batch, each with its own seed words and
    uniforms, into one joint loss.  ``half`` plants a fault: the tx loss
    over the first half of each tile's interior rows only, its mean taken
    over them; ``half_tiles`` another, on a batch of several tiles: the
    statistics of the first half of its tiles only; ``exchange=False``
    a third, on a batch of several tiles: the gradient of the joint loss
    through the first tile's statistics alone, as the first card's when
    the shards' gradients are not summed."""
    import torch
    from harness import to_torch

    ref, dev, model = env.reference, env.device, env.model_cfg
    p = {k: v.detach().clone().float() for k, v in env.weights.items()}
    before = {k: v.cpu().clone() for k, v in p.items()}
    state = {"t": 0, "m": {}, "v": {}}
    sims = [torch.from_numpy(np.array(a, np.float32)).to(dev)
            for a in (env.graph.tx_similarity, env.graph.bd_similarity)]
    weights = ref.loss_weights(0, env.model_cfg["max_epochs"], model).to(dev)
    losses, grad1 = [], None
    for s in env.recorder.steps:
        tiles = step_tiles(s)
        words = [tuple(int(w) for w in row) for row in s["seeds"].tolist()]
        per_tile = len(words) // len(tiles)
        inputs = []
        for b, t in enumerate(tiles[:len(tiles) // 2] if half_tiles
                              else tiles):
            tile = to_torch(t, dev)
            if half:
                rows = tile["tx_interior"] & tile["tx_valid"]
                rank = torch.cumsum(rows.long(), 0)
                tile["tx_interior"] = rows & (rank <= rows.sum() // 2)
            inputs.append((tile, words[b * per_tile:(b + 1) * per_tile],
                           s["tx_u"][b].to(dev), s["bd_u"][b].to(dev),
                           s["sg_u"][b].to(dev)))
        loss, grads = ref.train_step(p, state, inputs, weights, *sims, model,
                                     precision, exchange)
        losses.append(loss)
        if grad1 is None:
            grad1 = {k: g.cpu() for k, g in grads.items()}
    return {"losses": losses, "grad1": grad1, "params_before": before,
            "params_after": {k: v.cpu() for k, v in p.items()}}


def program_fit(env) -> dict:
    rec = env.recorder
    n = len(rec.steps)
    return {"losses": [row[0] for _, row, _ in env.trainer.step_log[:n]],
            "grad1": rec.grad1, "params_after": rec.params_after}


def loss_gaps(side: dict, ref: dict) -> List[float]:
    """Each compared step's relative loss gap."""
    return [abs(a - b) / max(abs(b), 1e-12)
            for a, b in zip(side["losses"], ref["losses"])]


def fit_readings(side: dict, ref: dict) -> Dict[str, float]:
    """loss1_gap: the first step's relative loss gap (the later steps'
    gaps carry the parameters' drift apart, by the sign of Adam's
    normalized updates, and swing from seed to seed); loss_gap_worst:
    the worst of the compared steps' gaps, for a traffic mix that limits
    it; grad_gap and change_gap: the worst leaf's gap of norms against
    the larger of its reference norm and the median leaf's."""
    gaps = loss_gaps(side, ref)
    g_ref = {k: _norm(v) for k, v in ref["grad1"].items()}
    med_g = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(_norm(side["grad1"][k]) - g) / max(g, med_g)
                   for k, g in g_ref.items())
    moved = [k for k, g in g_ref.items() if g >= GRAD_FLOOR * med_g]
    before = ref["params_before"]
    d_ref = {k: _norm(ref["params_after"][k] - before[k]) for k in moved}
    med_d = float(np.median(list(d_ref.values())))
    change_gap = max(
        abs(_norm(side["params_after"][k] - before[k]) - d) / max(d, med_d)
        for k, d in d_ref.items())
    return {"loss1_gap": gaps[0], "loss_gap_worst": max(gaps),
            "grad_gap": grad_gap, "change_gap": change_gap}


def fit_check(env, control: bool = False) -> Dict[str, float]:
    _float32()
    ref = reference_fit(env, "f32")
    side = reference_fit(env, "fp8") if control else program_fit(env)
    out = fit_readings(side, ref)
    out["table_faults"] = table_faults(
        env, [t for s in env.recorder.steps for t in step_tiles(s)])
    return out


# -- predict ------------------------------------------------------------------
def predict_tiles_sample(env) -> List[dict]:
    """The compared tiles' tables as the predict pass extracts them: the
    largest tile and ``sample_tiles - 1`` others drawn from the seed."""
    from harness import tile_dict

    specs = env.predict_tiles
    n = min(env.traffic["sample_tiles"], len(specs))
    largest = int(np.argmax([s.tx_rows.size for s in specs]))
    rng = np.random.default_rng([env.seed, 1])
    others = [i for i in range(len(specs)) if i != largest]
    chosen = {id(specs[i]) for i in
              [largest] + list(rng.choice(others, n - 1, replace=False))}
    tr = env.trainer
    tiles = []
    for plan in tr._batch_plans(specs, use_xlo=True):
        if any(id(s) in chosen for s in plan[0]):
            batch = tr._build_batch(plan, cache=False)
            tiles += [tile_dict(batch, b) for b, s in enumerate(plan[0])
                      if id(s) in chosen]
    return tiles


def read_table(env) -> Dict[str, np.ndarray]:
    """The written table's columns, sorted by row: ``rows``, ``sim``,
    ``enc`` (the cell's encoding, -1 for none), ``assigned`` (a cell is
    written) and ``thr`` (the row's gene's similarity threshold)."""
    import pyarrow.parquet as pq

    t = pq.read_table(env.out_dir / "segger_segmentation.parquet",
                      columns=["row_index", "segger_similarity",
                               "segger_cell_id", "similarity_threshold"]
                      ).to_pandas()
    enc_of = {c: i for i, c in enumerate(env.graph.bd_cell_id)}
    cells = t["segger_cell_id"].astype(object).to_numpy()
    enc = np.array([-1 if c is None or (isinstance(c, float) and
                                          math.isnan(c)) else enc_of.get(c, -2)
                    for c in cells], np.int64)
    rows = t["row_index"].to_numpy(np.int64)
    order = np.argsort(rows, kind="stable")
    return {"rows": rows[order],
            "sim": t["segger_similarity"].to_numpy(np.float64)[order],
            "enc": enc[order],
            "assigned": t["segger_cell_id"].notna().to_numpy()[order],
            "thr": t["similarity_threshold"].to_numpy(np.float64)[order]}


def raw_genes(env, rows: np.ndarray) -> np.ndarray:
    """The raw slide's gene of each row."""
    tx = env.slide.transcripts
    order = np.argsort(tx["row_index"].to_numpy())
    return tx["feature_name"].to_numpy()[order][rows]


def thresholds_of(env, table: dict, dtype=np.float64, fault=None
                  ) -> np.ndarray:
    """The reference's threshold of each written row's gene (the raw
    slide's), from the written similarities of the assigned rows."""
    import pandas as pd

    genes = raw_genes(env, table["rows"])
    assigned = table["assigned"]
    per_gene, median = env.reference.gene_thresholds(
        table["sim"][assigned], genes[assigned], dtype, fault)
    return pd.Series(genes).map(per_gene).fillna(median).to_numpy(
        np.float64)


def threshold_gap(env, table: dict, side: Optional[np.ndarray] = None
                  ) -> float:
    """thr_gap: the widest gap between a row's threshold (the written
    column, or ``side``) and the reference's for its gene."""
    ref = thresholds_of(env, table)
    side = table["thr"] if side is None else side
    if not ref.size:
        return 0.0
    return float(np.abs(side - ref).max())


def reference_predict(env, tiles, precision: str) -> List[dict]:
    """Per tile: the reference's best similarity, the cell it picks, and
    each candidate slot's similarity and cell, on the CPU."""
    import torch
    from harness import to_torch

    out = []
    with torch.no_grad():
        for t in tiles:
            tt = to_torch(t, env.device)
            emb = env.reference.forward(env.weights, tt, env.model_cfg, None,
                                        precision)
            best, cell, sims = env.reference.score(emb, tt, precision)
            out.append({"best": best.cpu().double().numpy(),
                        "cell": cell.cpu().numpy(),
                        "sims": sims.cpu().double().numpy()})
    return out


def predict_readings(tiles, ref, side_sim, side_cell, side_present
                     ) -> Dict[str, float]:
    """sim_gap: the widest similarity gap over rows with candidates;
    choice_gap: the widest gap by which the chosen cell's reference
    similarity lies below the reference's best (2 for a cell that is no
    candidate); missing: rows not written, or assigned against whether
    they have a candidate."""
    sim_gap = choice_gap = 0.0
    missing = 0
    for t, r, ss, sc, sp in zip(tiles, ref, side_sim, side_cell,
                                side_present):
        rows = np.flatnonzero(t["tx_valid"] & t["tx_interior"])
        has = t["cand_mask"][rows].any(1)
        missing += int((~sp[rows]).sum())
        ok = sp[rows]
        missing += int((has & ok & (sc[rows] < 0)).sum()
                       + (~has & ok & (sc[rows] >= 0)).sum())
        sel = rows[has & ok & (sc[rows] >= 0)]
        if not sel.size:
            continue
        sim_gap = max(sim_gap, float(np.abs(ss[sel] - r["best"][sel]).max()))
        cand_cells = np.where(t["cand_mask"][sel],
                              t["bd_index"][t["cand_idx"][sel]], -3)
        match = cand_cells == sc[sel][:, None]
        picked = np.where(match, r["sims"][sel], -np.inf).max(1)
        gap = np.where(np.isfinite(picked), r["best"][sel] - picked, 2.0)
        choice_gap = max(choice_gap, float(gap.max()))
    return {"sim_gap": sim_gap, "choice_gap": choice_gap,
            "missing": float(missing)}


def predict_check(env, control: bool = False) -> Dict[str, float]:
    _float32()
    tiles = predict_tiles_sample(env)
    ref = reference_predict(env, tiles, "f32")
    if control:
        ctl = reference_predict(env, tiles, "fp8")
        sims = [c["best"] for c in ctl]
        cells = [c["cell"] for c in ctl]
        present = [np.ones_like(c["cell"], bool) for c in ctl]
    else:
        table = read_table(env)
        rows, sim, enc = table["rows"], table["sim"], table["enc"]
        sims, cells, present = [], [], []
        for t in tiles:
            idx = t["tx_index"].astype(np.int64)
            at = np.clip(np.searchsorted(rows, idx), 0, max(rows.size - 1, 0))
            found = (rows.size > 0) & (rows[at] == idx) & t["tx_valid"]
            sims.append(np.where(found, sim[at], np.nan))
            cells.append(np.where(found, enc[at], -1))
            present.append(found)
    out = predict_readings(tiles, ref, sims, cells, present)
    if control:
        # the thresholds in float32, over the written similarities
        table = read_table(env)
        out["thr_gap"] = threshold_gap(
            env, table, thresholds_of(env, table, np.float32))
    else:
        out["thr_gap"] = threshold_gap(env, table)
    out["table_faults"] = table_faults(env, tiles)
    return out


CHECKS = {"fit": fit_check, "predict": predict_check}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every reading within its limit (a missing or non-finite reading
    fails)."""
    return all(k in readings and math.isfinite(readings[k])
               and readings[k] <= lim for k, lim in limits.items())
