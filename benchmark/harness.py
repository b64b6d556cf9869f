"""The benchmark harness of the PyTorch and CUDA port (``segger_tpu_torch``).

One call of :func:`run_cell` runs one cell of ``BENCHMARK.json`` once: it
makes the cell's slide from the seed with the frozen generator, builds
the program's pipeline (features, graph, tiles) and trainer with weights
from the seed, warms up, measures the traffic mix's window, checks what
the window's path produced against the plain reference, and returns the
result line.  Everything that belongs to one configuration, traffic mix
or per-layer metric is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` under this
folder, the reference in ``references/<reference>.py`` as the
configuration names it.

A traffic mix is one of two kinds, each a parametrised driver:

- ``fit``: set-up runs a first whole ``SeggerTrainer.fit`` (every graph
  capture, the tile cache filled, the compared steps); the window
  runs whole epochs, cut at epoch ends through ``fit``'s
  ``on_epoch_end`` hook, and starts a new ``fit`` call on the same
  trainer when the schedule of ``max_epochs`` is spent.  The rate is the
  fit tiles' transcripts times the epochs completed over their seconds.
- ``predict``: set-up runs one warm-up pass; the window runs whole
  passes of ``SeggerTrainer.predict`` over the halo tiles and the
  ``SegmentationWriter`` table, until the seconds have passed.  The rate
  is the graph's transcripts (set-up checks that it keeps the panel)
  times the passes over their seconds.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

import hooks
import tracing

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "segger_tpu")


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, is missing or malformed."""


class WindowClosed(Exception):
    """Raised from ``on_epoch_end`` when the window's epochs are done."""


# -- finding the pieces by name ---------------------------------------------
def load_spec(root: Path = REPO) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    return json.loads(path.read_text())


def load_json(kind: str, name: str, bench: Path = ROOT) -> dict:
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"{kind} {name!r}: {path} is missing")
    return json.loads(path.read_text())


def load_module(path: Path):
    """Import a file of this folder by its path (its name may hold dots)."""
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, root: Path = REPO, bench: Path = ROOT) -> dict:
    """A cell's configuration, traffic mix, chips, and the end-to-end and
    per-layer metrics it reports (with each per-layer metric's reader)."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[workload]

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [dict(m, reader=load_module(
        bench / "metrics" / f"{m['name']}.py"))
        for m in spec["per_layer"] if m["moves"] in names and reports(m)]
    return {"workload": w, "config": load_json("configs", w["config"], bench),
            "traffic": load_json("traffic", w["traffic"], bench),
            "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": spec["run_seconds"], "work": bench / ".work"}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's, optax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the program's side ------------------------------------------------------
def _port():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import segger_tpu_torch.pipeline as pipeline
    import segger_tpu_torch.train.trainer as trainer
    import segger_tpu_torch.data.partition as partition
    import segger_tpu_torch.data.writer as writer
    import segger_tpu_torch.utils_profiling as profiling
    import segger_tpu_torch.ops.postgather as postgather
    import segger_tpu_torch.ops.score as score
    import segger_tpu_torch.parallel.mesh as mesh
    return dict(pipeline=pipeline, trainer=trainer, partition=partition,
                writer=writer, profiling=profiling, postgather=postgather,
                score=score, mesh=mesh)


def launch_counts(port) -> Dict[str, int]:
    """The port's kernel launch counters: K1 (forward, no dropout), K2
    (forward, hashed dropout), K3 (backward), K5 (scoring)."""
    fwd = port["postgather"].edge_stage_fwd.launches
    bwd = port["postgather"].edge_stage_bwd.launches
    return {"K1": fwd["nokeep"], "K2": fwd["prng"],
            "K3": sum(bwd.values()), "K5": port["score"].score_max.launches}


def tile_dict(batch, b: int = 0) -> dict:
    """Tile ``b`` of a NumPy TileGraph batch as a dict of NumPy arrays and
    the degree-segment ints, under the reference's names."""
    d = {}
    for key in ("tx_gene", "tx_pos", "tx_valid", "tx_interior",
                "tx_cluster", "tx_index", "bd_x", "bd_pos", "bd_valid",
                "bd_interior", "bd_cluster", "bd_index", "sg_src", "sg_dst",
                "sg_mask", "tx_sampler_sorted", "tx_sampler_counts",
                "bd_sampler_sorted", "bd_sampler_counts"):
        d[key] = np.asarray(getattr(batch, key)[b])
    for t in ("tt", "tb", "cand"):
        csr = getattr(batch, t)
        d[f"{t}_idx"] = np.asarray(csr.idx[b])
        d[f"{t}_mask"] = np.asarray(csr.mask[b])
    for key, attr in (("n_lo", "tt_n_lo"), ("k_lo", "tt_k_lo"),
                      ("n_xlo", "tt_n_xlo"), ("k_xlo", "tt_k_xlo")):
        d[key] = int(getattr(batch, attr))
    if not (d["n_lo"] > 0 and batch.tt_lo_t is not None):
        d["n_lo"] = d["n_xlo"] = 0
    elif not (d["n_xlo"] > 0 and batch.tt_xlo_t is not None):
        d["n_xlo"] = 0
    return d


def to_torch(tile: dict, device) -> dict:
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v for k, v in tile.items()}


PANEL_SHARE = 0.99         # of the configuration's genes, the least that
                           # the graph has to keep


def check_panel(transcripts, graph, config: dict):
    """Set-up fails unless the graph keeps the configuration's panel: no
    gene that the slide's count matrix holds (its transcripts in a
    nucleus of a cell) is filtered out, with every transcript of those
    genes, and at least ``PANEL_SHARE`` of the configuration's genes are
    in.  A configuration cut to a smaller slide scales
    ``genes_min_counts`` down so that the filter drops none; a gene with
    no transcript in a nucleus has no count and cannot enter."""
    from generator import NUCLEUS

    if config["pipeline"]["segmentation_graph_mode"] != "nucleus":
        raise SpecError("the panel check counts nucleus transcripts")
    counted = (transcripts["cell_compartment"] == NUCLEUS) \
        & transcripts["cell_id"].notna()
    genes = set(transcripts["feature_name"][counted].unique())
    n_tx = int(transcripts["feature_name"].isin(genes).sum())
    want = config["slide"]["n_genes"]
    if (graph.n_genes != len(genes) or graph.n_tx != n_tx
            or graph.n_genes < PANEL_SHARE * want):
        raise SpecError(
            f"the graph keeps {graph.n_genes} genes and {graph.n_tx} "
            f"transcripts; the slide's nuclei hold {len(genes)} genes of "
            f"the configuration's {want}, with {n_tx} transcripts: the "
            f"panel is cut")


# -- the environment of one run ----------------------------------------------
class Env:
    """The slide, the program's pipeline and trainer, the benchmark's
    weights: everything set-up makes.

    A cell on several chips runs the program's tile data parallelism: a
    mesh of one shard a card (``SeggerTrainer(mesh=)``) over the first
    ``chips`` CUDA devices, or ``chips`` shards on ``device`` where one is
    given (the CPU in tests; one card in ``calibrate.py``), the model and
    its optimizer on the trainer's device, as the program places them."""

    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed = cell, seed
        self.traced = False
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.model_cfg = self.config["model"]
        self.port = port = _port()
        from generator import constant_density_extent, make_slide

        slide_cfg = dict(self.config["slide"])
        slide_cfg.setdefault("extent",
                             constant_density_extent(slide_cfg["n_cells"]))
        self.slide = make_slide(**slide_cfg, seed=seed)
        pcfg = port["pipeline"].PipelineConfig(**self.config["pipeline"],
                                                seed=seed % 2**32)
        self.pipe = port["pipeline"].ISTPipeline(
            self.slide.transcripts, self.slide.boundaries,
            self.slide.polygons, pcfg).load()
        self.graph = self.pipe.graph
        check_panel(self.slide.transcripts, self.graph, self.config)
        tcfg = port["trainer"].TrainConfig(**self.model_cfg,
                                           seed=seed % 2**31)
        chips = cell["workload"]["chips"]
        mesh = None
        if chips > 1:
            mesh = port["mesh"].make_mesh(
                chips, None if device is None else [device] * chips)
        self.trainer = port["trainer"].SeggerTrainer(
            self.graph, tcfg, device=device, mesh=mesh)
        self.device = self.trainer.device
        # every device the run uses: on a mesh its cards (the trainer's
        # among them), each once
        self.devices = (list(dict.fromkeys(mesh.devices)) if mesh
                        else [self.device])
        if self.trainer.in_channels != self.model_cfg["in_channels"]:
            raise SpecError(
                f"the gene embedding is {self.trainer.in_channels} wide, the "
                f"configuration states {self.model_cfg['in_channels']}")
        self.reference = load_module(
            ROOT / "references" / f"{self.config['reference']}.py")
        shapes = self.reference.param_shapes(
            self.model_cfg, self.graph.n_genes, self.graph.bd_x.shape[1])
        want = {k: tuple(v.shape)
                for k, v in self.trainer.model.state_dict().items()}
        if want != shapes:
            diff = sorted(k for k in set(want) | set(shapes)
                          if want.get(k) != shapes.get(k))
            raise SpecError("the reference's parameters differ from the "
                            "program's: " + ", ".join(
                                f"{k} {shapes.get(k)} != {want.get(k)}"
                                for k in diff))
        self.weights = self.reference.make_params(shapes, seed % 2**63,
                                                  self.device)
        self.trainer.init()
        self.trainer.model.load_state_dict(self.weights)
        self.gene_names = self.pipe.adata.var.index.to_numpy().astype(str)


# -- the fit traffic ---------------------------------------------------------
def fit_setup(env: Env, first_epoch_only: bool = False):
    """The set-up fit: a whole first ``fit`` of ``max_epochs``, recording
    the compared steps of its first epoch.  The epochs' shuffled packings
    give the batches more than one merged bucket shape, each a graph
    capture and a tile-cache entry of its own; the window's fit calls
    repeat those epochs, so after the first fit none captures or misses.
    ``first_epoch_only`` stops after the first epoch, for readings of the
    compared steps alone."""
    tr, traffic = env.trainer, env.traffic
    env.fit_tiles = env.port["partition"].make_fit_tiles(
        env.graph, env.pipe.tree, margin=env.pipe.cfg.tiling_margin_training)
    env.recorder = hooks.StepRecorder(tr, traffic["compare_steps"])
    def first(epoch, trainer):
        raise WindowClosed

    try:
        tr.fit(env.fit_tiles, max_epochs=env.model_cfg["max_epochs"],
               on_epoch_end=first if first_epoch_only else None)
    except WindowClosed:
        pass
    env.recorder.close()
    env.units_work = sum(s.tx_rows.size for s in env.fit_tiles)


def fit_window(env: Env, seconds: float, max_units: Optional[int] = None,
               sync: Callable[[], None] = lambda: None) -> dict:
    """Whole epochs from the window's start until ``seconds`` have passed
    (or ``max_units`` epochs): ``{"units", "seconds"}``."""
    tr, traffic = env.trainer, env.traffic
    st = {"units": 0, "last": None, "each": []}
    t0 = time.perf_counter()

    def hook(epoch, trainer):
        now = time.perf_counter()
        st["units"] += 1
        st["each"].append(now - (st["last"] or t0))
        st["last"] = now
        if max_units is not None and st["units"] >= max_units:
            raise WindowClosed
        if max_units is None and now - t0 >= seconds:
            raise WindowClosed

    while True:
        try:
            tr.fit(env.fit_tiles, max_epochs=env.model_cfg["max_epochs"],
                   on_epoch_end=hook)
        except WindowClosed:
            break
    sync()
    return {"units": st["units"], "seconds": st["last"] - t0,
            "each": st["each"]}


# -- the predict traffic -----------------------------------------------------
def predict_pass(env: Env) -> float:
    """One pass: the predict over every halo tile and the table written.
    Returns the write's seconds."""
    from torch.profiler import record_function

    preds = env.trainer.predict(env.predict_tiles)
    t = time.perf_counter()
    with (record_function("bench.write") if env.traced
          else contextlib.nullcontext()):
        env.port["writer"].SegmentationWriter(
            env.out_dir, save_anndata=False).write(
            preds, cell_ids=env.graph.bd_cell_id,
            gene_names=env.gene_names, transcripts=env.slide.transcripts)
    return time.perf_counter() - t


def predict_setup(env: Env):
    env.predict_tiles = env.port["partition"].make_predict_tiles(
        env.graph, env.pipe.tree,
        margin=env.pipe.cfg.tiling_margin_prediction)
    env.out_dir = env.cell["work"] / env.cell["workload"]["name"]
    for _ in range(env.traffic["warm_passes"]):
        predict_pass(env)
    env.units_work = env.graph.n_tx


def predict_window(env: Env, seconds: float, max_units: Optional[int] = None,
                   sync: Callable[[], None] = lambda: None) -> dict:
    t0 = time.perf_counter()
    units, write_s, each = 0, 0.0, []
    while True:
        write_s += predict_pass(env)
        units += 1
        now = time.perf_counter()
        each.append(now - (t0 + sum(each)))
        if (max_units is not None and units >= max_units) or (
                max_units is None and now - t0 >= seconds):
            break
    sync()
    return {"units": units, "seconds": now - t0, "write_s": write_s,
            "each": each}


KINDS = {"fit": (fit_setup, fit_window), "predict": (predict_setup,
                                                     predict_window)}


# -- one run -----------------------------------------------------------------
def traced_window(env: Env, units: int, sync) -> "object":
    """``units`` whole epochs or passes under the profiler, with the
    program's stage timer installed and its host work labelled, reduced
    to a :class:`tracing.TraceView`."""
    import counts

    port = env.port
    kind = env.traffic["kind"]
    window = KINDS[kind][1]
    timer = port["profiling"].StageTimer()
    # each batch the traced units built, once per table layout, with the
    # number of times it was built
    built: Dict[tuple, list] = {}

    def on_batch(plan, batch):
        key = (tuple(id(s) for s in plan[0]), batch.tt.idx.shape,
               batch.tt_n_lo, batch.tt_n_xlo, batch.tb.idx.shape)
        built.setdefault(key, [plan, batch, 0])[2] += 1

    before = launch_counts(port)
    prev = port["profiling"].set_substage_timer(timer)
    try:
        with hooks.labelled(env.trainer, on_batch):
            env.traced = True
            w, events = tracing.profile(
                lambda: window(env, 0.0, max_units=units, sync=sync),
                env.devices)
    finally:
        port["profiling"].set_substage_timer(prev)
        env.traced = False
    after = launch_counts(port)
    cards = env.cell["workload"]["chips"]
    red = tracing.reduce(events, cards)
    if not built or not red["steps"]:
        raise hooks.HookError(
            f"the traced {kind} units built {len(built)} batch layouts and "
            f"labelled {len(red['steps'])} steps: a hook on the trainer "
            f"did not fire")
    launches = {k: after[k] - before[k] for k in after}

    # the least time of every kernel launch and the model FLOPs of every
    # step in the traced units, from the tables of the batches they ran
    size = 2 if env.model_cfg["compute_dtype"] == "bfloat16" else 4
    model, f_bd = env.model_cfg, env.graph.bd_x.shape[1]
    train_ids = set()
    if kind == "fit":
        train_ids = {id(s) for s in
                     env.trainer.split_tiles(env.fit_tiles)[0]}
    least = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K5": 0.0}
    flops = 0.0
    for plan, batch, times in built.values():
        # a batch's tiles are all training or all validation tiles; the
        # tiles that round it up to ``tiles_per_step`` (no valid row, no
        # model FLOPs) launch the kernels all the same
        train = id(plan[0][0]) in train_ids
        for b in range(batch.tx_gene.shape[0]):
            t = tile_dict(batch, b)
            s = counts.tile_kernel_seconds(t, model, size)
            if kind == "predict":
                least["K1"] += times * s["fwd"]
                least["K5"] += times * s["score"]
                flops += times * counts.tiles_flops([t], model, f_bd, 1,
                                                    score=True)
            elif train:
                least["K2"] += times * s["fwd"]
                least["K3"] += times * s["bwd"]
                flops += times * counts.tiles_flops([t], model, f_bd, 3)
            else:
                least["K1"] += times * s["fwd"]
                flops += times * counts.tiles_flops([t], model, f_bd, 1)
    view = tracing.TraceView(
        kind=kind, units=w["units"], window_s=red["window_s"],
        busy_s=red["busy_s"], kernels=red["kernels"], steps=red["steps"],
        launches=launches, cards=cards,
        least_s=least, flops=flops,
        stages={k: (timer.seconds[k], timer.calls[k]) for k in timer.seconds},
        write_s=w.get("write_s", 0.0),
        rows_written=w["units"] * len(env.graph.tx_index)
        if kind == "predict" else 0)
    recs = {k: len(view._records(k)) for k in tracing.KERNELS}
    print(f"trace: {red['spins']} of {tracing.LEAD * cards} spin records "
          f"kept; "
          f"kernel records fwd {recs['fwd']} bwd {recs['bwd']} score "
          f"{recs['score']} against launches {launches}; busy s by card "
          + " ".join(f"{c}:{b:.4f}" for c, b in red["busy_by_card"].items())
          + f"; copies between cards {view.peer_copy_seconds():.4f} s",
          file=sys.stderr)
    return view, red["breakdown"]


def memory_peak(devices) -> int:
    """The fullest card's peak of allocated memory (0 on the CPU)."""
    import torch
    return max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t0: float, device=None) -> dict:
    """Run one cell once; returns the result line's object (``check``,
    the numbers compared with their limits, last)."""
    import torch
    import compare

    env = Env(cell, seed, device)
    kind = env.traffic["kind"]
    setup, window = KINDS[kind]
    sync = tracing.sync_fn(env.devices)
    setup(env)
    sync()
    setup_s = time.perf_counter() - t0
    g = env.graph
    tiles = getattr(env, "fit_tiles", None) or env.predict_tiles
    print(f"slide: {len(env.slide.transcripts)} transcripts, {g.n_tx} in "
          f"the graph, {g.n_bd} cells, {g.n_genes} genes, {g.tt_src.size} tt "
          f"edges, {len(tiles)} {kind} tiles", file=sys.stderr)
    cuda = env.device.type == "cuda"
    breakdown = None
    if trace:
        view, breakdown = traced_window(env, env.traffic["trace_units"],
                                        sync)
        units = view.units
        metrics = {}
        for m in cell["per_layer"]:
            v = m["reader"].read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        captures = dict(env.trainer.captures)
        w = window(env, seconds, sync=sync)
        units = w["units"]
        if env.trainer.captures != captures:
            print(f"window: graph captures {captures} -> "
                  f"{env.trainer.captures}", file=sys.stderr)
        print("window: seconds of each " + kind + " unit " + " ".join(
            f"{x:.4f}" for x in w["each"]), file=sys.stderr)
        values = {"setup_s": setup_s,
                  env.traffic["rate_metric"]:
                      env.units_work * w["units"] / w["seconds"]}
        metrics = {}
        for m in cell["end_to_end"]:
            if m["name"] not in values:
                raise SpecError(f"the {kind} traffic gives no "
                                f"{m['name']!r}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    memory = memory_peak(env.devices)
    env.trainer._drop_steps()
    if cuda:
        torch.cuda.empty_cache()
    readings = compare.CHECKS[kind](env)
    limits = env.traffic["limits"]
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(env.device) if cuda else "cpu",
        "count": cell["workload"]["chips"],
        "memory_peak_bytes": int(memory)}
    if trace:
        device_info.update(busy_s=view.busy_s, window_s=view.window_s)
    result = {"correct": compare.judge(readings, limits),
              "attempted": units, "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": readings.get(k, float("nan")),
                           "limit": lim} for k, lim in limits.items()}
    return result
