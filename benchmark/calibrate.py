"""Readings for the limits of ``correct``: for one cell and a list of
seeds, in one process, the program's sound readings, the control's (the
reference in float8 in the program's place; its thresholds in float32)
and the planted faults (in the reference put in the program's place):
for a training cell half of each tile's rows left out (and, on batches
of several tiles, half of the tiles, and the exchange of gradients
between the cards left out), for a predict cell the wrong thresholds of
``references/segger.py::gene_thresholds``.  Not run by the benchmark's
own runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--device cuda:0] [--out readings.jsonl]
    python3 benchmark/calibrate.py --workload <cell> --seeds <n> --table

``--device`` puts a cell of several chips on one device, its mesh's
shards all there: the same steps and arithmetic on one card.  Each
seed's line: ``{"seed", "program", "control"[, "half", "half_tiles",
"no_exchange", "loss_gaps"][, "thr_faults"]}``, ``loss_gaps`` each
compared step's loss gap of each side.  ``--table`` reads only the thresholds, of the table
that the cell's last run (of that seed) wrote, with the slide made again
from the seed and no set-up of the program.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

# the benchmark runs' threads (run.py), set before numpy and torch load
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None) -> int:
    import torch

    import compare
    import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    cell = harness.cell_spec(args.workload)
    kind = cell["traffic"]["kind"]
    setup, window = harness.KINDS[kind]
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.table:
            line = {"seed": seed, "workload": args.workload,
                    **threshold_lines(table_env(cell, seed))}
            line["seconds"] = time.perf_counter() - t0
            emit(line, args.out)
            continue
        env = harness.Env(cell, seed, args.device)
        if kind == "fit":
            setup(env, first_epoch_only=True)
        else:
            setup(env)
        if kind == "predict":
            window(env, 0.0, max_units=1)
        env.trainer._drop_steps()
        if env.device.type == "cuda":
            torch.cuda.empty_cache()
        line = {"seed": seed, "workload": args.workload,
                "program": compare.CHECKS[kind](env),
                "control": compare.CHECKS[kind](env, control=True)}
        if kind == "fit":
            ref = compare.reference_fit(env, "f32")
            half = compare.reference_fit(env, "f32", half=True)
            line["half"] = compare.fit_readings(half, ref)
            line["loss_gaps"] = {
                "program": compare.loss_gaps(compare.program_fit(env), ref),
                "control": compare.loss_gaps(
                    compare.reference_fit(env, "fp8"), ref),
                "half": compare.loss_gaps(half, ref)}
            if env.recorder.steps[0]["batch"].tx_gene.shape[0] > 1:
                for key, fault in (("half_tiles", {"half_tiles": True}),
                                   ("no_exchange", {"exchange": False})):
                    side = compare.reference_fit(env, "f32", **fault)
                    line[key] = compare.fit_readings(side, ref)
                    line["loss_gaps"][key] = compare.loss_gaps(side, ref)
        else:
            line["thr_faults"] = threshold_lines(env)["thr_faults"]
        line["seconds"] = time.perf_counter() - t0
        emit(line, args.out)
        del env
    return 0


def threshold_lines(env) -> dict:
    """thr_gap of the written table, of the thresholds in float32, and of
    each planted wrong threshold."""
    import numpy as np

    import compare

    table = compare.read_table(env)
    return {"program": {"thr_gap": compare.threshold_gap(env, table)},
            "control": {"thr_gap": compare.threshold_gap(
                env, table, compare.thresholds_of(env, table, np.float32))},
            "thr_faults": {f: compare.threshold_gap(
                env, table, compare.thresholds_of(env, table, fault=f))
                for f in ("yen", "sample", "median")}}


def table_env(cell: dict, seed: int):
    """What the threshold readings need of a run: the slide made again
    from the seed, the reference, and where the cell's run wrote."""
    from types import SimpleNamespace

    import numpy as np

    import harness
    from generator import constant_density_extent, make_slide

    slide_cfg = dict(cell["config"]["slide"])
    slide_cfg.setdefault("extent",
                         constant_density_extent(slide_cfg["n_cells"]))
    return SimpleNamespace(
        slide=make_slide(**slide_cfg, seed=seed),
        reference=harness.load_module(
            harness.ROOT / "references"
            / f"{cell['config']['reference']}.py"),
        out_dir=cell["work"] / cell["workload"]["name"],
        graph=SimpleNamespace(bd_cell_id=np.array([], str)))


def emit(line: dict, out) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    sys.exit(main())
