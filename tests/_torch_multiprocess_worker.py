"""One rank of the port's multi-process whole-slide runs on the CPU, and
the launcher the tests start its ranks with.

    python tests/_torch_multiprocess_worker.py MODE RANK WORLD HOST:PORT DIR

Every rank joins a gloo group (``initialize_multihost``) with
``SHARDS_PER_RANK`` CPU shards, reads the slide's ``HostGraph`` from the
graph plane ``DIR/graph`` (and the weights from ``DIR/state.pt`` where the mode
loads them), and writes its results to ``DIR/rank<RANK>.pkl``:

- ``predict``: ``predict_whole_slide`` over every rank's shards as strips
  and as a 2x2 grid, then (rank 0) the same over one process's mesh of
  as many CPU shards, the group gone;
- ``train``: ``fit_whole_slide`` for ``EPOCHS`` from the seeded init as
  strips and as a 2x2 grid, with the parameters after each, then (rank 0)
  the same in one process;
- ``one-rank``: one rank, its rendezvous read from torchrun's variables,
  against no group;
- ``nccl-one-card``: two NCCL ranks naming ``cuda:0``, which must raise
  before any collective;
- ``checksum``: rank 1 changes one weight, and ``fit_whole_slide`` must
  raise.

Imports neither ``jax`` nor ``segger_tpu``: the tests compare what it
writes with the JAX package.
"""
from __future__ import annotations

import os
import pickle
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the rank launcher)

SHARDS_PER_RANK = 2
GRID = (2, 2)
EPOCHS = 2
# tests/_multihost_worker.py's encoder, in float32
CONFIG = dict(hidden_channels=8, out_channels=8, n_mid_layers=1, n_heads=2,
              compute_dtype="float32")
TIMEOUT = 120                     # seconds for every rank of a run


def start_ranks(mode: str, work_dir, world: int = 2) -> list:
    """Start ``world`` ranks of ``mode`` (``chip_smoke.start_ranks``),
    each logging to ``work_dir/rank<r>.log``: their ``(process, log
    path)`` pairs."""
    return chip_smoke.start_ranks(
        lambda r, addr: [str(Path(__file__).resolve()), mode, str(r),
                         str(world), addr, str(work_dir)], work_dir, world)


def wait_ranks(ranks: list, timeout: int = TIMEOUT) -> list:
    """Each rank's ``(returncode, log)`` (``chip_smoke.wait_ranks``):
    past ``timeout`` seconds, or a few seconds after one rank failed,
    every rank still running is killed and has a negative code."""
    return chip_smoke.wait_ranks(ranks, timeout)


def run_ranks(mode: str, work_dir, world: int = 2) -> list:
    """:func:`start_ranks`, then :func:`wait_ranks`."""
    return wait_ranks(start_ranks(mode, work_dir, world))


def results(work_dir, world: int = 2) -> list:
    """Every rank's results, by rank."""
    return [pickle.loads((Path(work_dir) / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _trainer(graph, state=None):
    from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

    tr = SeggerTrainer(graph, TrainConfig(**CONFIG), device="cpu")
    tr.init()
    if state is not None:
        tr.model.load_state_dict(state)
    return tr


def _fitted(tr, history) -> dict:
    """A fit's history, its flat parameters, and the root mean square of
    each parameter's gradients (Adam's ``sqrt(exp_avg_sq)``; 0 where it
    has no state)."""
    import torch

    from segger_tpu_torch.parallel.mesh import flat_parameters

    state = tr.optimizer.state
    rms = torch.cat([state[p]["exp_avg_sq"].sqrt().reshape(-1)
                     if p in state else torch.zeros(p.numel())
                     for p in tr.model.parameters()])
    return {"history": history, "params": flat_parameters(tr.model).numpy(),
            "grad_rms": rms.numpy()}


def _one_process_meshes(n: int) -> dict:
    from segger_tpu_torch.parallel.mesh import make_grid_mesh, make_mesh

    return {"strips": (make_mesh(devices=["cpu"] * n), None),
            "grid": (make_grid_mesh(*GRID, ["cpu"] * n), GRID)}


def main(argv) -> None:
    mode, rank, world, addr, work_dir = argv
    rank, world, work_dir = int(rank), int(world), Path(work_dir)
    import torch

    torch.set_num_threads(1)
    from segger_tpu_torch.parallel import mesh as pmesh

    cpus = ["cpu"] * SHARDS_PER_RANK
    if mode == "nccl-one-card":
        pmesh.initialize_multihost(addr, world, rank, backend="nccl",
                                   devices=["cuda:0"])
        raise AssertionError("two NCCL ranks on one card were let through")
    from segger_tpu_torch.data.assemble import load_host_graph_plane

    graph = load_host_graph_plane(work_dir / "graph", mmap=False)
    state_path = work_dir / "state.pt"
    state = torch.load(state_path) if state_path.exists() else None
    out = {}
    if mode == "one-rank":
        host, port = addr.split(":")
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK="0",
                          WORLD_SIZE="1", LOCAL_RANK="0")
        tr = _trainer(graph, state)
        out["no group"] = tr.predict_whole_slide(
            pmesh.make_mesh(devices=cpus))
        pmesh.initialize_multihost(devices=cpus)
        import torch.distributed as dist

        out["world"] = dist.get_world_size()
        out["owners"] = pmesh.make_mesh().owners
        out["group"] = tr.predict_whole_slide()
    else:
        pmesh.initialize_multihost(addr, world, rank, devices=cpus)
        if mode == "checksum":
            tr = _trainer(graph)
            if rank == 1:
                with torch.no_grad():
                    next(tr.model.parameters()).view(-1)[0] += 1e-3
            tr.fit_whole_slide(max_epochs=EPOCHS)
            raise AssertionError("differing parameters were let through")
        n = world * SHARDS_PER_RANK
        mesh = pmesh.make_mesh()
        out["mesh"] = {"owners": mesh.owners, "local": mesh.local,
                       "devices": [str(d) for d in mesh.devices]}
        refs = _one_process_meshes(n)
        if mode == "predict":
            tr = _trainer(graph, state)
            for name, (_, grid) in refs.items():
                out[name] = tr.predict_whole_slide(grid=grid)
        elif mode == "train":
            for name, (_, grid) in refs.items():
                tr = _trainer(graph)
                out[name] = _fitted(tr, tr.fit_whole_slide(
                    max_epochs=EPOCHS, grid=grid))
        else:
            raise ValueError(f"mode {mode!r}")
        pmesh.shutdown_multihost()
        if rank == 0:
            # one process over as many CPU shards: the reference
            for name, (ref_mesh, grid) in refs.items():
                if mode == "predict":
                    out[f"{name} one process"] = tr.predict_whole_slide(
                        ref_mesh, grid=grid)
                else:
                    tr = _trainer(graph)
                    out[f"{name} one process"] = _fitted(
                        tr, tr.fit_whole_slide(ref_mesh, max_epochs=EPOCHS,
                                               grid=grid))
    (work_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
