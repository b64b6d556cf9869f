"""Checkpoints in the layout of ``segger_tpu.train.checkpoint``.

A checkpoint is an ``.npz`` of the flattened parameter tree (``p_0 ..
p_{n-1}``, in ``jax.tree_util`` leaf order) and, optionally, of the
flattened optax Adam state (``o_0`` the step count, then the first
moments, then the second, each in leaf order over the updated
parameters), beside a ``.json`` of metadata.  The leaf order of a tree of
nested dicts is sorted-key order, so the port rebuilds it from its own
module names (``models/convert.py::flax_param_paths``).  The JAX package's
``load_checkpoint`` reads what :func:`save_checkpoint` writes, and the
port reads the JAX package's checkpoints.
"""
from __future__ import annotations

import json
from dataclasses import asdict, is_dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.convert import (
    adam_state_from_optax,
    adam_state_to_optax,
    flax_param_paths,
    nest,
    params_to_flax,
)


def _leaves(tree: dict) -> List[np.ndarray]:
    """Leaves of a nested dict in ``jax.tree_util`` order (sorted keys)."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def save_checkpoint(path, model: nn.Module,
                    optimizer: Optional[torch.optim.Adam] = None,
                    config=None, extra: Optional[Dict] = None) -> Path:
    """Write ``model``'s parameters (and ``optimizer``'s Adam state) as
    the ``.npz``/``.json`` pair at ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    p_leaves = _leaves(params_to_flax(model))
    arrays = {f"p_{i}": a for i, a in enumerate(p_leaves)}
    meta: Dict = {
        "has_opt_state": optimizer is not None,
        "params_treedef": "flax params: "
        + ", ".join("/".join(p) for p, _ in flax_param_paths(model)),
        "n_params": len(p_leaves),
    }
    if optimizer is not None:
        count, mu, nu = adam_state_to_optax(model, optimizer)
        o_leaves = [count] + _leaves(mu) + _leaves(nu)
        arrays.update({f"o_{i}": a for i, a in enumerate(o_leaves)})
        meta["opt_treedef"] = "optax ScaleByAdamState(count, mu, nu)"
        meta["n_opt"] = len(o_leaves)
    if config is not None:
        if is_dataclass(config):
            config = asdict(config)
        meta["config"] = {
            k: v for k, v in config.items()
            if isinstance(v, (int, float, str, bool, type(None)))
        }
    if extra:
        meta["extra"] = extra
    np.savez_compressed(path, **arrays)
    path.with_suffix(".json").write_text(json.dumps(meta, indent=2))
    return path


def load_checkpoint(path, model: nn.Module,
                    optimizer: Optional[torch.optim.Adam] = None
                    ) -> Tuple[dict, Dict]:
    """Read the ``.npz``/``.json`` pair at ``path`` into a flax-layout
    parameter tree for ``model`` (load it with
    ``SeggerTrainer.load_params``), and, given ``optimizer``, install the
    checkpoint's Adam state into it.  Returns ``(params, meta)``; raises
    if the leaf count or any shape disagrees with ``model``."""
    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    paths = flax_param_paths(model)
    if meta["n_params"] != len(paths):
        raise ValueError(
            f"checkpoint has {meta['n_params']} param leaves, the model "
            f"has {len(paths)}: config mismatch?"
        )
    with np.load(path.with_suffix(".npz")) as data:
        flat = {}
        for i, (p, shape) in enumerate(paths):
            a = data[f"p_{i}"]
            if a.shape != shape:
                raise ValueError(
                    f"checkpoint leaf p_{i} has shape {a.shape}, "
                    f"{'/'.join(p)} needs {shape}"
                )
            flat[p] = a
        if optimizer is not None:
            if not meta.get("has_opt_state"):
                raise ValueError("checkpoint holds no optimizer state")
            _load_adam(data, meta, model, optimizer, dict(paths))
    return nest(flat), meta


def _load_adam(data, meta, model, optimizer, shapes) -> None:
    """The ``o_*`` leaves into ``optimizer``: the updated parameters'
    flax paths, in leaf order, give the moments' order."""
    names = {id(p): n for n, p in model.named_parameters()}
    updated = set()
    for group in optimizer.param_groups:
        for p in group["params"]:
            *mods, leaf = names[id(p)].split(".")
            updated.add(("params", *mods,
                         "kernel" if leaf == "weight" else leaf))
    order = sorted(updated)
    if meta["n_opt"] != 1 + 2 * len(order):
        raise ValueError(
            f"checkpoint has {meta['n_opt']} optimizer leaves, the "
            f"optimizer needs {1 + 2 * len(order)}"
        )
    mu = {p: data[f"o_{1 + i}"] for i, p in enumerate(order)}
    nu = {p: data[f"o_{1 + len(order) + i}"] for i, p in enumerate(order)}
    for p in order:
        if mu[p].shape != shapes[p] or nu[p].shape != shapes[p]:
            raise ValueError(f"optimizer moments of {'/'.join(p)} have "
                             f"the wrong shape")
    adam_state_from_optax(model, optimizer, int(data["o_0"]), nest(mu),
                          nest(nu))
