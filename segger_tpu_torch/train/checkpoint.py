"""Read checkpoints written by ``segger_tpu.train.checkpoint``.

A JAX checkpoint is an ``.npz`` of the flattened parameter tree
(``p_0 .. p_{n-1}``, in ``jax.tree_util`` leaf order) beside a ``.json``
of metadata.  The leaf order of a tree of nested dicts is sorted-key
order, so the port rebuilds it from its own module names
(``models/convert.py::flax_param_paths``).  Optimizer state is not read:
training waits for a later slice.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
from torch import nn

from ..models.convert import flax_param_paths, nest


def load_checkpoint(path, model: nn.Module) -> Tuple[dict, Dict]:
    """Read the ``.npz``/``.json`` pair at ``path`` into a flax-layout
    parameter tree for ``model`` (load it with
    ``SeggerTrainer.load_params``).  Returns ``(params, meta)``; raises if
    the leaf count or any shape disagrees with ``model``."""
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
    return nest(flat), meta
