"""Weights interchange between the flax parameter tree of
``segger_tpu.models.ISTEncoder`` and this package's ``ISTEncoder``.

Module names match the flax tree, so a flax path maps to a state-dict
key by joining with dots; a flax ``Dense.kernel`` (in, out) becomes a
torch ``Linear.weight`` (out, in).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (flax layout, with or without the top-level
    'params' collection) -> ``state_dict`` of the port's ``ISTEncoder``."""
    tree = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str):
        for key, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{key}.")
            elif key == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(
                    np.ascontiguousarray(np.asarray(v, np.float32).T))
            else:
                out[f"{prefix}{key}"] = torch.from_numpy(
                    np.array(v, np.float32))

    walk(tree, "")
    return out


def flax_param_paths(model: nn.Module) -> List[Tuple[Tuple[str, ...],
                                                      Tuple[int, ...]]]:
    """Every parameter of ``model`` as ``(flax path, flax shape)``,
    ``"params"`` first, in ``jax.tree_util`` leaf order (sorted keys at
    every level of the nested dicts)."""
    paths = []
    for name, p in model.state_dict().items():
        *mods, leaf = name.split(".")
        shape = tuple(p.shape)
        if leaf == "weight":  # nn.Linear: flax kernel is (in, out)
            leaf, shape = "kernel", shape[::-1]
        paths.append((("params", *mods, leaf), shape))
    return sorted(paths)


def nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> dict:
    """{path tuple: array} -> nested dict."""
    out: dict = {}
    for path, a in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return out
