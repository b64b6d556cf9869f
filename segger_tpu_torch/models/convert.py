"""Weights and Adam-state interchange between the flax parameter tree
of ``segger_tpu.models.ISTEncoder`` (with optax's Adam state) and this
package's ``ISTEncoder`` (with ``torch.optim.Adam``).

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
    'params' collection) -> ``state_dict`` of the port's ``ISTEncoder``
    (or of any module named as the flax tree: a ``GATv2Conv`` with
    ``share_weights=True`` has no ``lin_r`` in either)."""
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


def _flax_array(name: str, t: torch.Tensor) -> Tuple[Tuple[str, ...],
                                                      np.ndarray]:
    """A state-dict entry as ``(flax path, array)``: a Linear weight
    (out, in) becomes the flax kernel (in, out)."""
    *mods, leaf = name.split(".")
    a = t.detach().float().cpu().numpy()
    if leaf == "weight":
        leaf, a = "kernel", np.ascontiguousarray(a.T)
    return ("params", *mods, leaf), a


def params_to_flax(model: nn.Module) -> dict:
    """The inverse of :func:`params_from_flax`: the model's parameters as
    a flax-layout nested dict of float32 arrays (with the top-level
    'params' collection)."""
    return nest(dict(_flax_array(n, t)
                     for n, t in model.state_dict().items()))


def adam_state_to_optax(model: nn.Module,
                        optimizer: torch.optim.Adam) -> tuple:
    """A ``torch.optim.Adam``'s state in optax's ``ScaleByAdamState``
    layout: ``(count int32, mu, nu)``, ``mu``/``nu`` flax-layout nested
    dicts over the parameters the optimizer updates (a frozen parameter
    is left out, as ``optax.masked`` leaves it out).  A parameter with no
    state yet has zero moments."""
    names = {id(p): n for n, p in model.named_parameters()}
    mu, nu, count = {}, {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if st:
                count = int(st["step"])
            m = st.get("exp_avg", torch.zeros_like(p))
            v = st.get("exp_avg_sq", torch.zeros_like(p))
            path, a = _flax_array(names[id(p)], m)
            mu[path] = a
            nu[path] = _flax_array(names[id(p)], v)[1]
    return np.asarray(count, np.int32), nest(mu), nest(nu)


def adam_state_from_optax(model: nn.Module, optimizer: torch.optim.Adam,
                          count, mu: Mapping, nu: Mapping) -> None:
    """Install optax-layout Adam moments (see :func:`adam_state_to_optax`)
    into ``optimizer``, which must update the same parameters.  The step
    count lies on the CPU, or on the parameter's device where the group
    is ``capturable`` or ``fused`` (whose steps read it there)."""
    mu_sd, nu_sd = params_from_flax(mu), params_from_flax(nu)
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            n = names[id(p)]
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=p.device if on_device
                                     else None),
                "exp_avg": mu_sd[n].to(p.device).reshape(p.shape).clone(),
                "exp_avg_sq": nu_sd[n].to(p.device).reshape(p.shape).clone(),
            }
