"""Carry the reference's parameters into the port.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``, done by the caller: this
module never sees jax) and returns the port's parameters: the same names,
with the [L, ...] leaves of the decoder's ``layers`` unstacked into a list
of per-layer dicts, and the [G, E, ...] leaves of the hybrid's ``mamba``
into a list of ``G * E`` per-layer dicts (layer ``g * E + e``);
``shared_attn`` carries across as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _to_torch(a, device, dtype) -> torch.Tensor:
    # bf16 numpy arrays (ml_dtypes) have no torch counterpart: go through a
    # writable f32 copy, which holds every bf16 value exactly
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda",
                    dtype=torch.float32) -> dict:
    hybrid = cfg.family == "hybrid"
    stacked_key = "mamba" if hybrid else "layers"
    known = {"embed", stacked_key, "final_norm"} | ({"shared_attn"} if hybrid else set())
    unknown = set(tree) - known
    if unknown:
        raise NotImplementedError(f"{cfg.name}: params {sorted(unknown)} are not ported")
    lead = 2 if hybrid else 1          # [G, E, ...] or [L, ...] leaves
    stacked = _map(tree[stacked_key], lambda a: np.reshape(a, (-1, *np.shape(a)[lead:])))
    n = len(_first_leaf(stacked))
    if n != cfg.n_layers:
        raise ValueError(f"params hold {n} layers, config {cfg.name} has {cfg.n_layers}")
    conv = lambda a: _to_torch(a, device, dtype)  # noqa: E731
    out = {"embed": _map(tree["embed"], conv),
           stacked_key: [_map(stacked, lambda a, i=i: conv(a[i])) for i in range(n)],
           "final_norm": _map(tree["final_norm"], conv)}
    if hybrid:
        out["shared_attn"] = _map(tree["shared_attn"], conv)
    return out
