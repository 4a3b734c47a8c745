"""Carry parameters from the JAX package's flax modules into the port.

The caller turns the flax parameter tree into nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module never sees JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _dense(prefix: str, dense: Dict[str, Any], out: Dict[str, torch.Tensor]):
    # flax Dense.kernel is (in, out); torch Linear.weight is (out, in)
    out[f"{prefix}.weight"] = torch.as_tensor(np.array(dense["kernel"]).T)
    out[f"{prefix}.bias"] = torch.as_tensor(np.array(dense["bias"]))


def actor_params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of ``models.nets.DiagGaussianActor`` from the param tree of
    the flax ``DiagGaussianActor`` (with or without the top ``"params"``)."""
    p = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    mlp = p["MLP_0"]
    n_dense = sum(1 for k in mlp if k.startswith("Dense_"))
    for i in range(n_dense):
        _dense(f"mlp.layers.{i}", mlp[f"Dense_{i}"], out)
        if f"LayerNorm_{i}" in mlp:
            ln = mlp[f"LayerNorm_{i}"]
            out[f"mlp.norms.{i}.weight"] = torch.as_tensor(np.array(ln["scale"]))
            out[f"mlp.norms.{i}.bias"] = torch.as_tensor(np.array(ln["bias"]))
    _dense("mean", p["Dense_0"], out)
    out["logstd"] = torch.as_tensor(np.array(p["logstd"]))
    return out
