"""Carry parameters from the JAX package into the port: the flax modules'
weights, the scene ``Model`` and the integrator ``SimState``; and the
port's ``Model`` back to numpy.

The caller turns the JAX tree into (nested) dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``, or a dataclass's fields); this
module never sees JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .sim.types import Model, SimState


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


def model_from_numpy(leaves: Dict[str, Any], dtype=torch.float64,
                     device="cpu"):
    """The port's ``Model`` from the leaves of the JAX package's ``Model``
    as numpy arrays (``{name: np.asarray(leaf)}``, e.g. from
    ``dataclasses.asdict`` or ``jax.tree``): the same parameters on both
    sides, edits included."""
    names = [f.name for f in dataclasses.fields(Model)]
    missing = set(names) - set(leaves)
    if missing:
        raise KeyError(f"missing Model leaves: {sorted(missing)}")
    return Model(**{k: torch.as_tensor(np.array(leaves[k], np.float64),
                                       dtype=dtype, device=device)
                    for k in names})


def model_to_numpy(model: Model) -> Dict[str, np.ndarray]:
    """``{name: numpy array}`` of every leaf of the port's ``Model`` (the
    inverse of ``model_from_numpy``; also takes a Model of cotangents)."""
    return {f.name: getattr(model, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(Model)}


def state_from_numpy(leaves: Dict[str, Any], dtype=torch.float64,
                     device="cpu"):
    """The port's ``SimState`` from the JAX ``SimState`` leaves as numpy
    arrays (q, qdot, q_prev, qdot_prev float; t an integer counter)."""
    f = lambda k: torch.as_tensor(np.array(leaves[k], np.float64),
                                  dtype=dtype, device=device)
    return SimState(q=f("q"), qdot=f("qdot"), q_prev=f("q_prev"),
                    qdot_prev=f("qdot_prev"),
                    t=torch.as_tensor(np.array(leaves["t"], np.int32),
                                      device=device))
