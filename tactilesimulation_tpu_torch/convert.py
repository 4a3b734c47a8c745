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


def _mlp(prefix: str, mlp: Dict[str, Any], out: Dict[str, torch.Tensor]):
    n_dense = sum(1 for k in mlp if k.startswith("Dense_"))
    for i in range(n_dense):
        _dense(f"{prefix}.layers.{i}", mlp[f"Dense_{i}"], out)
        if f"LayerNorm_{i}" in mlp:
            ln = mlp[f"LayerNorm_{i}"]
            out[f"{prefix}.norms.{i}.weight"] = torch.as_tensor(
                np.array(ln["scale"]))
            out[f"{prefix}.norms.{i}.bias"] = torch.as_tensor(
                np.array(ln["bias"]))


def _cnn(prefix: str, cnn: Dict[str, Any], out: Dict[str, torch.Tensor]):
    n_conv = sum(1 for k in cnn if k.startswith("Conv_"))
    for i in range(n_conv):
        conv = cnn[f"Conv_{i}"]
        # flax Conv.kernel is HWIO; torch Conv2d.weight is OIHW
        out[f"{prefix}.convs.{i}.weight"] = torch.as_tensor(
            np.array(conv["kernel"]).transpose(3, 2, 0, 1).copy())
        out[f"{prefix}.convs.{i}.bias"] = torch.as_tensor(
            np.array(conv["bias"]))
    # the port's CNN flattens in flax's (H, W, C) order: the Dense's rows
    # carry over as they are
    _dense(f"{prefix}.dense", cnn["Dense_0"], out)


def _actor(prefix: str, p: Dict[str, Any], out: Dict[str, torch.Tensor]):
    if "CNN_0" in p:
        _cnn(f"{prefix}cnn", p["CNN_0"], out)
    else:
        _mlp(f"{prefix}mlp", p["MLP_0"], out)
    _dense(f"{prefix}mean", p["Dense_0"], out)
    out[f"{prefix}logstd"] = torch.as_tensor(np.array(p["logstd"]))


def actor_params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of ``models.nets.DiagGaussianActor`` (or ``CNNActor``)
    from the param tree of the flax module (with or without the top
    ``"params"``)."""
    out: Dict[str, torch.Tensor] = {}
    _actor("", tree.get("params", tree), out)
    return out


def actor_critic_params_from_numpy(tree: Dict[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """State dict of ``models.nets.ActorCritic`` from the param tree of the
    flax ``ActorCritic`` (MLP or CNN actor and critic)."""
    p = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    _actor("actor.", p["actor"], out)
    critic = p["critic"]
    if "CNN_0" in critic:
        _cnn("critic.cnn", critic["CNN_0"], out)
    else:
        _mlp("critic.mlp", critic["MLP_0"], out)
    _dense("critic.value", critic["Dense_0"], out)
    return out


def actor_critic_rnn_params_from_numpy(tree: Dict[str, Any]
                                       ) -> Dict[str, torch.Tensor]:
    """State dict of ``models.nets.ActorCriticRNN`` from the param tree of
    the flax ``ActorCriticRNN`` (CNN or MLP features, ``gru{i}`` cells)."""
    p = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    feat = p["feature_net"]
    if "Conv_0" in feat:
        _cnn("feature_net", feat, out)
    else:
        _mlp("feature_net", feat, out)
    i = 0
    while f"gru{i}" in p:
        cell = p[f"gru{i}"]
        for name in ("ir", "iz", "in", "hr", "hz", "hn"):
            dst = f"cells.{i}.{'in_' if name == 'in' else name}"
            out[f"{dst}.weight"] = torch.as_tensor(
                np.array(cell[name]["kernel"]).T)
            if "bias" in cell[name]:
                out[f"{dst}.bias"] = torch.as_tensor(
                    np.array(cell[name]["bias"]))
        i += 1
    _actor("actor.", p["actor"], out)
    _mlp("critic.mlp", p["critic"]["MLP_0"], out)
    _dense("critic.value", p["critic"]["Dense_0"], out)
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
