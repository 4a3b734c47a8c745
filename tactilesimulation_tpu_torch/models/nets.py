"""Policy networks: MLP, diagonal-Gaussian distribution and actor.

Port of the parts of ``tactilesimulation_tpu/models/nets.py`` that the GD
trainer's actor uses (``DiagGaussianActor`` with an ``actor_mlp``
section: layer_sizes / activation / layernorm / actor_logstd_init).
Parameters carried over from the flax modules with ``convert.py`` give the
same outputs; fresh initialisation follows PyTorch's defaults.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

_ACT = {"tanh": torch.tanh, "relu": torch.relu,
        "elu": nn.functional.elu, "identity": lambda x: x}


class MLP(nn.Module):
    """Linear -> activation [-> LayerNorm] per entry of ``layer_sizes``."""

    def __init__(self, in_dim: int, cfg: Dict[str, Any]):
        super().__init__()
        self.act = _ACT[cfg.get("activation", "elu")]
        sizes = [in_dim] + list(cfg["layer_sizes"])
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(sizes[:-1], sizes[1:]))
        # flax LayerNorm default epsilon
        self.norms = (nn.ModuleList(nn.LayerNorm(b, eps=1e-6)
                                    for b in sizes[1:])
                      if cfg.get("layernorm", False) else None)
        self.out_dim = sizes[-1]

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = self.act(layer(x))
            if self.norms is not None:
                x = self.norms[i](x)
        return x


class DiagGaussianDist:
    """Diagonal Gaussian action distribution."""

    def __init__(self, mean, logstd):
        self.mean = mean
        self.logstd = logstd.expand_as(mean)

    def mode(self):
        return self.mean

    def sample(self, generator=None):
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + torch.exp(self.logstd) * noise

    def log_prob(self, actions):
        std = torch.exp(self.logstd)
        lp = (-0.5 * ((actions - self.mean) / std) ** 2
              - self.logstd - 0.5 * math.log(2.0 * math.pi))
        return torch.sum(lp, dim=-1, keepdim=True)

    def entropy(self):
        return torch.sum(self.logstd + 0.5 * math.log(2.0 * math.pi * math.e),
                         dim=-1)


class DiagGaussianActor(nn.Module):
    """MLP actor with a state-independent learned logstd."""

    def __init__(self, obs_dim: int, action_dim: int, cfg: Dict[str, Any]):
        super().__init__()
        self.mlp = MLP(obs_dim, cfg["actor_mlp"])
        self.mean = nn.Linear(self.mlp.out_dim, action_dim)
        self.logstd = nn.Parameter(torch.full(
            (action_dim,), float(cfg.get("actor_logstd_init", -1.0))))

    def forward(self, obs) -> DiagGaussianDist:
        return DiagGaussianDist(self.mean(self.mlp(obs)), self.logstd)

    def act(self, obs, generator=None, deterministic=True):
        dist = self(obs)
        return dist.mode() if deterministic else dist.sample(generator)
