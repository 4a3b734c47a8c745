"""Policy and value networks: MLP, CNN, the diagonal-Gaussian actors, the
critics and the feed-forward actor-critic.

Port of ``tactilesimulation_tpu/models/nets.py`` (all but the recurrent
``ActorCriticRNN``), configured by the same YAML network sections
(layer_sizes / kernel_sizes / stride_sizes / hidden_size / activation /
layernorm / actor_logstd_init). flax infers input widths at ``init``;
here each module takes its observation's shape: ``(D,)`` for a vector,
``(C, H, W)`` for an image, ``((C, H, W), (S,))`` for the (image, state)
tuple of ``tactile_map``. Parameters carried over from the flax modules
with ``convert.py`` give the same outputs; fresh initialisation follows
PyTorch's defaults. Where JAX takes a PRNG key, the port takes a
``torch.Generator``.
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


class CNN(nn.Module):
    """Conv stack (VALID padding) + flatten + linear, input (..., C, H, W).
    The flatten takes (H, W, C) order, as flax's NHWC layout does, so the
    Linear's rows match the flax Dense's."""

    def __init__(self, in_shape, cfg: Dict[str, Any]):
        super().__init__()
        self.act = _ACT[cfg.get("activation", "elu")]
        c, h, w = in_shape
        convs = []
        for feat, k, s in zip(cfg["layer_sizes"], cfg["kernel_sizes"],
                              cfg["stride_sizes"]):
            convs.append(nn.Conv2d(c, feat, k, stride=s))
            c, h, w = feat, (h - k) // s + 1, (w - k) // s + 1
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(c * h * w, cfg["hidden_size"])
        self.out_dim = cfg["hidden_size"]

    def forward(self, x):
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        for conv in self.convs:
            x = self.act(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.act(self.dense(x)).reshape(lead + (-1,))


def _split(obs):
    """(image, state or None) of a CNN module's observation."""
    return obs if isinstance(obs, tuple) else (obs, None)


def _split_shape(obs_shape):
    """(image shape, state width) of a CNN module's observation shape."""
    if isinstance(obs_shape[0], (tuple, list)):
        return tuple(obs_shape[0]), int(obs_shape[1][0])
    return tuple(obs_shape), 0


class DiagGaussianDist:
    """Diagonal Gaussian action distribution."""

    def __init__(self, mean, logstd):
        self.mean = mean
        self.logstd = logstd.expand_as(mean)

    def mode(self):
        return self.mean

    def sample(self, generator=None):
        """One draw per entry of the mean: a batch of means (N, A) gets N
        independent noise vectors."""
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


def _logstd(action_dim, cfg):
    return nn.Parameter(torch.full(
        (action_dim,), float(cfg.get("actor_logstd_init", -1.0))))


class DiagGaussianActor(nn.Module):
    """MLP actor with a state-independent learned logstd."""

    def __init__(self, obs_dim: int, action_dim: int, cfg: Dict[str, Any]):
        super().__init__()
        self.mlp = MLP(obs_dim, cfg["actor_mlp"])
        self.mean = nn.Linear(self.mlp.out_dim, action_dim)
        self.logstd = _logstd(action_dim, cfg)

    def forward(self, obs) -> DiagGaussianDist:
        return DiagGaussianDist(self.mean(self.mlp(obs)), self.logstd)

    def act(self, obs, generator=None, deterministic=True):
        dist = self(obs)
        return dist.mode() if deterministic else dist.sample(generator)


class CNNActor(nn.Module):
    """CNN actor for image or (image, state) tuple observations; the state
    vector joins the CNN's features."""

    def __init__(self, obs_shape, action_dim: int, cfg: Dict[str, Any]):
        super().__init__()
        img_shape, state_dim = _split_shape(obs_shape)
        self.cnn = CNN(img_shape, cfg["actor_cnn"])
        self.mean = nn.Linear(self.cnn.out_dim + state_dim, action_dim)
        self.logstd = _logstd(action_dim, cfg)

    def forward(self, obs) -> DiagGaussianDist:
        img, state = _split(obs)
        feat = self.cnn(img)
        if state is not None:
            feat = torch.cat([feat, state], dim=-1)
        return DiagGaussianDist(self.mean(feat), self.logstd)

    def act(self, obs, generator=None, deterministic=True):
        dist = self(obs)
        return dist.mode() if deterministic else dist.sample(generator)


class MLPCritic(nn.Module):
    def __init__(self, obs_dim: int, cfg: Dict[str, Any]):
        super().__init__()
        self.mlp = MLP(obs_dim, cfg["critic_mlp"])
        self.value = nn.Linear(self.mlp.out_dim, 1)

    def forward(self, obs):
        return self.value(self.mlp(obs))


class CNNCritic(nn.Module):
    def __init__(self, obs_shape, cfg: Dict[str, Any]):
        super().__init__()
        img_shape, state_dim = _split_shape(obs_shape)
        self.cnn = CNN(img_shape, cfg["critic_cnn"])
        self.value = nn.Linear(self.cnn.out_dim + state_dim, 1)

    def forward(self, obs):
        img, state = _split(obs)
        feat = self.cnn(img)
        if state is not None:
            feat = torch.cat([feat, state], dim=-1)
        return self.value(feat)


class ActorCritic(nn.Module):
    """Feed-forward actor-critic pair. ``obs_shape`` as the module
    docstring says; the MLP modules take ``obs_shape[0]``."""

    def __init__(self, obs_shape, action_dim: int, cfg: Dict[str, Any],
                 actor_cls: str = "DiagGaussianActor",
                 critic_cls: str = "MLPCritic"):
        super().__init__()
        if actor_cls == "DiagGaussianActor":
            self.actor = DiagGaussianActor(obs_shape[0], action_dim, cfg)
        elif actor_cls == "CNNActor":
            self.actor = CNNActor(obs_shape, action_dim, cfg)
        else:
            raise KeyError(actor_cls)
        if critic_cls == "MLPCritic":
            self.critic = MLPCritic(obs_shape[0], cfg)
        elif critic_cls == "CNNCritic":
            self.critic = CNNCritic(obs_shape, cfg)
        else:
            raise KeyError(critic_cls)

    def forward(self, obs):
        return self.actor(obs), self.critic(obs)

    def act(self, obs, generator=None, deterministic=False):
        """(value, action, log-prob): a sample drawn from ``generator``,
        independently for each row of a batch, or the mode."""
        dist, value = self(obs)
        action = dist.mode() if deterministic else dist.sample(generator)
        return value, action, dist.log_prob(action)

    def get_value(self, obs):
        return self.critic(obs)

    def evaluate_actions(self, obs, actions):
        """(value, log-prob, entropy averaged over the batch)."""
        dist, value = self(obs)
        return value, dist.log_prob(actions), dist.entropy().mean()
