"""Pendulum swing-up: a minimal first-party functional env.

Port of ``tactilesimulation_tpu/envs/pendulum.py``: the cheap fixture the
trainers' tests run on, and the smallest example of an env on the
single-instance core.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..model import scenes
from ..sim import integrators
from .base import EnvState, FunctionalEnv, resolve_device


@dataclasses.dataclass(frozen=True)
class PendulumExtras:
    pass


class PendulumEnv(FunctionalEnv):
    max_episode_steps = 100
    action_dim = 1

    def __init__(self, struct_, model, torque_limit=4.0, seed: int = 0):
        super().__init__(struct_, model, seed)
        self.torque_limit = torque_limit
        self._step_sim = integrators.build_step(struct_)

    def obs_size(self):
        return (3,)

    def _obs(self, sim):
        th, w = sim.q[0], sim.qdot[0]
        return torch.stack([torch.cos(th), torch.sin(th), w])

    def _draw(self, what: str, B: int):
        """All random draws of the env. "reset" -> (angle (B,) ~ U(-pi, pi),
        angular velocity (B,) ~ U(-1, 1))."""
        if what == "reset":
            return (self._uniform((B,), -math.pi, math.pi),
                    self._uniform((B,), -1.0, 1.0))
        raise ValueError(what)

    def reset(self):
        q, w = self._draw("reset", 1)
        sim = integrators.initial_state(self.struct, self.model).replace(
            q=q, q_prev=q, qdot=w, qdot_prev=w)
        state = EnvState(sim=sim, t=torch.zeros((), dtype=torch.int32,
                                                device=self.device),
                         extras=PendulumExtras())
        return state, self._obs(sim)

    def step(self, state, u, noise=None):
        u = torch.as_tensor(u, dtype=self.dtype, device=self.device)
        tau = self.torque_limit * torch.tanh(u)
        sim = self._step_sim(self.model, state.sim, tau)
        # upright = angle pi; standard swing-up cost as reward
        angle_err = torch.remainder(sim.q[0] - math.pi + math.pi,
                                    2 * math.pi) - math.pi
        reward = -(angle_err ** 2 + 0.1 * sim.qdot[0] ** 2
                   + 0.001 * torch.sum(u ** 2))
        new_state = state.replace(sim=sim, t=state.t + 1)
        done = torch.zeros((), dtype=torch.bool, device=self.device)
        return (new_state, self._obs(sim), reward, done,
                {"angle_err": torch.abs(angle_err)})


def make(timestep=1e-2, damping=0.05, torque_limit=4.0, *, device="cuda",
         dtype=torch.float32, seed: int = 0, **_) -> PendulumEnv:
    """The pendulum env with its model on ``device`` (the card unless
    ``device='cpu'``)."""
    device = resolve_device(device)
    struct_, model = scenes.pendulum(timestep=timestep, damping=damping)
    return PendulumEnv(struct_, model.to(device, dtype), torque_limit, seed)
