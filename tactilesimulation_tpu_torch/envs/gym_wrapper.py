"""Host-side stateful wrapper exposing the reference gym API.

Port of ``tactilesimulation_tpu/envs/gym_wrapper.py``: ``reset() -> obs``,
``step(u) -> (obs, reward, done, info)``, ``seed()``, ``render()`` and the
shape attributes over a ``FunctionalEnv``. Numpy in and out; the env's tensors
stay on its device in between.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tree import tree_map
from .base import FunctionalEnv


def _to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


class GymEnv:
    def __init__(self, env: FunctionalEnv, seed: int = 0):
        self.env = env
        self._state = None
        self.seed(seed)
        self.ndof_u = env.ndof_u
        self.action_shape = (env.ndof_u,)
        self.observation_shape = env.obs_size()
        self.max_episode_steps = env.max_episode_steps

    def seed(self, seed=0):
        """Seed the env's generator (every reset and step draws from it)."""
        self.env.generator.manual_seed(seed)
        return [seed]

    def reset(self):
        with torch.no_grad():
            self._state, obs = self.env.reset()
        self._t = 0
        self._traj = [self._state.sim.q.cpu().numpy()]
        return _to_numpy(obs)

    def step(self, u):
        u = torch.as_tensor(np.asarray(u), dtype=self.env.dtype,
                            device=self.env.device)
        with torch.no_grad():
            self._state, obs, reward, done, info = self.env.step(
                self._state, u)
        self._t += 1
        self._traj.append(self._state.sim.q.cpu().numpy())
        done = bool(done) or self._t >= self.max_episode_steps
        info = _to_numpy(info)
        if self._t >= self.max_episode_steps:
            info["TimeLimit.truncated"] = True
        return _to_numpy(obs), float(reward), done, info

    def render(self, mode="once", record_path="render.gif"):
        """Headless replay of the episode so far (modes once, loop and
        record). ``once`` and ``loop`` return the current frame as an RGB
        array; ``record`` writes the episode's trajectory to
        ``record_path`` (a GIF, or numbered PNGs where the path is a
        folder) and returns the frame count. Envs that randomise their
        model per episode are drawn with that episode's model
        (``_model_for``)."""
        from ..utils import renderer
        env = self.env
        if hasattr(env, "_model_for") and self._state is not None:
            model = env._model_for(self._state.extras)
        else:
            model = env.model
        if mode == "record" and len(getattr(self, "_traj", [])) > 1:
            return renderer.render_trajectory(
                env.struct, model, np.stack(self._traj), record_path)
        return renderer.frame_pixels(renderer.render_frame(
            env.struct, model, self._state.sim.q.cpu().numpy()))
