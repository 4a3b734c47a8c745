"""Functional env API.

Port of ``tactilesimulation_tpu/envs/base.py``. An env binds one scene
(struct, model) and exposes

    env.reset()                       -> (EnvState, obs)
    env.step(state, action)           -> (EnvState, obs, reward, done, info)

over tensors of one instance. The JAX package carries a PRNG key in its
``EnvState``; here every draw comes from the env's ``torch.Generator``
(``env.generator``), outside the state, through the env's ``_draw``. A
step's draws are taken by ``step_noise(state)`` before the step itself, so
a step that is run again (``rollout_fn``'s remat) sees the same noise.

``rollout_fn`` differentiates through a whole episode (BPTT);
``batched_rollout_fn`` runs E episodes, one instance after another, with
batch-first outputs (JAX vmaps the single-instance env).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..sim.types import Model, SimState
from ..utils.tree import stack_rows, tree_stack


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port's
    entry points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    return device


def load_scene(scene_path, bundled: Callable):
    """(struct, model) of the redmax XML file ``scene_path`` (the model in
    float64 on the host, as the bundled scenes build), or ``bundled()``
    where no path is given."""
    if not scene_path:
        return bundled()
    from ..model import builder, xml_parser
    return builder.build(xml_parser.parse_scene(scene_path))


@dataclasses.dataclass(frozen=True)
class EnvState:
    sim: SimState
    t: torch.Tensor                # () int32 env-step counter
    extras: Any                    # env-specific tree (goal, disturbance, ...)

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


class FunctionalEnv:
    """Base: subclasses bind (struct, model) and implement reset/step."""

    #: gym-style metadata
    max_episode_steps: int = 1000

    def __init__(self, struct_, model: Model, seed: int = 0):
        self.struct = struct_
        self.model = model
        self.device = model.device
        self.dtype = model.dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    # subclasses implement:
    def reset(self):
        raise NotImplementedError

    def step(self, state: EnvState, action, noise=None):
        """``noise``: the step's draws (``step_noise``); drawn here when
        None."""
        raise NotImplementedError

    def step_noise(self, state: EnvState):
        """The draws one step takes (None for a deterministic step)."""
        return None

    # ---- conveniences ----------------------------------------------------
    @property
    def ndof_u(self) -> int:
        """Policy action dimension (may differ from the scene's motor count,
        e.g. TactilePush exposes 3 of 6 motor dofs; the rest carry the
        scripted disturbance force)."""
        return getattr(self, "action_dim", self.struct.ndof_u)

    def _uniform(self, shape, lo, hi):
        u = torch.rand(shape, generator=self.generator, device=self.device,
                       dtype=self.dtype)
        return lo + u * (hi - lo)

    def _episode(self, policy: Callable, horizon: int, remat: bool,
                 with_obs: bool):
        """One episode from a reset: per step (reward, done, info[, obs the
        action was taken on])."""
        def body(state, obs, noise):
            return self.step(state, policy(obs), noise)

        if remat and torch.is_grad_enabled():
            call = lambda *a: checkpoint(body, *a, use_reentrant=False,
                                         preserve_rng_state=False)
        else:
            call = body
        outs = []
        state, obs = self.reset()
        for _ in range(horizon):
            # drawn outside the checkpoint: its recompute sees the same noise
            noise = self.step_noise(state)
            state, obs2, reward, done, info = call(state, obs, noise)
            outs.append((reward, done, info) + ((obs,) if with_obs else ()))
            obs = obs2
        return outs

    def rollout_fn(self, policy: Callable, horizon: int, remat: bool = True):
        """run() -> (rewards (H,), dones (H,), infos {k: (H, ...)}): one
        episode with ``action = policy(obs)``. The rewards carry the graph
        back to whatever the policy reads (its parameters) under grad mode;
        ``remat`` recomputes each step in the backward (one non-reentrant
        checkpoint per step)."""

        def run():
            return stack_rows(self._episode(policy, horizon, remat, False))

        return run

    def lane_env(self) -> Optional[Any]:
        """A lane-major (batch-last) twin of this env, or None."""
        return None

    def batched_rollout_fn(self, policy: Callable, horizon: int,
                           remat: bool = False, with_obs: bool = False):
        """run(E) -> (rewards (E, H), dones (E, H), infos {k: (E, H, ...)}
        [, obs (E, H, ...)]): E episodes, one instance after another, each
        from its own reset; ``obs`` holds the observation each action was
        taken on. The JAX package's contract (batch-first at this
        boundary)."""

        def run(E: int):
            episodes = [stack_rows(self._episode(policy, horizon, remat,
                                                   with_obs))
                        for _ in range(E)]
            return tuple(tree_stack(x) for x in zip(*episodes))

        return run

