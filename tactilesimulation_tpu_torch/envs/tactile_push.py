"""TactilePush: pushing a box to a goal pose with a 13x10 tactile pad.

Port of the constants, observation layouts and scene set-up of
``tactilesimulation_tpu/envs/tactile_push.py`` (reference task
envs/tactile_push_env.py). The batched dynamics live in
``tactile_push_lanes.py``; the single-instance env core is not ported.

- obs types tactile_flatten / tactile_map / privilege / no_tactile
- reset: q[1] = -0.001, box y ~ U(-0.02, 0.02), goal xy ~
  U([0.15,-0.2],[0.25,0.2]), goal rot ~ U(y*pi +- pi/16)
- external disturbance resampled every 10 steps w.p. 0.5
- tanh action squash, frame_skip 5
- reward = pos + rot + touch + action terms
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..model import task_scenes

TACTILE_ROWS, TACTILE_COLS = 13, 10
OBS_TYPES = ("tactile_flatten", "tactile_map", "privilege", "no_tactile")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port's
    entry points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    return device


class TactilePushEnv:
    """Scene, model and task constants of TactilePush (no dynamics)."""
    max_episode_steps = 100
    frame_skip = 5
    action_dim = 3

    def __init__(self, struct_, model, observation_type: str = "tactile_flatten"):
        if observation_type not in OBS_TYPES:
            raise ValueError(f"observation_type {observation_type!r} not in "
                             f"{OBS_TYPES}")
        self.struct = struct_
        self.model = model
        self.observation_type = observation_type
        # the policy's action width (the gripper's 3 motors); the box's 3
        # motors carry the disturbance force
        self.ndof_u = self.action_dim
        # privilege/no_tactile never read the tactile field, so its query is
        # skipped (the markers still act on the dynamics inside the step)
        self._needs_tactile = observation_type in ("tactile_flatten",
                                                   "tactile_map")

    def obs_size(self) -> Tuple[int, ...]:
        if self.observation_type == "tactile_flatten":
            return (3 + TACTILE_ROWS * TACTILE_COLS * 3,)
        if self.observation_type == "tactile_map":
            return (3, TACTILE_ROWS, TACTILE_COLS)  # plus (3,) state vector
        if self.observation_type == "privilege":
            return (6,)
        return (3,)


def make(observation_type: str = "tactile_flatten", *, device="cuda",
         dtype=torch.float32) -> TactilePushEnv:
    """The bundled TactilePush scene with its model on ``device``."""
    device = resolve_device(device)
    struct_, model = task_scenes.tactile_push()
    return TactilePushEnv(struct_, model.to(device, dtype), observation_type)
