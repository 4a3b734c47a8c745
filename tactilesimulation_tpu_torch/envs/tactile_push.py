"""TactilePush: pushing a box to a goal pose with a 13x10 tactile pad.

Port of ``tactilesimulation_tpu/envs/tactile_push.py`` (reference task
envs/tactile_push_env.py): the single-instance env. The lane-major batched
twin is ``tactile_push_lanes.py`` (``lane_env()``).

- obs types tactile_flatten / tactile_map / privilege / no_tactile
- reset: q[1] = -0.001, box y ~ U(-0.02, 0.02), goal xy ~
  U([0.15,-0.2],[0.25,0.2]), goal rot ~ U(y*pi +- pi/16)
- external disturbance resampled every 10 steps w.p. 0.5
- tanh action squash, frame_skip 5
- reward = pos + rot + touch + action terms
- tactile force normalizers 3e-6 shear / 3e-3 normal

The observation's tactile field is read by the tactile read kernel
(``ops/tactile_query.tactile_field``: one launch on the card, its plain
version on the CPU) wherever no gradient can flow into the state or the
model, e.g. under ``torch.no_grad`` as in PPO's rollouts; the read has no
backward, so under BPTT the field comes from ``dynamics.tactile_field``,
which keeps its graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..model import task_scenes
from ..ops import tactile_query
from ..sim import dynamics, integrators, kinematics
from .base import EnvState, FunctionalEnv, load_scene, resolve_device

TACTILE_ROWS, TACTILE_COLS = 13, 10
OBS_TYPES = ("tactile_flatten", "tactile_map", "privilege", "no_tactile")


def draw(uniform, what: str, B: int):
    """All random draws of TactilePush for B instances, from
    ``uniform(shape, lo, hi)``, in the order both envs take them.

    "reset"       -> (box y (B,), goal (3, B) = [x, y, rot])
    "disturbance" -> (keep_zero (B,) bool, sampled force (2, B))
    """
    if what == "reset":
        box_y = uniform((B,), -0.02, 0.02)
        gx = uniform((B,), 0.15, 0.25)
        gy = uniform((B,), -0.2, 0.2)
        rot = gy * math.pi + uniform((B,), -math.pi / 16, math.pi / 16)
        return box_y, torch.stack([gx, gy, rot])
    if what == "disturbance":
        keep_zero = uniform((B,), 0.0, 1.0) >= 0.5
        return keep_zero, uniform((2, B), -1.0, 1.0)
    raise ValueError(what)


def observation(observation_type: str, q, tactile, goal):
    """The observation of one instance from q, the flat tactile field and
    the goal, in the gripper's local frame."""
    grip_rot = q[0]
    grip_pos = q[1:3]
    obj_pos = q[3:5]
    obj_rot = q[6]
    c, s = torch.cos(-grip_rot), torch.sin(-grip_rot)
    obj_local = torch.stack([c * obj_pos[0] - s * obj_pos[1],
                             s * obj_pos[0] + c * obj_pos[1]]) - grip_pos
    obj_rot_local = obj_rot - grip_rot
    goal_local = torch.stack([c * goal[0] - s * goal[1],
                              s * goal[0] + c * goal[1]]) - grip_pos
    goal_rot_local = goal[2] - grip_rot
    state3 = torch.cat([goal_local, goal_rot_local[None]])
    if observation_type == "privilege":
        return torch.cat([obj_local, obj_rot_local[None], state3])
    if observation_type == "no_tactile":
        return state3
    if observation_type == "tactile_flatten":
        return torch.cat([state3, tactile])
    # tactile_map: (3, rows, cols) image + (3,) state tuple
    img = tactile.reshape(TACTILE_ROWS, TACTILE_COLS, 3).permute(2, 0, 1)
    return img, state3


@dataclasses.dataclass(frozen=True)
class PushExtras:
    goal: torch.Tensor            # (3,) x, y, rot
    external_force: torch.Tensor  # (2,)
    tactile: torch.Tensor         # (rows*cols*3,) last captured field


class TactilePushEnv(FunctionalEnv):
    max_episode_steps = 100
    frame_skip = 5
    action_dim = 3

    def __init__(self, struct_, model,
                 observation_type: str = "tactile_flatten", seed: int = 0):
        if observation_type not in OBS_TYPES:
            raise ValueError(f"observation_type {observation_type!r} not in "
                             f"{OBS_TYPES}")
        super().__init__(struct_, model, seed)
        self.observation_type = observation_type
        self._step_sim = integrators.build_step(struct_)
        # privilege/no_tactile never read the tactile field, so its query is
        # skipped (the markers still act on the dynamics inside the step)
        self._needs_tactile = observation_type in ("tactile_flatten",
                                                   "tactile_map")

    # -- observation -------------------------------------------------------
    def obs_size(self) -> Tuple[int, ...]:
        if self.observation_type == "tactile_flatten":
            return (3 + TACTILE_ROWS * TACTILE_COLS * 3,)
        if self.observation_type == "tactile_map":
            return (3, TACTILE_ROWS, TACTILE_COLS)  # plus (3,) state vector
        if self.observation_type == "privilege":
            return (6,)
        return (3,)

    def _get_obs(self, q, tactile, goal):
        return observation(self.observation_type, q, tactile, goal)

    def _tactile(self, q, v):
        """(rows*cols*3,) sensor-frame field: the read kernel's query where
        no gradient can flow, the differentiable field otherwise."""
        if tactile_query.may_read(self.struct, self.model, q, v):
            field = tactile_query.tactile_field(self.struct, self.model, q, v)
        else:
            field = dynamics.tactile_field(self.struct, self.model, q, v)
        return field.reshape(-1)

    # -- randomness ---------------------------------------------------------
    def _draw(self, what: str, B: int):
        """The draws of ``TactilePushLanes._draw`` (same names, order and
        shapes); the single instance takes B = 1."""
        return draw(self._uniform, what, B)

    def step_noise(self, state):
        return self._draw("disturbance", 1)

    # -- api ---------------------------------------------------------------
    def reset(self):
        box_y, goal = self._draw("reset", 1)
        goal = goal[:, 0]
        q = self.model.q_init.clone()
        q[1] = -0.001
        q[4] = box_y[0]
        sim = integrators.initial_state(self.struct, self.model).replace(
            q=q, q_prev=q)
        if self._needs_tactile:
            tactile = self._tactile(q, torch.zeros_like(q))
        else:
            tactile = q.new_zeros(TACTILE_ROWS * TACTILE_COLS * 3)
        state = EnvState(
            sim=sim, t=torch.zeros((), dtype=torch.int32, device=self.device),
            extras=PushExtras(goal=goal, external_force=q.new_zeros(2),
                              tactile=tactile))
        return state, self._get_obs(q, tactile, goal)

    def step(self, state: EnvState, u, noise=None):
        ex = state.extras
        u = torch.as_tensor(u, dtype=self.dtype, device=self.device)
        action = torch.tanh(u)

        # disturbance force: resample every 10 steps, keep otherwise
        keep_zero, sampled = self.step_noise(state) if noise is None \
            else noise
        resample = (state.t % 10) == 0
        new_force = torch.where(keep_zero[0], torch.zeros_like(sampled[:, 0]),
                                sampled[:, 0])
        force = torch.where(resample, new_force, ex.external_force)
        robot_action = torch.cat([action, force, u.new_zeros(1)])

        sim = state.sim
        for _ in range(self.frame_skip):
            sim = self._step_sim(self.model, sim, robot_action)
        q = sim.q
        tactile = (self._tactile(q, sim.qdot) if self._needs_tactile
                   else ex.tactile)            # zeros carried (never read)
        var = kinematics.ee_positions(self.struct, self.model, q)
        obs = self._get_obs(q, tactile, ex.goal)

        obj_pos, obj_rot = q[3:5], q[6]
        goal = ex.goal
        reward_pos = -torch.sum(((obj_pos - goal[0:2]) / 0.01) ** 2) * 0.01
        reward_rot = -(((obj_rot - goal[2]) / (math.pi / 36.0)) ** 2) * 0.1
        reward_touch = -torch.sum((var[0:3] - var[3:6]) ** 2) / (0.02 ** 2)
        reward_action = -torch.sum(u ** 2) * 0.1
        reward = reward_pos + reward_rot + reward_touch + reward_action
        info = {
            "reward_pos": reward_pos,
            "reward_rot": reward_rot,
            "reward_touch": reward_touch,
            "reward_action": reward_action,
            "final_pos_error": torch.linalg.norm(obj_pos - goal[0:2]),
            "final_rot_error": torch.abs(obj_rot - goal[2]),
        }
        new_state = EnvState(
            sim=sim, t=state.t + 1,
            extras=PushExtras(goal=goal, external_force=force,
                              tactile=tactile))
        done = torch.zeros((), dtype=torch.bool, device=self.device)
        return new_state, obs, reward, done, info

    def lane_env(self):
        """Lane-major twin (``TactilePushLanes``) over this env's scene."""
        from .tactile_push_lanes import TactilePushLanes
        return TactilePushLanes(self.observation_type, env=self)

    def tactile_forces_array(self, tactile_flat):
        """(1, 1, rows, cols, 3) with the reference normalizers."""
        arr = tactile_flat.reshape(1, 1, TACTILE_ROWS, TACTILE_COLS, 3)
        return torch.cat([arr[..., 0:2] / 3e-6, arr[..., 2:3] / 3e-3],
                         dim=-1)


def make(observation_type: str = "tactile_flatten", *, device="cuda",
         dtype=torch.float32, seed: int = 0,
         scene_path: str = None) -> TactilePushEnv:
    """The bundled TactilePush scene, or the redmax XML file
    ``scene_path``, with its model on ``device`` (the card unless
    ``device='cpu'``)."""
    device = resolve_device(device)
    struct_, model = load_scene(scene_path, task_scenes.tactile_push)
    return TactilePushEnv(struct_, model.to(device, dtype), observation_type,
                          seed)
