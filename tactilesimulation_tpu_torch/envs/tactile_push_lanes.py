"""Lane-major (batch-last) batched TactilePush: the rollout hot path.

Port of ``tactilesimulation_tpu/envs/tactile_push_lanes.py``: one chord
factor per env step (refresh 0), chord budget max(solver_max_iter + 2, 8),
and the exact IFT adjoint. ``rebuild_solver(mega="auto")`` picks the
stepper:

- the fused megastep (``ops/megastep.py``: K2 forward, K3 backward) when
  the model lives on a CUDA device and the scene passes
  ``megastep.supported``;
- otherwise the lanes stepper (``sim/lanes.build_env_step``) with the
  contact op K1 in every residual: per env step K1 runs 1 (Jacobian
  build) + frame_skip x (1 + max_iter) (chord) times, 46 on TactilePush.

The tactile observation runs K1 once per env step on either path (47 per
env step on the lanes stepper), and its backward is K1's plain twin.

Rollouts keep the autograd graph: a loss on the rewards differentiates to
the policy's parameters (BPTT). Randomness comes from a ``torch.Generator``;
every draw goes through ``TactilePushLanes._draw`` so tests can hand in
other draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from ..ops import lane_contact, megastep
from ..sim import lanes
from . import tactile_push
from .tactile_push import TACTILE_COLS, TACTILE_ROWS


@dataclasses.dataclass
class LanePushState:
    sim: lanes.LaneSimState          # (n, B) leaves
    t: torch.Tensor                  # (B,) int32
    goal: torch.Tensor               # (3, B)
    external_force: torch.Tensor     # (2, B)
    tactile: torch.Tensor            # (M*3, B) last captured field (or zeros)


class TactilePushLanes:
    """Batched TactilePush with lane-major physics.

    API (batch axis FIRST at the boundary, lane-major inside):
        reset(B)                  -> (LanePushState, obs (B, ...))
        step(state, u (B, 3))     -> (state', obs, reward (B,), done, info)
    """

    def __init__(self, observation_type: str = "tactile_flatten", *,
                 device="cuda", dtype=torch.float32, max_iter: int = 0,
                 seed: int = 0, env: tactile_push.TactilePushEnv = None):
        """``env``: the single-instance env whose scene to batch (its own
        device and dtype); a new bundled scene when None."""
        if env is None:
            env = tactile_push.make(observation_type, device=device,
                                    dtype=dtype)
        self.env = env
        self.struct = env.struct
        self.model = env.model
        self.device = env.model.device
        self.dtype = env.dtype
        self.observation_type = observation_type
        self._needs_tactile = env._needs_tactile
        self.frame_skip = env.frame_skip
        self.ndof_u = env.ndof_u
        self.max_episode_steps = env.max_episode_steps
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        pw, meta = lane_contact.make_pair_wrenches(self.struct)
        self._pw = (pw, meta)
        self.pair_wrenches = pw
        self.rebuild_solver(max_iter=max_iter)

    def rebuild_solver(self, max_iter: int = 0, mega="auto"):
        """(Re)build the frame_skip-substep env step (the JAX package's
        ``rebuild_solver`` at refresh 0, bwd_mode 'exact'): the fused
        megastep (K2/K3) when ``mega`` is true, or "auto" and the model is on
        a CUDA device and the scene is ``megastep.supported``; the lanes
        stepper with K1 otherwise. ``max_iter`` 0 keeps the amortized chord
        budget max(solver_max_iter + 2, 8)."""
        self.max_iter = max_iter or max(self.struct.solver_max_iter + 2, 8)
        if mega == "auto":
            mega = (self.device.type == "cuda"
                    and megastep.supported(self.struct, self.model))
        self.solver_mega = bool(mega)
        if self.solver_mega:
            self._multi_step = megastep.build_env_step_mega(
                self.struct, self.model, self.frame_skip,
                max_iter=self.max_iter)
            self.megastep = self._multi_step.op
        else:
            self._multi_step = lanes.build_env_step(
                self.struct, self.frame_skip, max_iter=self.max_iter,
                fused_pw=self._pw)
            self.megastep = None

    def obs_size(self):
        return self.env.obs_size()

    # -- randomness ---------------------------------------------------------
    def _uniform(self, shape, lo, hi):
        u = torch.rand(shape, generator=self.generator, device=self.device,
                       dtype=self.dtype)
        return lo + u * (hi - lo)

    def _draw(self, what: str, B: int):
        """All random draws of the env (``tactile_push.draw``).

        "reset"       -> (box y (B,), goal (3, B) = [x, y, rot])
        "disturbance" -> (keep_zero (B,) bool, sampled force (2, B))
        """
        return tactile_push.draw(self._uniform, what, B)

    # -- api ----------------------------------------------------------------
    def tactile(self, q, v):
        """(M*3, B) sensor-frame marker field through K1."""
        tac = lanes.tactile_field_fused(self.struct, self.model, q, v,
                                        *self._pw)
        return tac.reshape(-1, q.shape[1])

    def reset(self, B: int) -> Tuple[LanePushState, torch.Tensor]:
        box_y, goal = self._draw("reset", B)
        q = self.model.q_init[:, None].repeat(1, B)
        q[1] = -0.001
        q[4] = box_y
        zeros = torch.zeros_like(q)
        sim = lanes.LaneSimState(q=q, qdot=zeros, q_prev=q, qdot_prev=zeros,
                                 t=torch.zeros(B, dtype=torch.int32,
                                               device=self.device))
        if self._needs_tactile:
            tactile = self.tactile(q, zeros)
        else:
            tactile = q.new_zeros((TACTILE_ROWS * TACTILE_COLS * 3, B))
        state = LanePushState(sim=sim, t=sim.t, goal=goal,
                              external_force=q.new_zeros((2, B)),
                              tactile=tactile)
        return state, self._get_obs(q, tactile, goal)

    def _get_obs(self, q, tactile, goal):
        """Lane-major observation; returns batch-first (B, ...) for policies."""
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
        state3 = torch.cat([goal_local, goal_rot_local[None]])      # (3, B)
        if self.observation_type == "privilege":
            return torch.cat([obj_local, obj_rot_local[None], state3]).T
        if self.observation_type == "no_tactile":
            return state3.T
        if self.observation_type == "tactile_flatten":
            return torch.cat([state3, tactile]).T
        B = q.shape[1]
        img = tactile.reshape(TACTILE_ROWS, TACTILE_COLS, 3, B)
        return img.permute(3, 2, 0, 1), state3.T

    def step(self, state: LanePushState, u):
        """u: (B, ndof_u) batch-first (policy output layout)."""
        model = self.model
        dtype = state.sim.q.dtype
        B = state.sim.q.shape[1]
        ul = u.to(dtype).T                                          # (3, B)
        action = torch.tanh(ul)

        # disturbance: resample every 10 steps w.p. 0.5, keep otherwise
        keep_zero, sampled = self._draw("disturbance", B)
        resample = (state.t % 10) == 0                              # (B,)
        new_force = torch.where(keep_zero[None], torch.zeros_like(sampled),
                                sampled)
        force = torch.where(resample[None], new_force, state.external_force)
        robot_action = torch.cat([action, force, ul.new_zeros((1, B))])

        sim_state = self._multi_step(model, state.sim, robot_action)
        q = sim_state.q
        tactile = (self.tactile(q, sim_state.qdot) if self._needs_tactile
                   else state.tactile)
        var = lanes.ee_positions(self.struct, model, q)             # (6, B)
        obs = self._get_obs(q, tactile, state.goal)

        obj_pos, obj_rot = q[3:5], q[6]
        goal = state.goal
        reward_pos = -torch.sum(((obj_pos - goal[0:2]) / 0.01) ** 2,
                                dim=0) * 0.01
        reward_rot = -(((obj_rot - goal[2]) / (math.pi / 36.0)) ** 2) * 0.1
        reward_touch = -torch.sum((var[0:3] - var[3:6]) ** 2,
                                  dim=0) / (0.02 ** 2)
        reward_action = -torch.sum(ul ** 2, dim=0) * 0.1
        reward = reward_pos + reward_rot + reward_touch + reward_action
        info = {
            "reward_pos": reward_pos,
            "reward_rot": reward_rot,
            "reward_touch": reward_touch,
            "reward_action": reward_action,
            "final_pos_error": torch.sqrt(
                torch.sum((obj_pos - goal[0:2]) ** 2, dim=0)),
            "final_rot_error": torch.abs(obj_rot - goal[2]),
        }
        new_state = LanePushState(sim=sim_state, t=state.t + 1, goal=goal,
                                  external_force=force, tactile=tactile)
        done = torch.zeros(B, dtype=torch.bool, device=q.device)
        return new_state, obs, reward, done, info

    def batched_rollout_fn(self, policy: Callable, horizon: int,
                           with_obs: bool = False):
        """run(B) -> (rewards (B, H), dones (B, H), infos {k: (B, H)}
        [, obs (B, H, ...)]): B episodes as ONE lane-major rollout of
        ``horizon`` env steps with actions ``policy(obs)`` (batch-first obs
        -> (B, ndof_u)); ``obs`` holds the observation each action was taken
        on. The rewards carry the autograd graph back to whatever the policy
        differentiates (its parameters) unless grad mode is off; on the
        mega path each env step keeps only (q, qdot, u, vs (K, n, B)) for
        its backward."""

        def run(B: int):
            outs = []
            state, obs = self.reset(B)
            for _ in range(horizon):
                state, obs2, reward, done, info = self.step(state,
                                                            policy(obs))
                outs.append((reward, done, info, obs))
                obs = obs2
            stack = lambda xs: torch.stack(list(xs), dim=1)
            rewards, dones, infos, seen = zip(*outs)
            info = {k: stack(i[k] for i in infos) for k in infos[0]}
            return ((stack(rewards), stack(dones), info)
                    + ((stack(seen),) if with_obs else ()))

        return run


def make(observation_type: str = "tactile_flatten", **kw) -> TactilePushLanes:
    """TactilePushLanes on the card unless ``device='cpu'`` is passed."""
    return TactilePushLanes(observation_type, **kw)
