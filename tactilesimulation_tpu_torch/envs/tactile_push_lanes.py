"""Lane-major (batch-last) batched TactilePush: the rollout hot path.

Port of ``tactilesimulation_tpu/envs/tactile_push_lanes.py``, with its
solver options (``rebuild_solver``): by default one chord factor per env
step (refresh 0), chord budget max(solver_max_iter + 2, 8), and the exact
IFT adjoint; ``solver_refresh=1, solver_bwd='exact'`` is the single
instance's step, lane by lane. ``rebuild_solver`` picks the stepper:

- the fused megastep (``ops/megastep.py``: K2 forward, K3 backward) at
  refresh 0 with the exact adjoint, when the model lives on a CUDA device
  and the scene passes ``megastep.supported``;
- otherwise the lanes stepper (``sim/lanes.build_env_step``) with the
  contact op K1 in every residual (``fused``).

The tactile observation runs K1 once per env step on either path, and its
pullback K1T.

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
from torch.utils.checkpoint import checkpoint

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
                 device="cuda", dtype=torch.float32, solver_refresh: int = 0,
                 solver_bwd: str = "exact", max_iter: int = 0, fused: bool = True,
                 seed: int = 0, env: tactile_push.TactilePushEnv = None):
        """``env``: the single-instance env whose scene to batch (its own
        device and dtype); a new bundled scene when None. The solver
        options are ``rebuild_solver``'s."""
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
        # one implicit step per lane (the per-step Newton solve), as the
        # JAX env keeps it beside the fused env step
        self._step_sim = lanes.build_step(self.struct)
        self.frame_skip = env.frame_skip
        self.ndof_u = env.ndof_u
        self.max_episode_steps = env.max_episode_steps
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.rebuild_solver(refresh=solver_refresh, bwd_mode=solver_bwd,
                            max_iter=max_iter, fused=fused)

    def rebuild_solver(self, *, refresh: int = 0, bwd_mode: str = "exact",
                       max_iter: int = 0, fused: bool = True, mega="auto"):
        """(Re)build the frame_skip-substep env step, by the JAX package's
        rules:

        - ``refresh``: the chord factor's schedule
          (``lanes.factor_substeps``); ``bwd_mode``: the chord adjoint
          (``lanes.chord_bwd``: exact, fwdfac, stale, refine<k>);
        - chord budget: max(solver_max_iter + 2, 8) at refresh 0 with
          ``max_iter`` 0 (the amortized chord), else ``max_iter`` or the
          scene's ``solver_max_iter``;
        - ``fused``: contact (and the tactile observation) through the
          pair-wrench op: K1 / K1T on a CUDA device, K1's plain twin on
          the CPU (the route the port's CPU tests hold to JAX; the JAX
          package's "auto" takes its kernel on its accelerator only);
          False takes the plain ``lanes.contact_terms`` and
          ``lanes.tactile_field``;
        - ``mega``: the fused megastep (K2/K3); "auto" takes it on a CUDA
          device at refresh 0 with the exact adjoint where
          ``megastep.supported``; any other option takes the lanes
          stepper."""
        if max_iter == 0 and refresh == 0:
            max_iter = max(self.struct.solver_max_iter + 2, 8)
        self.solver_refresh, self.solver_bwd = refresh, bwd_mode
        self.max_iter = max_iter or self.struct.solver_max_iter
        pw = (lane_contact.make_pair_wrenches(self.struct) if fused
              else (None, None))
        self._pw = pw if pw[0] is not None else None
        self.pair_wrenches = pw[0]
        if mega == "auto":
            mega = (self.device.type == "cuda" and refresh == 0
                    and bwd_mode == "exact"
                    and megastep.supported(self.struct, self.model))
        self.solver_mega = bool(mega)
        if self.solver_mega:
            self._multi_step = megastep.build_env_step_mega(
                self.struct, self.model, self.frame_skip,
                max_iter=self.max_iter)
            self.megastep = self._multi_step.op
        else:
            self._multi_step = lanes.build_env_step(
                self.struct, self.frame_skip, refresh=refresh,
                bwd_mode=bwd_mode, max_iter=self.max_iter,
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
        """(M*3, B) sensor-frame marker field, through K1 when ``fused``."""
        if self._pw is not None:
            tac = lanes.tactile_field_fused(self.struct, self.model, q, v,
                                            *self._pw)
        else:
            tac = lanes.tactile_field(self.struct, self.model, q, v)
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

    def step_noise(self, state: LanePushState):
        """The draws one step takes."""
        return self._draw("disturbance", state.sim.q.shape[1])

    def step(self, state: LanePushState, u, noise=None):
        """u: (B, ndof_u) batch-first (policy output layout); ``noise``:
        the step's draws (``step_noise``), drawn here when None."""
        model = self.model
        dtype = state.sim.q.dtype
        B = state.sim.q.shape[1]
        ul = u.to(dtype).T                                          # (3, B)
        action = torch.tanh(ul)

        # disturbance: resample every 10 steps w.p. 0.5, keep otherwise
        keep_zero, sampled = (self.step_noise(state) if noise is None
                              else noise)
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
                           remat: bool = False, with_obs: bool = False):
        """run(B) -> (rewards (B, H), dones (B, H), infos {k: (B, H)}
        [, obs (B, H, ...)]): B episodes as ONE lane-major rollout of
        ``horizon`` env steps with actions ``policy(obs)`` (batch-first obs
        -> (B, ndof_u)); ``obs`` holds the observation each action was taken
        on. The rewards carry the autograd graph back to whatever the policy
        differentiates (its parameters) unless grad mode is off.

        ``remat`` (the JAX package's ``jax.checkpoint`` of each step): on
        the lanes stepper each env step with its policy call is one
        non-reentrant checkpoint, rerun in the backward (its K1 and K1T
        forward launches twice). On the mega path ``remat`` changes
        nothing: K2 already keeps only (q, qdot, u, vs (K, n, B)) per env
        step for K3, so rerunning K2 in the backward would buy no memory
        worth its time; the env step's small host graph (observation,
        reward, policy) stays."""
        def body(state, obs, noise):
            return self.step(state, policy(obs), noise)

        if remat and not self.solver_mega and torch.is_grad_enabled():
            call = lambda *a: checkpoint(body, *a, use_reentrant=False,
                                         preserve_rng_state=False)
        else:
            call = body

        def run(B: int):
            outs = []
            state, obs = self.reset(B)
            for _ in range(horizon):
                # drawn outside the checkpoint: its rerun sees the same noise
                noise = self.step_noise(state)
                state, obs2, reward, done, info = call(state, obs, noise)
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
