"""Lane-major (batch-last) batched TactileInsertion: PPO-RNN's vec env.

Port of ``tactilesimulation_tpu/envs/tactile_insertion_lanes.py``. Every
env step runs a scripted 45-substep insertion; here B of them run as one
lane-major chord-solver rollout over (12, B) coordinates (``sim.lanes``):

- the contact parameters are per lane ((K, B) / (S, B) Model leaves, which
  ``contact.combined_params`` makes (K + S, 4, B)): domain randomisation
  draws them per episode;
- on the card the contact chain is the pair-wrench kernel K1 with per-lane
  parameters and the chord factor's pullbacks its adjoint K1T; on the CPU
  the plain lane contact (the JAX package's ``fused=False``);
- the chord factor is built before the script and again at every substep
  i with i % refresh == 0 (the JAX package's order: 1 + ceil(45 / refresh)
  factors, 10 at refresh 5), each from n = 12 reverse pullbacks of one
  residual graph; each substep runs the chord from r0 with
  ``solver_max_iter`` sweeps;
- the field is read only at the capture substeps (the JAX scan reads it at
  all 45 and keeps those): per script K1 launches
  (1 + ceil(45 / refresh)) + 45 (1 + max_iter) + (S + 1) times and K1T
  12 (1 + ceil(45 / refresh)) times;
- ``vec_step_autoreset`` runs the policy's step and a fresh reset for
  every lane as one 2B-lane execution; lanes whose episode ended take the
  reset side.

Everything that is not the script (action to q_cmd, reset sampling, the
outcome, the observation) is the single-instance env's own methods on
batch-first tensors. The draws come from the wrapped env's generator
(``env._draw``), in this order:

    vec_reset(B):           "reset" (B), "obs_noise" (B)
    vec_step_autoreset:     "reset" (B, the reset side), "obs_noise" (2B:
                            the step side's lanes, then the reset side's)

The JAX vec step merges its reset with ``where_last``, which reshapes the
mask to (1, B) and applies it to the batch-first key leaf, so it fails
for B != 2; here every leaf is merged along its own batch axis and any B
works. PPO needs no simulation gradient, so this path is forward only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import lane_contact
from ..sim import lanes
from .tactile_insertion import DR_NAMES, EXEC_STEPS, TactileInsertionEnv


@dataclasses.dataclass(frozen=True)
class LaneInsertionState:
    """Per-lane episode state, batch LAST."""
    current_q_init: torch.Tensor    # (12, B)
    original_q_init: torch.Tensor   # (12, B)
    prev_object_pose: torch.Tensor  # (3, B)
    pair_kn: torch.Tensor           # (K, B) the episodes' contact parameters
    pair_kt: torch.Tensor
    pair_mu: torch.Tensor
    pair_damping: torch.Tensor
    tac_kn: torch.Tensor            # (S, B)
    tac_kt: torch.Tensor
    tac_mu: torch.Tensor
    tac_damping: torch.Tensor
    grasp_force: torch.Tensor       # (B,)


def chord_tol(struct, dtype):
    """The chord's absolute stop tolerance in ``dtype``."""
    return max(struct.solver_tol, 1e-7 if dtype == torch.float32 else 1e-12)


def _pose(q_cmd):
    """(3, B) x, y, rot of a lane-major q (12, B)."""
    return torch.stack([q_cmd[0], q_cmd[1], q_cmd[3]])


class TactileInsertionLanes:
    """Batched TactileInsertion with lane-major physics.

    API (batch axis FIRST at the boundary):
        vec_reset(B)                            -> (state, obs (B, ...))
        vec_step_autoreset(state, obs, t, action (B, A))
            -> (state', obs', t', reward, done, bad, success)
    """

    def __init__(self, env: TactileInsertionEnv, *, refresh: int = 5,
                 max_iter: int = 0, fused="auto"):
        if env.struct.integrator.upper() != "BDF1":
            raise ValueError("the lanes stepper is BDF1 only")
        if refresh < 1:
            raise ValueError("refresh must be >= 1")
        self.env = env
        self.struct = env.struct
        self.model = env.model
        self.device, self.dtype = env.device, env.dtype
        self.refresh = refresh
        self.max_iter = max_iter or env.struct.solver_max_iter
        if fused == "auto":
            fused = self.device.type == "cuda"
        self._pw = None
        self.pair_wrenches = None
        if fused:
            pw, meta = lane_contact.make_pair_wrenches(self.struct)
            if pw is not None:
                self._pw = (pw, meta)
                self.pair_wrenches = pw
        self._residual = lanes.make_residual(self.struct, self._pw)

    # the policy-facing surface is the single-instance env's
    @property
    def ndof_u(self):
        return self.env.ndof_u

    @property
    def max_episode_steps(self):
        return self.env.max_episode_steps

    @property
    def generator(self):
        return self.env.generator

    def obs_size(self):
        return self.env.obs_size()

    def launches_per_script(self, n_frames=None):
        """(K1, K1T) launches of one ``_lane_execute`` on the card."""
        factors = 1 + -(-EXEC_STEPS // self.refresh)
        n_frames = n_frames or len(self.env.capture_frames)
        return (factors + EXEC_STEPS * (1 + self.max_iter) + n_frames,
                factors * self.struct.ndof_q)

    # ------------------------------------------------------------------
    def _batched_model(self, st):
        """The model with per-lane contact parameters ((K, B) / (S, B))."""
        get = st.get if isinstance(st, dict) else lambda k: getattr(st, k)
        return dataclasses.replace(self.model,
                                   **{k: get(k) for k in DR_NAMES})

    def _tactile(self, model, q, v):
        if self._pw is not None:
            return lanes.tactile_field_fused(self.struct, model, q, v,
                                             *self._pw)
        return lanes.tactile_field(self.struct, model, q, v)

    def _lane_execute(self, model, q_cmd, grasp_force, noise):
        """The batched 45-substep scripted insertion: q_cmd (12, B),
        grasp_force (B,), noise (B, ...) or None -> (final q (12, B), obs
        (B, ...) batch-first)."""
        env, struct = self.env, self.struct
        dtype = q_cmd.dtype
        B = q_cmd.shape[1]
        tol = chord_tol(struct, dtype)
        gamma = model.h.to(dtype).reshape(1, 1)
        us = env.script(q_cmd.T, grasp_force).transpose(1, 2)  # (45, 6, B)
        zeros = torch.zeros_like(q_cmd)
        state = lanes.LaneSimState(
            q=q_cmd, qdot=zeros, q_prev=q_cmd, qdot_prev=zeros,
            t=torch.zeros(B, dtype=torch.int32, device=q_cmd.device))

        def inputs_at(state, u):
            return lanes.StepInputs(
                model=model, u=u, q_base=state.q,
                p_base=lanes.momentum(struct, model, state.q, state.qdot),
                gamma=gamma)

        slots = {f: k for k, f in enumerate(env.capture_frames)}
        captured = [None] * len(slots)
        lu = lanes.make_chord_lu(self._residual, inputs_at(state, us[0]),
                                 state.qdot)
        for i in range(EXEC_STEPS):
            inputs = inputs_at(state, us[i])
            if i % self.refresh == 0:
                lu = lanes.make_chord_lu(self._residual, inputs, state.qdot)
            v = lanes._chord(self._residual, self.max_iter, tol, inputs,
                             state.qdot, lu)
            state = lanes.LaneSimState(q=state.q + gamma * v, qdot=v,
                                       q_prev=state.q, qdot_prev=state.qdot,
                                       t=state.t + 1)
            if i in slots:
                captured[slots[i]] = self._tactile(model, state.q,
                                                   state.qdot)
        cap = torch.stack(captured).permute(3, 0, 1, 2)   # (B, S+1, M, 3)
        return state.q, env._obs_from_captured(cap, noise)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def vec_reset(self, B: int) -> Tuple[LaneInsertionState, torch.Tensor]:
        env = self.env
        s = env._sample_reset(B)
        st = LaneInsertionState(
            current_q_init=s["q_cmd"].T, original_q_init=s["q_cmd"].T,
            prev_object_pose=_pose(s["q_cmd"].T),
            **{k: s[k].T for k in DR_NAMES}, grasp_force=s["grasp_force"])
        noise = env._draw("obs_noise", B)
        _, obs = self._lane_execute(self._batched_model(st),
                                    st.current_q_init, st.grasp_force, noise)
        return st, obs

    @torch.no_grad()
    def vec_step_autoreset(self, st: LaneInsertionState, obs, t, action):
        """One vec step: the policy's step for every lane and a fresh reset
        for every lane, both scripts in ONE 2B-lane execution; lanes whose
        episode ended (success, or t reaching max_episode_steps) go on from
        the reset side. t (B,) counts each lane's steps.

        -> (state', obs', t', reward, done, bad, success), each (B, ...):
        ``done`` = success | truncated, ``bad`` = truncated & ~success."""
        env = self.env
        B = st.current_q_init.shape[1]
        q_cmd_step = env._apply_action(st.current_q_init.T,
                                       st.original_q_init.T, action).T
        r = env._sample_reset(B)
        q_cmd_reset = r["q_cmd"].T
        noise = env._draw("obs_noise", 2 * B)

        cat = lambda a, b: torch.cat([a, b], dim=-1)
        dr_all = {k: cat(getattr(st, k), r[k].T) for k in DR_NAMES}
        final_q, obs_all = self._lane_execute(
            self._batched_model(dr_all), cat(q_cmd_step, q_cmd_reset),
            cat(st.grasp_force, r["grasp_force"]), noise)
        success, reward, pose, _ = env._outcome(
            final_q[:, :B].T, q_cmd_step.T, st.prev_object_pose.T)

        t = t + 1
        truncated = t >= self.max_episode_steps
        reset_now = success | truncated
        bad = truncated & ~success
        t = torch.where(reset_now, torch.zeros_like(t), t)

        stepped = dataclasses.replace(st, current_q_init=q_cmd_step,
                                      prev_object_pose=pose.T)
        resetted = LaneInsertionState(
            current_q_init=q_cmd_reset, original_q_init=q_cmd_reset,
            prev_object_pose=_pose(q_cmd_reset),
            **{k: r[k].T for k in DR_NAMES}, grasp_force=r["grasp_force"])
        # every leaf is batch-last
        new_state = LaneInsertionState(**{
            f.name: torch.where(reset_now, getattr(resetted, f.name),
                                getattr(stepped, f.name))
            for f in dataclasses.fields(LaneInsertionState)})
        keep = reset_now.reshape((B,) + (1,) * (obs.ndim - 1))
        new_obs = torch.where(keep, obs_all[B:], obs_all[:B])
        return new_state, new_obs, t, reward, reset_now, bad, success


def make(observation_type: str = "tactile_map", **kw) -> TactileInsertionLanes:
    """TactileInsertionLanes over ``tactile_insertion.make`` (the card unless
    ``device='cpu'`` is passed); ``refresh``, ``max_iter`` and ``fused`` go
    to the lane env, the rest to the single-instance env."""
    from . import tactile_insertion
    lane_kw = {k: kw.pop(k) for k in ("refresh", "max_iter", "fused")
               if k in kw}
    return TactileInsertionLanes(
        tactile_insertion.make(observation_type, **kw), **lane_kw)
