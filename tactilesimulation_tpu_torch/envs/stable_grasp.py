"""StableGrasp: grasp-position bandit with randomized per-block density.

Port of ``tactilesimulation_tpu/envs/stable_grasp.py`` (reference task
envs/stable_grasp_env.py): an 11-block bar whose density distribution (its
COM uniform along its length) is drawn per episode must be grasped at a
stable point; each env step runs a scripted grasp (move / close / lift /
lower / open, ``STAGE_STEPS`` substeps) and returns the shear of the
tactile field captured mid-lift. Success = the bar stays level.

- the start pose: a 500-substep settle of the bar on its tables
  (``settle``); the bundled scene's result ships in
  ``data/stable_grasp_q_init.json`` for its float64 and float32 models, any
  other model settles once and is cached on disk (``start_pose``);
- per-episode densities: the draws ("reset": com_y, mid density, right
  total, left total, 11 ratios) and their transform ``densities`` (torque
  balance about the mid block, total clipped to [3000, 7000]), applied as
  ``body_mass`` / ``body_inertia`` leaves of the episode's Model;
- the script: 7 linear joint-target ramps from the current pose with
  ``q[1]`` at the grasp position, the field captured after substep index
  ``CAPTURE_FRAME`` (the 61st substep) and read only there (the JAX scan
  reads every substep and keeps that one);
- observation: the capture's shear, normalised to max length 30;
- action: grasp position += clip(a) * 0.05, bounded to +-0.11; success
  |rotvec| < 0.02 and lift > 0.005; reward +100 or -10 * angle.

The capture reads the field through ``tactile_query.may_read``'s rule: the
read kernel K4R where no gradient can flow, the differentiable
``dynamics.tactile_field`` otherwise. The read does not pack the masses, so
an episode's Model shares the read plan of the bundled one.

``STAGE_STEPS`` and ``CAPTURE_FRAME`` are read when the script runs, so a
shorter schedule can be set on the module.

    python -m tactilesimulation_tpu_torch.envs.stable_grasp

rewrites ``data/stable_grasp_q_init.json`` (two settles on the CPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

from ..model import task_scenes
from ..ops import tactile_query
from ..sim import dynamics, integrators
from . import start_pose
from .base import EnvState, FunctionalEnv, load_scene, resolve_device

TACTILE_ROWS, TACTILE_COLS = 13, 10
NUM_BLOCKS = 11
# physical left-to-right block order -> body name suffix (reference :75)
BOX_IDS = [9, 8, 1, 2, 3, 4, 5, 6, 7, 10, 11]
CAPTURE_FRAME = 60
STAGE_STEPS = [20, 10, 50, 20, 50, 10, 20]  # 180 substeps (reference :220)
SETTLE_STEPS = 500
Q_INIT_FILE = os.path.join(start_pose.DATA_DIR, "stable_grasp_q_init.json")
OBS_TYPES = ("tactile_flatten", "tactile_map")


@dataclasses.dataclass(frozen=True)
class GraspExtras:
    current_q: torch.Tensor       # (12,) persistent bar+gripper state
    grasp_position: torch.Tensor  # ()
    body_mass: torch.Tensor       # (NB,) the episode's masses (Model leaf)
    body_inertia: torch.Tensor    # (NB, 3)
    obs: torch.Tensor
    is_success: torch.Tensor      # () bool
    cap_q: torch.Tensor           # (12,) the state at the capture
    cap_qdot: torch.Tensor
    cap_field: torch.Tensor       # (Mtot, 3) the field read there


def settle(struct, model, step_sim=None, steps=SETTLE_STEPS):
    """The bar on its tables under the open gripper: the start pose q (12,)
    of every episode (reference :166-187)."""
    step_sim = step_sim or integrators.build_step(struct)
    q = model.q_init.clone()
    q[2] = 0.2
    q[4] = q[5] = -0.03
    u = torch.cat([q[0:2], q[2:3] + 0.003, q[3:6]])
    state = integrators.initial_state(struct, model).replace(q=q, q_prev=q)
    with torch.no_grad():
        for _ in range(steps):
            state = step_sim(model, state, u)
    return state.q


def initial_pose(struct, model, step_sim=None):
    """The settled start pose of ``model``: from the shipped file, else
    from the disk cache, else settled now (and cached)."""
    return start_pose.load_or_settle(
        Q_INIT_FILE, "stable_grasp_qinit", model,
        lambda: settle(struct, model, step_sim))


def write_q_init_file(path=Q_INIT_FILE):
    """Settle the bundled scene's float64 and float32 models on the CPU
    and write their start poses to ``path``."""
    struct, model = task_scenes.stable_grasp()
    return start_pose.write_file(path, model, lambda m: settle(struct, m))


def densities(d):
    """The 11 block densities (..., 11), physical order, from the "reset"
    draws (reference :71-128): the blocks left of the COM block share
    ``left`` in proportion to their ratios, those right of it ``right``, the
    COM block takes ``mid``; the totals balance the torque about the COM
    block and the sum is clipped to [3000, 7000]."""
    com_y = d["com_y"]
    num_left = torch.floor(com_y)
    mid_left_ratio = com_y - num_left
    mid = d["mid"]
    right_total, left_total = d["right"], d["left"]
    lean_right = mid_left_ratio < 0.5
    left_total = torch.where(
        lean_right, right_total + (1.0 - 2.0 * mid_left_ratio) * mid,
        left_total)
    right_total = torch.where(
        lean_right, right_total,
        left_total + (2.0 * mid_left_ratio - 1.0) * mid)

    idx = torch.arange(NUM_BLOCKS, dtype=com_y.dtype, device=com_y.device)
    ratios = d["ratios"] + 0.1
    nl = num_left[..., None]
    zero = torch.zeros_like(ratios)
    left_r = torch.where(idx < nl, ratios, zero)
    right_r = torch.where(idx > nl, ratios, zero)
    norm = lambda r: torch.clamp(torch.sum(r, dim=-1, keepdim=True),
                                 min=1e-9)
    dens = (left_r / norm(left_r) * left_total[..., None]
            + right_r / norm(right_r) * right_total[..., None])
    dens = torch.where(idx == nl, mid[..., None], dens)
    total = torch.sum(dens, dim=-1, keepdim=True)
    return dens / total * torch.clamp(total, 3000.0, 7000.0)


class StableGraspEnv(FunctionalEnv):
    max_episode_steps = 10
    action_dim = 1
    action_scale = 0.05
    grasp_position_bound = 0.11

    def __init__(self, struct_, model, observation_type: str = "tactile_map",
                 seed: int = 0):
        if observation_type not in OBS_TYPES:
            raise ValueError(f"observation_type {observation_type!r} not in "
                             f"{OBS_TYPES}")
        super().__init__(struct_, model, seed)
        self.observation_type = observation_type
        self._step_sim = integrators.build_step(struct_)
        self._box_bodies = torch.tensor(
            [struct_.body_index(f"box_{i}") for i in BOX_IDS],
            device=self.device)
        mass = model.body_mass[self._box_bodies]
        self._box_volume = mass / 600.0
        self._box_unit_inertia = (model.body_inertia[self._box_bodies]
                                  / mass[:, None])
        self.q_init_ref = initial_pose(struct_, model, self._step_sim)

    # -- per-episode densities ----------------------------------------------
    def _draw(self, what: str, B: int):
        """The env's draws for B instances, from its generator, in JAX's
        order: "reset" -> {"com_y", "mid", "right", "left": (B,), "ratios":
        (B, 11) U(0, 1)}; the totals' bounds follow com_y."""
        if what != "reset":
            raise ValueError(what)
        u = self._uniform
        com_y = u((B,), 1.0, NUM_BLOCKS - 1.0)
        num_left = torch.floor(com_y)
        num_right = NUM_BLOCKS - 1 - num_left
        mid = u((B,), 600.0, 700.0)
        right = u((B,), 600.0 * num_right, 700.0 * num_right)
        left = u((B,), 600.0 * num_left, 700.0 * num_left)
        ratios = u((B, NUM_BLOCKS), 0.0, 1.0)
        return {"com_y": com_y, "mid": mid, "right": right, "left": left,
                "ratios": ratios}

    def _sample_densities(self):
        """One episode's densities (11,): the "reset" draws through
        ``densities``."""
        return densities(self._draw("reset", 1))[0]

    def _variation(self, dens):
        """The episode's (body_mass, body_inertia) from densities (11,)."""
        mass = dens * self._box_volume
        bm = self.model.body_mass.clone()
        bm[self._box_bodies] = mass
        bi = self.model.body_inertia.clone()
        bi[self._box_bodies] = mass[:, None] * self._box_unit_inertia
        return bm, bi

    def _model_for(self, ex: GraspExtras):
        return dataclasses.replace(self.model, body_mass=ex.body_mass,
                                   body_inertia=ex.body_inertia)

    # -- the scripted grasp (reference :197-282) ----------------------------
    def _field(self, model, q, v):
        if tactile_query.may_read(self.struct, model, q, v):
            return tactile_query.tactile_field(self.struct, model, q, v)
        return dynamics.tactile_field(self.struct, model, q, v)

    def script(self, q0, grasp_position):
        """The controls (T, 6) of the grasp from q0 (``q0[1]`` already at
        the grasp position): ``STAGE_STEPS`` linear ramps through 8
        waypoints."""
        dtype, dev = q0.dtype, q0.device
        lift_height = 0.2029862 + 0.03
        grasp_height = 0.2029862
        fing = -0.008
        zero = torch.zeros((), dtype=dtype, device=dev)
        const = lambda x: torch.full((), x, dtype=dtype, device=dev)

        def tq(z, fl, fr):
            return torch.stack([zero, grasp_position, const(z), zero,
                                fl if torch.is_tensor(fl) else const(fl),
                                fr if torch.is_tensor(fr) else const(fr)])

        targets = [q0[:6],
                   tq(grasp_height, fing, fing),
                   tq(grasp_height, fing, fing),
                   tq(lift_height, fing, fing),
                   tq(lift_height, fing, fing),
                   tq(grasp_height, fing, fing),
                   tq(grasp_height, fing, fing),
                   tq(grasp_height, q0[4], q0[5])]
        actions = []
        for stage, n in enumerate(STAGE_STEPS):
            frac = (torch.arange(1, n + 1, dtype=dtype, device=dev)
                    / n)[:, None]
            actions.append(targets[stage][None]
                           + frac * (targets[stage + 1] - targets[stage])[None])
        return torch.cat(actions)

    def _grasp(self, model, current_q, grasp_position):
        """One scripted grasp -> (final q, captured field (Mtot, 3), q and
        qdot at the capture). The capture is the state after substep index
        ``CAPTURE_FRAME``; a schedule that ends first captures nothing
        (zeros at q0, as the JAX scan's carry)."""
        q0 = current_q.clone()
        q0[1] = grasp_position
        actions = self.script(q0, grasp_position)
        state = integrators.initial_state(self.struct, model).replace(
            q=q0, q_prev=q0)
        ntac = len(self.struct.tac_joint)
        cap_field = q0.new_zeros((ntac, 3))
        cap_q, cap_qdot = q0, torch.zeros_like(q0)
        for t in range(actions.shape[0]):
            state = self._step_sim(model, state, actions[t])
            if t == CAPTURE_FRAME:
                cap_q, cap_qdot = state.q, state.qdot
                cap_field = self._field(model, cap_q, cap_qdot)
        return state.q, cap_field, cap_q, cap_qdot

    def _obs_from_tactile(self, cap_tac):
        """Shear only, normalised to max length 30 (reference :248-259,
        :289-297)."""
        shear = cap_tac.reshape(1, 2, TACTILE_ROWS, TACTILE_COLS, 3)[..., 0:2]
        max_len = torch.amax(torch.linalg.norm(shear, dim=-1)) + 1e-5
        shear = shear / (max_len / 30.0)
        if self.observation_type == "tactile_flatten":
            return shear.reshape(-1)
        return shear.permute(0, 1, 4, 2, 3).reshape(
            -1, TACTILE_ROWS, TACTILE_COLS)              # (4, 13, 10)

    def obs_size(self) -> Tuple[int, ...]:
        if self.observation_type == "tactile_flatten":
            return (TACTILE_ROWS * TACTILE_COLS * 2 * 2,)
        return (4, TACTILE_ROWS, TACTILE_COLS)

    @staticmethod
    def _outcome(cap_q):
        angle = torch.linalg.norm(cap_q[9:12])
        success = (angle < 0.02) & (cap_q[8] > 0.005)
        reward = torch.where(success, torch.full_like(angle, 100.0),
                             -angle * 10.0)
        return success, reward

    def _run(self, ex: GraspExtras, grasp_position):
        model = self._model_for(ex)
        final_q, cap_field, cap_q, cap_qdot = self._grasp(
            model, ex.current_q, grasp_position)
        obs = self._obs_from_tactile(cap_field)
        ex = dataclasses.replace(ex, current_q=final_q,
                                 grasp_position=grasp_position, obs=obs,
                                 cap_q=cap_q, cap_qdot=cap_qdot,
                                 cap_field=cap_field)
        return model, ex, obs

    # -- api ---------------------------------------------------------------
    def reset(self):
        bm, bi = self._variation(self._sample_densities())
        q = self.q_init_ref
        ex = GraspExtras(
            current_q=q, grasp_position=q.new_zeros(()), body_mass=bm,
            body_inertia=bi, obs=q.new_zeros(self.obs_size()),
            is_success=torch.zeros((), dtype=torch.bool, device=self.device),
            cap_q=q, cap_qdot=torch.zeros_like(q),
            cap_field=q.new_zeros((len(self.struct.tac_joint), 3)))
        model, ex, obs = self._run(ex, ex.grasp_position)
        state = EnvState(sim=integrators.initial_state(self.struct, model),
                         t=torch.zeros((), dtype=torch.int32,
                                       device=self.device),
                         extras=ex)
        return state, obs

    def step(self, state: EnvState, u, noise=None):
        ex = state.extras
        u = torch.as_tensor(u, dtype=self.dtype, device=self.device)
        action = torch.clamp(u.reshape(-1), -1.0, 1.0)
        gp = torch.clamp(ex.grasp_position + action[0] * self.action_scale,
                         -self.grasp_position_bound, self.grasp_position_bound)
        _, ex, obs = self._run(ex, gp)
        success, reward = self._outcome(ex.cap_q)
        ex = dataclasses.replace(ex, is_success=success)
        return (state.replace(extras=ex, t=state.t + 1), obs, reward,
                success, {"success": success})


def make(observation_type: str = "tactile_map", *, device="cuda",
         dtype=torch.float32, seed: int = 0,
         scene_path: str = None) -> StableGraspEnv:
    """The bundled StableGrasp scene, or the redmax XML file
    ``scene_path``, with its model on ``device`` (the card unless
    ``device='cpu'``)."""
    device = resolve_device(device)
    struct_, model = load_scene(scene_path, task_scenes.stable_grasp)
    return StableGraspEnv(struct_, model.to(device, dtype), observation_type,
                          seed)


if __name__ == "__main__":
    for key, entry in write_q_init_file().items():
        print(key, entry["dtype"], entry["q_init"])
