"""TactileInsertion: peg-in-hole from relative tactile frames.

Port of ``tactilesimulation_tpu/envs/tactile_insertion.py`` (reference task
envs/tactile_insertion_env.py): each env step runs a scripted 45-substep
insertion from a start pose the action adjusts; the observation is the
shear of the tactile field at the capture substeps relative to a reference
substep, with optional observation noise, per-episode normalisation and
domain randomisation of the contact parameters.

- the start pose: a grasp-and-lift settle of 100 + 100 + 300 substeps and
  a 500-substep hold (``settle``); the bundled scene's result ships in
  ``data/insertion_q_init.json`` for its float64 and float32 models, any
  other model settles once and is cached on disk under
  ``~/.cache/tactilesimulation_tpu_torch/``, keyed on the model's leaves as
  the JAX package keys its own cache;
- reset noise: xy ~ U(+-0.006), z ~ U(-0.0002, 0.0002), rot ~ U(+-pi/18),
  grasp height ~ U(-0.01, 0.005);
- domain randomisation: the pad-box pairs' kn, kt, mu (damping 1e3), the
  sensors' kn, kt, mu, damping and the grasp force;
- capture substeps: reference substep 6, then ``num_obs_frames`` substeps
  spaced over [12 or 15, 45); the field is read only at those substeps
  (the JAX scan reads all 45 and keeps these);
- actions relative or absolute, clipped to the workspace; success
  |x|, |y| <= 0.0022 (translation) or z < 0.0247 (rotation); reward
  absolute or delta.

The deterministic pieces (``_sample_reset``'s transform, ``_apply_action``,
``_outcome``, ``_obs_from_captured``, ``_apply_relative_motion``) take any
leading batch dimensions, so the lane-major vec env
(``tactile_insertion_lanes.py``) uses them on (B, ...) tensors. Every random
draw goes through ``_draw(what, B)``, in this order:

    reset:  "reset" (pose noise, domain randomisation), then "obs_noise"
    step:   "obs_noise"

The capture reads the field through ``tactile_query.may_read``'s rule: the
read kernel K4R where no gradient can flow (PPO's rollouts), the
differentiable ``dynamics.tactile_field`` otherwise.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple

import numpy as np
import torch

from ..model import task_scenes
from ..ops import tactile_query
from ..sim import dynamics, integrators, spatial
from . import start_pose
from .base import EnvState, FunctionalEnv, load_scene, resolve_device

ROWS, COLS = 13, 10
EXEC_STEPS = 45
SETTLE_STAGES = (100, 100, 300)   # grasp, close, lift
SETTLE_HOLD = 500
Q_INIT_FILE = os.path.join(start_pose.DATA_DIR, "insertion_q_init.json")
DR_NAMES = ("pair_kn", "pair_kt", "pair_mu", "pair_damping", "tac_kn",
            "tac_kt", "tac_mu", "tac_damping")


@dataclasses.dataclass(frozen=True)
class InsertionExtras:
    current_q_init: torch.Tensor    # (12,) commanded start pose
    original_q_init: torch.Tensor
    prev_object_pose: torch.Tensor  # (3,) x, y, rot
    pair_kn: torch.Tensor           # (K,) the episode's contact parameters
    pair_kt: torch.Tensor
    pair_mu: torch.Tensor
    pair_damping: torch.Tensor
    tac_kn: torch.Tensor            # (S,)
    tac_kt: torch.Tensor
    tac_mu: torch.Tensor
    tac_damping: torch.Tensor
    grasp_force: torch.Tensor       # ()
    obs: torch.Tensor
    is_success: torch.Tensor        # () bool


# ---------------------------------------------------------------------------
# the settled start pose
# ---------------------------------------------------------------------------

def settle(struct, model, step_sim=None, stages=SETTLE_STAGES,
           hold=SETTLE_HOLD):
    """Grasp and lift the box, then hold it above the hole: the start pose
    q (12,) of every episode (reference :126-170). ``stages`` are the
    substeps of the three ramps (grasp height, close, lift), ``hold`` those
    of the hold; the JAX package's are (100, 100, 300) and 500."""
    step_sim = step_sim or integrators.build_step(struct)
    dtype, device = model.dtype, model.device
    q = model.q_init.detach().cpu().numpy().copy()
    grasp_height = 0.2
    q[2] = grasp_height
    q[4] = q[5] = -0.03
    state = integrators.initial_state(struct, model).replace(
        q=torch.as_tensor(q, device=device),
        q_prev=torch.as_tensor(q, device=device))
    waypoints = [np.array([q[0], q[1], q[2], q[3], 0.0, 0.0]),
                 np.array([0.0, 0.0, grasp_height, 0.0, 0.0, 0.0]),
                 np.array([0.0, 0.0, grasp_height, 0.0, 1.0, 1.0]),
                 np.array([0.0, 0.0, grasp_height, 0.0, 1.0, 1.0])]
    us = []
    for stage, n in enumerate(stages):
        frac = (np.arange(1, n + 1) / n)[:, None]
        us.append(waypoints[stage][None]
                  + frac * (waypoints[stage + 1] - waypoints[stage])[None])
    us = torch.as_tensor(np.concatenate(us), dtype=dtype, device=device)
    with torch.no_grad():
        for u in us:
            state = step_sim(model, state, u)
        q1 = state.q.cpu().numpy().copy()
        q1[2] += 0.026 + 0.003
        q1[8] += 0.026 + 0.003
        q1_t = torch.as_tensor(q1, device=device)
        state = integrators.initial_state(struct, model).replace(
            q=q1_t, q_prev=q1_t)
        u_hold = q1[:6].copy()
        u_hold[4:6] = 1.0
        u_hold = torch.as_tensor(u_hold, device=device)
        for _ in range(hold):
            state = step_sim(model, state, u_hold)
    return state.q


def shipped_q_init():
    """{model key: (dtype name, q_init list)} of the shipped file."""
    return start_pose.shipped(Q_INIT_FILE)


def initial_pose(struct, model, step_sim=None):
    """The settled start pose of ``model``: from the shipped file, else
    from the disk cache, else settled now (and cached)."""
    return start_pose.load_or_settle(
        Q_INIT_FILE, "insertion_qinit", model,
        lambda: settle(struct, model, step_sim))


def write_q_init_file(path=Q_INIT_FILE):
    """Settle the bundled scene's float64 and float32 models on the CPU
    and write their start poses to ``path`` (minutes per model)."""
    struct, model = task_scenes.tactile_insertion()
    return start_pose.write_file(path, model, lambda m: settle(struct, m))


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------

class TactileInsertionEnv(FunctionalEnv):
    max_episode_steps = 15
    working_space_boundary = 0.015
    working_rotation_boundary = math.pi / 12.0
    max_error = (0.006, 0.006, math.pi / 18.0)
    grasp_force_range = (1.0 / 8.0, 0.8)

    def __init__(self, struct_, model, observation_type: str = "tactile_map",
                 observation_noise: bool = True,
                 normalize_tactile_obs: bool = True,
                 allow_translation: bool = True, allow_rotation: bool = False,
                 num_obs_frames: int = 5, action_xy_scale: float = 0.02,
                 action_rot_scale: float = math.pi / 18.0,
                 action_type: str = "relative", reward_type: str = "absolute",
                 domain_randomization: bool = False, seed: int = 0):
        if observation_type not in ("tactile_flatten", "tactile_map"):
            raise ValueError(observation_type)
        super().__init__(struct_, model, seed)
        self.observation_type = observation_type
        self.observation_noise = observation_noise
        self.normalize_tactile_obs = normalize_tactile_obs
        self.allow_translation = allow_translation
        self.allow_rotation = allow_rotation
        self.action_type = action_type
        self.reward_type = reward_type
        self.domain_randomization = domain_randomization
        self.tactile_samples = num_obs_frames
        initial_frame = 15 if observation_type == "tactile_flatten" else 12
        freq = (EXEC_STEPS - initial_frame) // num_obs_frames
        mask_frames = list(range(initial_frame + freq - 1, EXEC_STEPS, freq))[
            :num_obs_frames]
        self.capture_frames = [6] + mask_frames   # the reference frame first

        if allow_translation:
            self.action_dim = 3 if allow_rotation else 2
            scale = [action_xy_scale, action_xy_scale]
            if allow_rotation:
                scale.append(action_rot_scale)
        else:
            if not allow_rotation:
                raise ValueError("allow_translation or allow_rotation")
            self.action_dim = 1
            scale = [action_rot_scale]
        self.action_scale = torch.tensor(scale, dtype=self.dtype,
                                         device=self.device)

        self._step_sim = integrators.build_step(struct_)
        # the pad-box pairs, whose parameters domain randomisation draws
        box = struct_.body_index("box")
        pads = [struct_.body_index("tactile_pad_left"),
                struct_.body_index("tactile_pad_right")]
        self._dr_pairs = torch.tensor(
            [p.param_index for p in struct_.pairs
             if p.primitive_body == box and p.general_body in pads],
            device=self.device)
        self.q_init_ref = initial_pose(struct_, model, self._step_sim)

    # -- randomness ---------------------------------------------------------
    def _tensor(self, xs):
        return torch.tensor(xs, dtype=self.dtype, device=self.device)

    def _draw(self, what: str, B: int):
        """The env's draws for B instances, from its generator.

        "reset"     -> {"pos": (B, 3) or None, "rot": (B,) or None,
                        "height": (B,), and with domain randomisation
                        "ckn", "ckt", "cmu", "tkn", "tkt", "tmu", "tda",
                        "grasp": (B,) each}, taken in that order;
        "obs_noise" -> (B, S, 2, ROWS, COLS, 2) standard normal, or None
                       without observation noise.
        """
        u = self._uniform
        if what == "reset":
            d = {"pos": None, "rot": None}
            if self.allow_translation:
                d["pos"] = u((B, 3), self._tensor([-0.006, -0.006, -0.0002]),
                             self._tensor([0.006, 0.006, 0.0002]))
            if self.allow_rotation:
                d["rot"] = u((B,), -self.max_error[2], self.max_error[2])
            d["height"] = u((B,), -0.01, 0.005)
            if self.domain_randomization:
                for name, lo, hi in (("ckn", 2e3, 14e3), ("ckt", 20.0, 140.0),
                                     ("cmu", 0.5, 2.5), ("tkn", 50.0, 450.0),
                                     ("tkt", 0.2, 2.3), ("tmu", 0.5, 2.5),
                                     ("tda", 0.0, 100.0),
                                     ("grasp",) + self.grasp_force_range):
                    d[name] = u((B,), lo, hi)
            return d
        if what == "obs_noise":
            if not self.observation_noise:
                return None
            return torch.randn((B, self.tactile_samples, 2, ROWS, COLS, 2),
                               generator=self.generator, device=self.device,
                               dtype=self.dtype)
        raise ValueError(what)

    def step_noise(self, state):
        return self._draw("obs_noise", 1)

    # -- deterministic pieces (any leading batch dims) -----------------------
    @staticmethod
    def _apply_relative_motion(q, rel_pos, rel_rot, grasp_height_noise=0.0):
        """q (..., 12) moved by rel_pos (..., 2 or 3) and rotated by rel_rot
        (...) about z (reference :178-197)."""
        new_q = q.clone()
        if rel_pos.shape[-1] == 2:
            new_q[..., 0:2] += rel_pos
            new_q[..., 6:8] += rel_pos
        else:
            new_q[..., 0:3] += rel_pos
            new_q[..., 6:9] += rel_pos
        new_q[..., 2] += grasp_height_noise
        new_q[..., 3] += rel_rot
        zero = torch.zeros_like(rel_rot)
        zrot = torch.stack([zero, zero, rel_rot], dim=-1)
        new_q[..., 9:12] = spatial.rotvec_mul(q[..., 9:12], zrot)
        return new_q

    def _model_for(self, leaves):
        """The model with an episode's contact parameters (``leaves``: an
        ``InsertionExtras`` or a dict with the ``DR_NAMES``)."""
        get = (leaves.get if isinstance(leaves, dict)
               else lambda k: getattr(leaves, k))
        return dataclasses.replace(self.model,
                                   **{k: get(k) for k in DR_NAMES})

    def _sample_reset(self, B: int):
        """B episodes' starts (reference :202-216, :238-281) without the
        scripted execution, batch-first: {"q_cmd": (B, 12), the DR_NAMES
        (B, K) / (B, S), "grasp_force": (B,)}. Draws "reset"."""
        d = self._draw("reset", B)
        dtype, dev = self.dtype, self.device
        pos = (d["pos"] if self.allow_translation
               else torch.zeros((B, 2), dtype=dtype, device=dev))
        rot = (d["rot"] if self.allow_rotation
               else torch.zeros(B, dtype=dtype, device=dev))
        q_ref = self.q_init_ref.expand(B, -1)
        q_cmd = self._apply_relative_motion(q_ref, pos, rot, d["height"])

        m = self.model
        lanes = lambda x: x.expand(B, -1).clone()
        out = {k: lanes(getattr(m, k)) for k in DR_NAMES}
        grasp = torch.ones(B, dtype=dtype, device=dev)
        if self.domain_randomization:
            idx = self._dr_pairs
            for k, name in (("pair_kn", "ckn"), ("pair_kt", "ckt"),
                            ("pair_mu", "cmu")):
                out[k][:, idx] = d[name][:, None]
            out["pair_damping"][:, idx] = 1e3
            for k, name in (("tac_kn", "tkn"), ("tac_kt", "tkt"),
                            ("tac_mu", "tmu"), ("tac_damping", "tda")):
                out[k][:] = d[name][:, None]
            grasp = d["grasp"]
        return dict(q_cmd=q_cmd, grasp_force=grasp, **out)

    def _apply_action(self, current_q_init, original_q_init, u):
        """Action (..., action_dim) -> commanded start pose q_cmd (..., 12)
        (reference :294-328)."""
        u = torch.as_tensor(u, device=self.device).to(current_q_init.dtype)
        action = torch.clamp(u, -1.0, 1.0) * self.action_scale.to(u.dtype)
        cur = current_q_init
        if self.allow_translation:
            if self.action_type == "relative":
                b = self.working_space_boundary
                rel_xy = torch.minimum(torch.maximum(action[..., 0:2],
                                                     -b - cur[..., 0:2]),
                                       b - cur[..., 0:2])
            else:
                rel_xy = action[..., 0:2]
            base_idx = 2
        else:
            rel_xy = torch.zeros(cur.shape[:-1] + (2,), dtype=cur.dtype,
                                 device=cur.device)
            base_idx = 0
        if self.allow_rotation:
            rel_rot = action[..., base_idx]
            if self.action_type == "relative":
                b = self.working_rotation_boundary
                rel_rot = torch.minimum(torch.maximum(rel_rot,
                                                      -b - cur[..., 3]),
                                        torch.full_like(rel_rot, b))
        else:
            rel_rot = torch.zeros(cur.shape[:-1], dtype=cur.dtype,
                                  device=cur.device)
        base_q = cur if self.action_type == "relative" else original_q_init
        return self._apply_relative_motion(base_q, rel_xy, rel_rot)

    def _outcome(self, final_q, q_cmd, prev_pose):
        """(success, reward, pose, improve) of one execution, over leading
        batch dims (reference :387-409)."""
        pose = torch.stack([q_cmd[..., 0], q_cmd[..., 1], q_cmd[..., 3]],
                           dim=-1)
        me = torch.tensor(self.max_error, dtype=final_q.dtype,
                          device=final_q.device)
        if not self.allow_rotation:
            success = ((torch.abs(final_q[..., 6]) <= 0.0022)
                       & (torch.abs(final_q[..., 7]) <= 0.0022))
        else:
            success = final_q[..., 8] < 0.0247
        prev_err = torch.linalg.norm(prev_pose / me, dim=-1)
        err = torch.linalg.norm(pose / me, dim=-1)
        if self.reward_type == "absolute":
            reward = (-torch.sum(q_cmd[..., 0:2] ** 2, dim=-1) * 10000.0
                      - q_cmd[..., 3] ** 2 * 20.0)
        else:
            reward = (prev_err - err) * 10.0
            reward = reward + torch.where(success, 20.0, -1.0).to(
                reward.dtype)
        return success, reward, pose, prev_err > err

    def _obs_from_captured(self, captured, noise=None):
        """Captured fields (..., S+1, M, 3) -> observation: the shear
        relative to the reference frame, plus 1e-5 x ``noise``, normalised
        per instance (reference :361-377)."""
        lead = captured.shape[:-3]
        rel = captured[..., 1:, :, :] - captured[..., 0:1, :, :]
        shear = rel.reshape(lead + (self.tactile_samples, 2, ROWS, COLS,
                                    3))[..., 0:2]
        if self.observation_noise:
            shear = shear + 1e-5 * noise.reshape(shear.shape)
        if self.normalize_tactile_obs:
            norms = torch.linalg.norm(shear, dim=-1)
            max_len = torch.amax(norms.reshape(lead + (-1,)), dim=-1) + 1e-5
            shear = shear / (max_len / 30.0).reshape(lead + (1,) * 5)
        if self.observation_type == "tactile_flatten":
            return shear.reshape(lead + (-1,))
        n = len(lead)
        perm = tuple(range(n)) + tuple(n + i for i in (0, 1, 4, 2, 3))
        return shear.permute(perm).reshape(lead + (-1, ROWS, COLS))

    def obs_size(self) -> Tuple[int, ...]:
        if self.observation_type == "tactile_flatten":
            return (ROWS * COLS * 2 * 2 * self.tactile_samples,)
        return (2 * 2 * self.tactile_samples, ROWS, COLS)

    # -- the scripted execution ---------------------------------------------
    def _field(self, model, q, v):
        if tactile_query.may_read(self.struct, model, q, v):
            return tactile_query.tactile_field(self.struct, model, q, v)
        return dynamics.tactile_field(self.struct, model, q, v)

    def script(self, q_cmd, grasp_force):
        """The 45 controls (45, 6) of the scripted insertion from q_cmd
        (..., 12) and grasp_force (...): the joints lowered 1.1 mm from the
        commanded pose (raised 3 mm), the fingers at the grasp force.
        Leading dims go after the substep axis."""
        dtype = q_cmd.dtype
        init_jp = q_cmd[..., :6]
        target = init_jp.clone()
        target[..., 2] += -0.0011
        frac = (torch.arange(1, EXEC_STEPS + 1, dtype=dtype,
                             device=q_cmd.device) / EXEC_STEPS)
        frac = frac.reshape((EXEC_STEPS,) + (1,) * init_jp.ndim)
        us = init_jp[None] + frac * (target - init_jp)[None]
        us[..., 2] += 0.003
        us[..., 4] = grasp_force
        us[..., 5] = grasp_force
        return us

    def _execute(self, model, q_init, grasp_force, noise=None):
        """The 45-substep scripted insertion (reference :330-359) on the
        single-instance core -> (final q, obs)."""
        us = self.script(q_init, grasp_force)
        state = integrators.initial_state(self.struct, model).replace(
            q=q_init, q_prev=q_init)
        slots = {f: k for k, f in enumerate(self.capture_frames)}
        captured = [None] * len(slots)
        for i in range(EXEC_STEPS):
            state = self._step_sim(model, state, us[i])
            if i in slots:
                captured[slots[i]] = self._field(model, state.q, state.qdot)
        obs = self._obs_from_captured(torch.stack(captured),
                                      None if noise is None else noise[0])
        return state.q, obs

    # -- api ---------------------------------------------------------------
    def reset(self):
        s = self._sample_reset(1)
        s = {k: v[0] for k, v in s.items()}
        q_cmd = s["q_cmd"]
        pose = torch.stack([q_cmd[0], q_cmd[1], q_cmd[3]])
        ex = InsertionExtras(
            current_q_init=q_cmd, original_q_init=q_cmd,
            prev_object_pose=pose,
            **{k: s[k] for k in DR_NAMES}, grasp_force=s["grasp_force"],
            obs=torch.zeros(self.obs_size(), dtype=self.dtype,
                            device=self.device),
            is_success=torch.zeros((), dtype=torch.bool, device=self.device))
        model = self._model_for(ex)
        _, obs = self._execute(model, q_cmd, s["grasp_force"],
                               self._draw("obs_noise", 1))
        ex = dataclasses.replace(ex, obs=obs)
        state = EnvState(sim=integrators.initial_state(self.struct, model),
                         t=torch.zeros((), dtype=torch.int32,
                                       device=self.device),
                         extras=ex)
        return state, obs

    def step(self, state: EnvState, u, noise=None):
        ex = state.extras
        noise = self.step_noise(state) if noise is None else noise
        q_cmd = self._apply_action(ex.current_q_init, ex.original_q_init, u)
        model = self._model_for(ex)
        final_q, obs = self._execute(model, q_cmd, ex.grasp_force, noise)
        success, reward, pose, improve = self._outcome(
            final_q, q_cmd, ex.prev_object_pose)
        info = {"success": success, "improve": improve,
                # the pose the policy had to correct (play's 3 x 3 classes)
                "prev_object_pose": ex.prev_object_pose}
        ex = dataclasses.replace(ex, current_q_init=q_cmd,
                                 prev_object_pose=pose, obs=obs,
                                 is_success=success)
        return (state.replace(extras=ex, t=state.t + 1), obs, reward,
                success, info)


def make(observation_type: str = "tactile_map", *, device="cuda",
         dtype=torch.float32, seed: int = 0, scene_path: str = None,
         **kwargs) -> TactileInsertionEnv:
    """The bundled TactileInsertion scene, or the redmax XML file
    ``scene_path``, with its model on ``device`` (the card unless
    ``device='cpu'``); ``kwargs`` are the env's options."""
    device = resolve_device(device)
    struct_, model = load_scene(scene_path, task_scenes.tactile_insertion)
    return TactileInsertionEnv(struct_, model.to(device, dtype),
                               observation_type, seed=seed, **kwargs)


if __name__ == "__main__":
    for key, entry in write_q_init_file().items():
        print(key, entry["dtype"], entry["q_init"])
