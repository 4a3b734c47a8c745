"""DClaw cap rotation with abstract (mesh-vertex) tactile sensors.

Port of ``tactilesimulation_tpu/envs/dclaw_rotate.py`` (reference task
envs/dclaw_rotate_env.py): a 9-DoF three-finger D'Claw rotates a bottle cap
by at least 45 degrees; observations include three 20x20x3 tactile flow
images from per-vertex fingertip markers.

- reset: the [-0.5, 0.8] finger pose plus 0.05 N(0, 1) on the 9 finger
  dofs; domain randomisation as Model leaves of the episode: cap damping
  U(0.01, 0.7), cap radius U(0.02, 0.08) (its size and its endeffector at
  [radius, 0, 0]), the cap joint at (dx, dy) U(-0.02, 0.02), z 0.075;
- control: relative position (scale 0.06, per-dof limits), absolute
  position or torque; frame_skip 5;
- reward: -0.5 per finger out of contact, rotation progress toward pi/4,
  the power penalty on the unclipped action; +50 at pi/4, -50 once a
  fingertip rises above the cap top z = 0.05; done on either.

Every draw goes through ``_draw("reset", B)``: {"noise": (B, 9) N(0, 1),
"damping", "radius": (B,), "dxy": (B, 2)}, in that order; a step draws
nothing.

Each observation reads the field once, through ``tactile_query.may_read``'s
rule: the read kernel K4R where no gradient can flow, the differentiable
``dynamics.tactile_field`` otherwise. The reset's edits change the read's
inputs (the cap's size and joint), so each episode's Model gets a read plan
of its own; its steps share it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..model import task_scenes
from ..ops import tactile_query
from ..sim import dynamics, integrators, kinematics
from .base import EnvState, FunctionalEnv, load_scene, resolve_device

ROWS, COLS = 20, 20
DOF_LIMIT = np.array([[-0.45, 1.35], [-2, 2], [1, 2]] * 3, dtype=np.float64)
CAP_TOP_Z = 0.05
MAX_ANGLE = math.pi / 4
OBS_TYPES = ("tactile", "tactile_flatten", "no_tactile")


@dataclasses.dataclass(frozen=True)
class DClawExtras:
    dof_damping: torch.Tensor   # the episode's Model leaves
    body_size: torch.Tensor
    joint_pos: torch.Tensor
    ee_pos: torch.Tensor
    tactile_imgs: torch.Tensor  # (3, 20, 20, 3) last flow images


class DClawRotateEnv(FunctionalEnv):
    max_episode_steps = 200
    frame_skip = 5
    action_dim = 9
    relative_q_scale = 0.06
    rot_coef = 1.0
    power_coef = 0.005

    def __init__(self, struct_, model, observation_type: str = "tactile",
                 torque_control: bool = False, relative_control: bool = True,
                 seed: int = 0):
        if observation_type not in OBS_TYPES:
            raise ValueError(f"observation_type {observation_type!r} not in "
                             f"{OBS_TYPES}")
        super().__init__(struct_, model, seed)
        self.observation_type = observation_type
        self.is_torque_control = torque_control
        self.relative_control = relative_control
        self._step_sim = integrators.build_step(struct_)
        self._cap_joint = struct_.joint_index("cap")
        self._cap_body = struct_.body_index("cap")
        self._cap_ee = struct_.ee_names.index("cap")
        self._cap_dof = struct_.joint_dof_offset[self._cap_joint]
        # each sensor's rows -> its image's pixels, as one scatter
        rows, pix = [], []
        for k, s in enumerate(struct_.sensors):
            ip = np.asarray(s.image_pos, np.int64)
            rows.append(np.arange(s.marker_start,
                                  s.marker_start + s.marker_count))
            pix.append((k * ROWS + ip[:, 0]) * COLS + ip[:, 1])
        self._img_rows = torch.as_tensor(np.concatenate(rows),
                                         device=self.device)
        self._img_pix = torch.as_tensor(np.concatenate(pix),
                                        device=self.device)
        self._n_img = len(struct_.sensors)
        self._lim = torch.as_tensor(DOF_LIMIT, dtype=self.dtype,
                                    device=self.device)
        q = torch.zeros(struct_.ndof_q, dtype=self.dtype, device=self.device)
        q[[1, 4, 7]] = -0.5
        q[[2, 5, 8]] = 0.8
        self.q_init = q

    def obs_size(self) -> Tuple[int, ...]:
        if self.observation_type == "no_tactile":
            return (18,)
        return (18 + 3 * ROWS * COLS * 3,)

    # -- randomness ---------------------------------------------------------
    def _draw(self, what: str, B: int):
        if what != "reset":
            raise ValueError(what)
        noise = torch.randn((B, 9), generator=self.generator,
                            device=self.device, dtype=self.dtype)
        return {"noise": noise,
                "damping": self._uniform((B,), 0.01, 0.7),
                "radius": self._uniform((B,), 0.02, 0.08),
                "dxy": self._uniform((B, 2), -0.02, 0.02)}

    def _model_for(self, ex: DClawExtras):
        return dataclasses.replace(
            self.model, dof_damping=ex.dof_damping, body_size=ex.body_size,
            joint_pos=ex.joint_pos, ee_pos=ex.ee_pos)

    # -- observation --------------------------------------------------------
    def _field(self, model, q, v):
        if tactile_query.may_read(self.struct, model, q, v):
            return tactile_query.tactile_field(self.struct, model, q, v)
        return dynamics.tactile_field(self.struct, model, q, v)

    def _images(self, field):
        """(3, 20, 20, 3) flow images: each sensor's rows added into its
        image at their ``image_pos`` (rows that share a pixel add)."""
        img = field.new_zeros((self._n_img * ROWS * COLS, 3))
        img = img.index_put((self._img_pix,), field[self._img_rows],
                            accumulate=True)
        return img.reshape(self._n_img, ROWS, COLS, 3)

    def _flow_images(self, model, q, qdot):
        return self._images(self._field(model, q, qdot))

    def _get_obs(self, model, q, imgs):
        var = kinematics.ee_positions(self.struct, model, q)
        base = torch.cat([q[:9], var[:9]])
        if self.observation_type == "no_tactile":
            return base
        if self.observation_type == "tactile":
            tac = imgs.permute(0, 3, 1, 2).reshape(-1)   # (9, 20, 20) flat
        else:
            tac = imgs.reshape(-1)
        return torch.cat([base, tac])

    # -- api ---------------------------------------------------------------
    def reset(self):
        d = {k: v[0] for k, v in self._draw("reset", 1).items()}
        q = self.q_init.clone()
        q[0:9] += 0.05 * d["noise"]
        m = self.model
        dof_damping = m.dof_damping.clone()
        dof_damping[self._cap_dof] = d["damping"]
        body_size = m.body_size.clone()
        body_size[self._cap_body, 0] = d["radius"]
        joint_pos = m.joint_pos.clone()
        joint_pos[self._cap_joint, 0:2] = d["dxy"]
        joint_pos[self._cap_joint, 2] = 0.075
        ee_pos = m.ee_pos.clone()
        ee_pos[self._cap_ee] = 0.0
        ee_pos[self._cap_ee, 0] = d["radius"]
        ex = DClawExtras(dof_damping=dof_damping, body_size=body_size,
                         joint_pos=joint_pos, ee_pos=ee_pos,
                         tactile_imgs=q.new_zeros((self._n_img, ROWS, COLS,
                                                   3)))
        model = self._model_for(ex)
        sim = integrators.initial_state(self.struct, model).replace(
            q=q, q_prev=q)
        imgs = self._flow_images(model, q, torch.zeros_like(q))
        ex = dataclasses.replace(ex, tactile_imgs=imgs)
        obs = self._get_obs(model, q, imgs)
        return EnvState(sim=sim, t=torch.zeros((), dtype=torch.int32,
                                               device=self.device),
                        extras=ex), obs

    def target(self, q, u):
        """The motors' target (9,) from the action ``u`` at ``q``."""
        action = torch.clamp(u, -1.0, 1.0)
        lo, hi = self._lim[:, 0], self._lim[:, 1]
        if self.is_torque_control:
            return action
        if self.relative_control:
            return torch.minimum(torch.maximum(
                q[:9] + action * self.relative_q_scale, lo), hi)
        return 0.5 * (action + 1.0) * (hi - lo) + lo

    def step(self, state: EnvState, u, noise=None):
        ex = state.extras
        model = self._model_for(ex)
        u = torch.as_tensor(u, dtype=self.dtype, device=self.device)
        target = self.target(state.sim.q, u)
        sim = state.sim
        for _ in range(self.frame_skip):
            sim = self._step_sim(model, sim, target)

        imgs = self._flow_images(model, sim.q, sim.qdot)
        obs = self._get_obs(model, sim.q, imgs)

        # reward (reference :122-162)
        var = kinematics.ee_positions(self.struct, model, sim.q)
        fingertip_z = var[:9][2::3]
        cap_angle = sim.q[-1]
        finger_force = torch.sum(torch.linalg.norm(imgs, dim=-1),
                                 dim=(1, 2))
        not_in_contact = (finger_force < 1.0).to(self.dtype)
        reward = -0.5 * torch.sum(not_in_contact)
        reward = reward - self.rot_coef * torch.clamp(
            cap_angle - MAX_ANGLE, max=0.0) ** 2
        reward = reward - self.power_coef * torch.sum(u ** 2)
        lifted = torch.any(fingertip_z > CAP_TOP_Z)
        success = cap_angle > MAX_ANGLE
        reward = reward + torch.where(lifted, -50.0, 0.0).to(self.dtype)
        reward = reward + torch.where(success, 50.0, 0.0).to(self.dtype)
        done = lifted | success
        new_state = EnvState(sim=sim, t=state.t + 1,
                             extras=dataclasses.replace(ex,
                                                        tactile_imgs=imgs))
        return new_state, obs, reward, done, {"success": success}


def make(observation_type: str = "tactile", *, torque_control: bool = False,
         relative_control: bool = True, device="cuda", dtype=torch.float32,
         seed: int = 0, scene_path: str = None) -> DClawRotateEnv:
    """The bundled procedural D'Claw, or the redmax XML file
    ``scene_path`` (e.g. the original dclaw_*_control.xml assets with their
    contact and tactile sidecar files), with its model on ``device`` (the
    card unless ``device='cpu'``)."""
    device = resolve_device(device)
    struct_, model = load_scene(scene_path, task_scenes.dclaw)
    return DClawRotateEnv(struct_, model.to(device, dtype), observation_type,
                          torque_control, relative_control, seed)
