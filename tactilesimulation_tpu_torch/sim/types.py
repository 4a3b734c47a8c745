"""Core types: static ``Structure`` + numeric ``Model`` (a dataclass of tensors).

Mirrors ``tactilesimulation_tpu/sim/types.py``. ``Structure``, ``PairInfo``
and ``SensorInfo`` are frozen dataclasses of host numpy arrays and tuples
(topology, index tables); ``Model`` holds every numeric quantity as a torch
tensor and moves with ``.to(device, dtype)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass
class Model:
    h: torch.Tensor                   # () timestep
    gravity: torch.Tensor             # (3,)
    # joints
    joint_pos: torch.Tensor           # (J, 3) frame origin in parent joint frame
    joint_quat: torch.Tensor          # (J, 4)
    joint_axis0: torch.Tensor         # (J, 3)
    joint_axis1: torch.Tensor         # (J, 3)
    # per-dof quantities
    dof_damping: torch.Tensor         # (ndof,)
    dof_lim_lower: torch.Tensor       # (ndof,)
    dof_lim_upper: torch.Tensor       # (ndof,)
    dof_lim_stiffness: torch.Tensor   # (ndof,)
    q_init: torch.Tensor              # (ndof,)
    qdot_init: torch.Tensor           # (ndof,)
    # bodies
    body_pos: torch.Tensor            # (NB, 3) body frame in joint frame
    body_quat: torch.Tensor           # (NB, 4)
    body_mass: torch.Tensor           # (NB,)
    body_inertia: torch.Tensor        # (NB, 3) diag, body frame, about COM
    body_size: torch.Tensor           # (NB, 3) SDF geometry params
    body_rgba: torch.Tensor           # (NB, 4) rendering only
    # motors (per actuated dof)
    motor_kp: torch.Tensor            # (ndof_u,)
    motor_kd: torch.Tensor            # (ndof_u,)
    motor_ctrl_lo: torch.Tensor       # (ndof_u,)
    motor_ctrl_hi: torch.Tensor       # (ndof_u,)
    motor_pos_mask: torch.Tensor      # (ndof_u,) 1.0 = PD position control
    # contact machinery
    cp_pos: torch.Tensor              # (Ncp, 3) points in owning JOINT frame
    pair_kn: torch.Tensor             # (K,)
    pair_kt: torch.Tensor
    pair_mu: torch.Tensor
    pair_damping: torch.Tensor
    ground_pos: torch.Tensor          # (3,)
    ground_normal: torch.Tensor       # (3,)
    # tactile sensors
    tac_pos: torch.Tensor             # (Mtot, 3) markers in owning JOINT frame
    tac_normal: torch.Tensor          # (Mtot, 3)
    tac_axis0: torch.Tensor
    tac_axis1: torch.Tensor
    tac_kn: torch.Tensor              # (S,)
    tac_kt: torch.Tensor
    tac_mu: torch.Tensor
    tac_damping: torch.Tensor
    # variables / virtual objects
    ee_pos: torch.Tensor              # (NE, 3) in joint frame
    virtual_pos: torch.Tensor         # (NV, 3) render-only goal markers
    virtual_quat: torch.Tensor        # (NV, 4)

    def to(self, device=None, dtype=None) -> "Model":
        """A copy with every leaf moved to ``device`` and cast to ``dtype``."""
        return Model(**{f.name: getattr(self, f.name).to(device=device,
                                                         dtype=dtype)
                        for f in dataclasses.fields(self)})

    @property
    def dtype(self) -> torch.dtype:
        return self.h.dtype

    @property
    def device(self) -> torch.device:
        return self.h.device


# each Model leaf's dims for one instance; a leaf with more carries batch
# axes (leading in the single-instance core, trailing on the lanes stepper)
LEAF_NDIM = {
    "h": 0, "gravity": 1, "joint_pos": 2, "joint_quat": 2, "joint_axis0": 2,
    "joint_axis1": 2, "dof_damping": 1, "dof_lim_lower": 1,
    "dof_lim_upper": 1, "dof_lim_stiffness": 1, "q_init": 1, "qdot_init": 1,
    "body_pos": 2, "body_quat": 2, "body_mass": 1, "body_inertia": 2,
    "body_size": 2, "body_rgba": 2, "motor_kp": 1, "motor_kd": 1,
    "motor_ctrl_lo": 1, "motor_ctrl_hi": 1, "motor_pos_mask": 1,
    "cp_pos": 2, "pair_kn": 1, "pair_kt": 1, "pair_mu": 1,
    "pair_damping": 1, "ground_pos": 1, "ground_normal": 1, "tac_pos": 2,
    "tac_normal": 2, "tac_axis0": 2, "tac_axis1": 2, "tac_kn": 1,
    "tac_kt": 1, "tac_mu": 1, "tac_damping": 1, "ee_pos": 2,
    "virtual_pos": 2, "virtual_quat": 2}


@dataclasses.dataclass(frozen=True)
class SimState:
    """Integrator state: ``(q, qdot)`` plus one step of history for BDF2
    and the step counter (an int32 tensor, so BDF2's first-step test stays
    on the device): (n,) leaves and a 0-d counter for one instance, (B, n)
    and (B,) for a batch."""
    q: torch.Tensor
    qdot: torch.Tensor
    q_prev: torch.Tensor              # previous-step q (BDF2 history)
    qdot_prev: torch.Tensor
    t: torch.Tensor                   # () or (B,) int32 step counter

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class PairInfo:
    general_body: int
    primitive_body: int               # -1 = ground half-space
    point_start: int                  # slice into cp_pos (or tac_pos)
    point_count: int
    general_is_sphere: bool           # analytic sphere-center contact
    param_index: int                  # row in pair_* (or tac_* for tactile)
    sensor_index: int = -1            # >= 0 for tactile pairs


@dataclasses.dataclass(frozen=True)
class SensorInfo:
    name: str
    body: int
    marker_start: int
    marker_count: int
    rows: int
    cols: int
    image_pos: Any                    # (M, 2) numpy int array


@dataclasses.dataclass(frozen=True)
class Structure:
    name: str
    integrator: str                   # "BDF1" | "BDF2"
    njoints: int
    nbodies: int
    ndof_q: int
    ndof_u: int
    ndof_var: int
    ndof_tactile: int
    joint_types: Tuple[int, ...]
    joint_parents: Tuple[int, ...]
    joint_dof_offset: Tuple[int, ...]
    joint_ndof: Tuple[int, ...]
    joint_names: Tuple[str, ...]
    body_joint: Tuple[int, ...]
    body_gtype: Tuple[int, ...]
    body_names: Tuple[str, ...]
    motor_dof: Tuple[int, ...]        # u index -> q dof index
    # vectorized-FK tables (host numpy; see kinematics.build_fk_tables)
    fk_tables: Any
    cp_joint: Tuple[int, ...]         # per contact point: owning joint
    pairs: Tuple[PairInfo, ...]
    tac_joint: Tuple[int, ...]        # per marker: owning joint
    tactile_pairs: Tuple[PairInfo, ...]
    contact_groups: Tuple[Any, ...]   # flattened instance groups (contact.py)
    sensors: Tuple[SensorInfo, ...]
    ee_joint: Tuple[int, ...]
    ee_names: Tuple[str, ...]
    virtual_names: Tuple[str, ...]
    has_ground: bool
    solver_tol: float
    solver_max_iter: int
    solver_max_ls: int

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def joint_index(self, name: str) -> int:
        return self.joint_names.index(name)

    def sensor_index(self, name: str) -> int:
        for i, s in enumerate(self.sensors):
            if s.name == name:
                return i
        raise KeyError(name)
