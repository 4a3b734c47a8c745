"""Host-side scene description (numpy dataclasses).

``SceneSpec`` is the intermediate representation produced by the XML front-end
(`xml_parser.py`) or by first-class Python scene builders (`scenes.py`), and
consumed by `builder.py` which compiles it into the static ``Structure`` +
differentiable ``Model`` pytree pair used by the simulator core.

The schema mirrors the redmax XML surface documented in SURVEY.md §2.4
(reference exemplars: envs/assets/pusher/pusher.xml, stable_grasp.xml,
tactile_insertion.xml, dclaw_rotate/*.xml, assets/tactile_pad/tactile_pad.xml)
without copying any reference code — it is a fresh numpy representation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Joint / body / geometry enums (static codes baked into Structure)
# ---------------------------------------------------------------------------

JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2
JOINT_PLANAR = 3
JOINT_TRANSLATIONAL = 4
JOINT_FREE3D_EXP = 5
JOINT_FREE3D_EULER = 6

JOINT_NDOF = {
    JOINT_FIXED: 0,
    JOINT_REVOLUTE: 1,
    JOINT_PRISMATIC: 1,
    JOINT_PLANAR: 2,
    JOINT_TRANSLATIONAL: 3,
    JOINT_FREE3D_EXP: 6,
    JOINT_FREE3D_EULER: 6,
}

JOINT_TYPE_NAMES = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
    "planar": JOINT_PLANAR,
    "translational": JOINT_TRANSLATIONAL,
    "free3d-exp": JOINT_FREE3D_EXP,
    "free3d-euler": JOINT_FREE3D_EULER,
}

GEOM_CUBOID = 0
GEOM_CYLINDER = 1
GEOM_SPHERE = 2
GEOM_MESH = 3      # visual-only collision fallback (reference meshes are visual)
GEOM_ABSTRACT = 4  # explicit mass/inertia + contact-point cloud

CTRL_FORCE = 0
CTRL_POSITION = 1


@dataclasses.dataclass
class JointSpec:
    name: str
    jtype: int
    parent: int                    # parent joint index (-1 = world)
    pos: np.ndarray                # (3,) frame origin in parent joint frame
    quat: np.ndarray               # (4,) wxyz
    axis0: np.ndarray              # (3,) primary axis (revolute/prismatic/planar)
    axis1: np.ndarray              # (3,) secondary axis (planar)
    damping: float = 0.0
    lim: Optional[Tuple[float, float]] = None
    lim_stiffness: float = 0.0
    q_init: Optional[np.ndarray] = None  # per-dof initial value (defaults 0)


@dataclasses.dataclass
class BodySpec:
    name: str
    joint: int                     # owning joint index
    gtype: int
    pos: np.ndarray                # (3,) body frame origin in joint frame
    quat: np.ndarray               # (4,) wxyz
    # geometry params: cuboid -> full extents (3,); cylinder -> [radius, half_len];
    # sphere -> [radius]; mesh/abstract -> fallback box extents
    size: np.ndarray
    density: float = 1000.0
    mass: Optional[float] = None           # abstract bodies: explicit
    inertia: Optional[np.ndarray] = None   # (3,) diag about COM in body frame
    rgba: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5, 1.0]))
    texture: str = ""
    # contact point generation
    contact_resolution: Optional[Tuple[int, int, int]] = None       # cuboid grid
    contact_angle_resolution: Optional[int] = None                  # cylinder
    contact_radius_resolution: Optional[int] = None
    contact_points: Optional[np.ndarray] = None                     # (N,3) explicit
    # abstract bodies: collision points are given in the joint frame (their
    # pos/quat transform maps mesh space -> joint space)
    contact_points_in_joint_frame: bool = False
    # transform bookkeeping for OBJ_TO_WORLD mesh bodies
    pos_is_world: bool = False


@dataclasses.dataclass
class MotorSpec:
    joint: int
    ctrl: int                      # CTRL_FORCE | CTRL_POSITION
    P: float = 0.0
    D: float = 0.0
    ctrl_range: Tuple[float, float] = (-np.inf, np.inf)


@dataclasses.dataclass
class ContactPairSpec:
    """general body's point cloud vs primitive body's SDF (or ground)."""
    general_body: int              # body index providing contact points
    primitive_body: int            # body index providing the SDF; -1 = ground
    kn: float = 1e3
    kt: float = 1.0
    mu: float = 0.8
    damping: float = 0.0
    render: bool = False


@dataclasses.dataclass
class TactileSpec:
    name: str
    body: int
    # per-marker local-frame data, all (M, 3) except image_pos (M, 2) ints
    pos: np.ndarray
    normal: np.ndarray
    axis0: np.ndarray
    axis1: np.ndarray
    image_pos: np.ndarray
    rows: int
    cols: int
    kn: float = 1e2
    kt: float = 1.0
    mu: float = 1.0
    damping: float = 0.0
    render: bool = False
    # abstract sensors: marker coords are in the owning joint's frame
    in_joint_frame: bool = False


@dataclasses.dataclass
class EndEffectorSpec:
    name: str
    joint: int
    pos: np.ndarray                # (3,) in joint frame
    radius: float = 0.003


@dataclasses.dataclass
class VirtualObjectSpec:
    name: str
    pos: np.ndarray
    quat: np.ndarray
    size: np.ndarray
    texture: str = ""


@dataclasses.dataclass
class SceneSpec:
    name: str
    integrator: str = "BDF1"       # "BDF1" | "BDF2"
    timestep: float = 5e-3
    gravity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -9.8]))
    ground_pos: Optional[np.ndarray] = None
    ground_normal: Optional[np.ndarray] = None
    solver_tol: float = 1e-9
    solver_max_iter: int = 10
    solver_max_ls: int = 4
    joints: List[JointSpec] = dataclasses.field(default_factory=list)
    bodies: List[BodySpec] = dataclasses.field(default_factory=list)
    motors: List[MotorSpec] = dataclasses.field(default_factory=list)
    contacts: List[ContactPairSpec] = dataclasses.field(default_factory=list)
    tactiles: List[TactileSpec] = dataclasses.field(default_factory=list)
    endeffectors: List[EndEffectorSpec] = dataclasses.field(default_factory=list)
    virtuals: List[VirtualObjectSpec] = dataclasses.field(default_factory=list)

    # -- name lookups ------------------------------------------------------
    def body_index(self, name: str) -> int:
        for i, b in enumerate(self.bodies):
            if b.name == name:
                return i
        raise KeyError(f"no body named {name!r}")

    def joint_index(self, name: str) -> int:
        for i, j in enumerate(self.joints):
            if j.name == name:
                return i
        raise KeyError(f"no joint named {name!r}")

    @property
    def ndof_q(self) -> int:
        return sum(JOINT_NDOF[j.jtype] for j in self.joints)

    @property
    def ndof_u(self) -> int:
        return sum(JOINT_NDOF[self.joints[m.joint].jtype] for m in self.motors)

    @property
    def ndof_var(self) -> int:
        return 3 * len(self.endeffectors)

    @property
    def ndof_tactile(self) -> int:
        return 3 * sum(t.pos.shape[0] for t in self.tactiles)
