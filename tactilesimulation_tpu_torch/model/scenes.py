"""First-class Python scene construction + canonical reference scene loaders.

The XML front-end (xml_parser.py) exists for asset compatibility with redmax
scene files; this module is the native way to author scenes — build a
``SceneSpec`` directly (no XML round-trip). Used by tests (synthetic oracle
scenes) and by users porting from the reference.
"""

from __future__ import annotations

import numpy as np

from .schema import (
    GEOM_CUBOID,
    GEOM_CYLINDER,
    GEOM_SPHERE,
    JOINT_TYPE_NAMES,
    BodySpec,
    ContactPairSpec,
    EndEffectorSpec,
    JointSpec,
    MotorSpec,
    SceneSpec,
    TactileSpec,
    CTRL_FORCE,
    CTRL_POSITION,
)
from . import assets

_GEOM_BY_NAME = {"cuboid": GEOM_CUBOID, "cylinder": GEOM_CYLINDER,
                 "sphere": GEOM_SPHERE}


class SceneBuilder:
    """Fluent SceneSpec construction.

    Example (pendulum):
        b = SceneBuilder("pendulum", integrator="BDF1", timestep=1e-3)
        j = b.add_joint("hinge", "revolute", axis=(0, 1, 0), pos=(0, 0, 1))
        b.add_body("bob", j, "cuboid", size=(0.1, 0.1, 0.1), pos=(0, 0, -0.5),
                   density=1000.0)
        struct, model = b.build()
    """

    def __init__(self, name, integrator="BDF1", timestep=5e-3,
                 gravity=(0.0, 0.0, -9.8), ground=None, ground_normal=(0, 0, 1)):
        self.spec = SceneSpec(name=name, integrator=integrator,
                              timestep=timestep,
                              gravity=np.asarray(gravity, dtype=np.float64))
        if ground is not None:
            self.spec.ground_pos = np.asarray(ground, dtype=np.float64)
            n = np.asarray(ground_normal, dtype=np.float64)
            self.spec.ground_normal = n / np.linalg.norm(n)

    def add_joint(self, name, jtype, parent=-1, pos=(0, 0, 0), quat=(1, 0, 0, 0),
                  axis=(1, 0, 0), axis1=(0, 1, 0), damping=0.0, lim=None,
                  lim_stiffness=0.0) -> int:
        a0 = np.asarray(axis, dtype=np.float64)
        a1 = np.asarray(axis1, dtype=np.float64)
        quat = np.asarray(quat, dtype=np.float64)
        self.spec.joints.append(JointSpec(
            name=name, jtype=JOINT_TYPE_NAMES[jtype], parent=parent,
            pos=np.asarray(pos, dtype=np.float64),
            quat=quat / np.linalg.norm(quat),
            axis0=a0 / np.linalg.norm(a0), axis1=a1 / np.linalg.norm(a1),
            damping=damping, lim=lim, lim_stiffness=lim_stiffness))
        return len(self.spec.joints) - 1

    def add_body(self, name, joint, gtype, size, pos=(0, 0, 0), quat=(1, 0, 0, 0),
                 density=1000.0, contact_resolution=None,
                 contact_angle_resolution=None, contact_radius_resolution=None,
                 rgba=(0.5, 0.5, 0.5, 1.0)) -> int:
        g = _GEOM_BY_NAME[gtype]
        size = np.asarray(size, dtype=np.float64)
        if g == GEOM_CYLINDER:
            # accepts (radius, full_length)
            size = np.array([size[0], size[1] / 2.0, 0.0])
        elif g == GEOM_SPHERE:
            size = np.array([size[0], 0.0, 0.0])
        self.spec.bodies.append(BodySpec(
            name=name, joint=joint, gtype=g,
            pos=np.asarray(pos, dtype=np.float64),
            quat=np.asarray(quat, dtype=np.float64), size=size, density=density,
            contact_resolution=contact_resolution,
            contact_angle_resolution=contact_angle_resolution,
            contact_radius_resolution=contact_radius_resolution,
            rgba=np.asarray(rgba, dtype=np.float64)))
        return len(self.spec.bodies) - 1

    def add_mesh_body(self, name, joint, density=1000.0, extent=0.04,
                      pos=(0, 0, 0), quat=(1, 0, 0, 0)):
        """Visual-mesh link: fallback-box inertia, no collision (matches the
        XML path's treatment of the reference's visual-only mesh bodies)."""
        from .schema import GEOM_MESH
        self.spec.bodies.append(BodySpec(
            name=name, joint=joint, gtype=GEOM_MESH,
            pos=np.asarray(pos, dtype=np.float64),
            quat=np.asarray(quat, dtype=np.float64),
            size=np.full(3, extent), density=density))
        return len(self.spec.bodies) - 1

    def add_virtual(self, name, pos, size, quat=(1, 0, 0, 0), texture=""):
        from .schema import VirtualObjectSpec
        self.spec.virtuals.append(VirtualObjectSpec(
            name=name, pos=np.asarray(pos, dtype=np.float64),
            quat=np.asarray(quat, dtype=np.float64),
            size=np.asarray(size, dtype=np.float64), texture=texture))

    def add_motor(self, joint, ctrl="force", P=0.0, D=0.0,
                  ctrl_range=(-np.inf, np.inf)):
        self.spec.motors.append(MotorSpec(
            joint=joint, ctrl=CTRL_POSITION if ctrl == "position" else CTRL_FORCE,
            P=P, D=D, ctrl_range=tuple(ctrl_range)))

    def add_ground_contact(self, body, kn=1e3, kt=1.0, mu=0.8, damping=0.0):
        self.spec.contacts.append(ContactPairSpec(
            general_body=body, primitive_body=-1, kn=kn, kt=kt, mu=mu,
            damping=damping))

    def add_contact(self, general_body, primitive_body, kn=1e3, kt=1.0,
                    mu=0.8, damping=0.0):
        self.spec.contacts.append(ContactPairSpec(
            general_body=general_body, primitive_body=primitive_body,
            kn=kn, kt=kt, mu=mu, damping=damping))

    def add_rect_tactile(self, name, body, rect_pos0, rect_pos1, axis0, axis1,
                         rows, cols, kn=1e2, kt=1.0, mu=1.0, damping=0.0):
        mk = assets.rect_array_markers(rect_pos0, rect_pos1, axis0, axis1,
                                       rows, cols)
        self.spec.tactiles.append(TactileSpec(
            name=name, body=body, rows=rows, cols=cols, pos=mk["pos"],
            normal=mk["normal"], axis0=mk["axis0"], axis1=mk["axis1"],
            image_pos=mk["image_pos"], kn=kn, kt=kt, mu=mu, damping=damping))

    def add_endeffector(self, name, joint, pos=(0, 0, 0), radius=0.003):
        self.spec.endeffectors.append(EndEffectorSpec(
            name=name, joint=joint, pos=np.asarray(pos, dtype=np.float64),
            radius=radius))

    def build(self, dtype=None):
        from . import builder
        return builder.build(self.spec, dtype=dtype)


def pendulum(timestep=5e-3, damping=0.0, integrator="BDF1"):
    """Single revolute pendulum: analytic oracle for integrator tests."""
    b = SceneBuilder("pendulum", integrator=integrator, timestep=timestep)
    j = b.add_joint("hinge", "revolute", axis=(0, 1, 0), pos=(0, 0, 1.0),
                    damping=damping)
    b.add_body("bob", j, "cuboid", size=(0.1, 0.1, 0.1), pos=(0, 0, -0.5),
               density=1000.0)
    b.add_motor(j, ctrl="force", ctrl_range=(-100.0, 100.0))
    return b.build()


def falling_box(timestep=5e-3, kn=1e4, kt=10.0, mu=0.5, damping=10.0):
    """Free cuboid over the ground plane: contact oracle."""
    b = SceneBuilder("falling_box", timestep=timestep, ground=(0, 0, 0))
    j = b.add_joint("free", "free3d-exp", pos=(0, 0, 0.2))
    body = b.add_body("box", j, "cuboid", size=(0.1, 0.1, 0.1), density=500.0,
                      contact_resolution=(2, 2, 2))
    b.add_ground_contact(body, kn=kn, kt=kt, mu=mu, damping=damping)
    return b.build()


# canonical reference scene paths (read-only assets; the framework itself is
# standalone — these are used by parity tests and the bundled examples)
REFERENCE_SCENES = {
    "tactile_push": "envs/assets/pusher/pusher.xml",
    "stable_grasp": "envs/assets/stable_grasp/stable_grasp.xml",
    "tactile_insertion": "envs/assets/tactile_insertion/tactile_insertion.xml",
    "dclaw_position": "envs/assets/dclaw_rotate/dclaw_position_control.xml",
    "dclaw_torque": "envs/assets/dclaw_rotate/dclaw_torque_control.xml",
    "rolling_ball": "assets/tactile_pad/tactile_pad.xml",
}
