"""redmax XML front end: scene file -> SceneSpec (host-side numpy).

Port of ``tactilesimulation_tpu/model/xml_parser.py`` (the same
``parse_scene``, on the port's copies of ``schema.py`` and ``assets.py``).
It accepts the reference scene schema end to end, so existing redmax assets
load unchanged: a ``<redmax>`` root with ``<option>``, ``<solver_option>``,
``<ground>``, ``<default>``, nested ``<robot>/<link>/<joint>+<body>`` trees,
``<contact>``, ``<actuator>``, ``<sensor>``, ``<variable>``, ``<virtual>``.
xml.etree and numpy only; ``builder.build`` turns the spec into tensors.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from . import assets
from .schema import (
    CTRL_FORCE,
    CTRL_POSITION,
    GEOM_ABSTRACT,
    GEOM_CUBOID,
    GEOM_CYLINDER,
    GEOM_MESH,
    GEOM_SPHERE,
    JOINT_TYPE_NAMES,
    BodySpec,
    ContactPairSpec,
    EndEffectorSpec,
    JointSpec,
    MotorSpec,
    SceneSpec,
    TactileSpec,
    VirtualObjectSpec,
)

_IDENT_QUAT = np.array([1.0, 0.0, 0.0, 0.0])


def _vec(s: Optional[str], default=None, n=3):
    if s is None:
        return None if default is None else np.asarray(default, dtype=np.float64)
    v = np.array([float(x) for x in s.split()], dtype=np.float64)
    assert v.shape[0] == n or n is None, f"expected {n} floats, got {s!r}"
    return v


def _quat(s: Optional[str]):
    if s is None:
        return _IDENT_QUAT.copy()
    q = _vec(s, n=4)
    nrm = np.linalg.norm(q)
    return q / nrm if nrm > 0 else _IDENT_QUAT.copy()


def _f(s, default):
    return default if s is None else float(s)


class _Defaults:
    """<default> block: per-tag attribute fallbacks (reference pusher.xml:8-13)."""

    def __init__(self, root):
        self.by_tag = {}
        for dflt in root.findall("default"):
            for child in dflt:
                self.by_tag.setdefault(child.tag, {}).update(child.attrib)

    def get(self, tag, elem, attr, fallback=None):
        if elem is not None and attr in elem.attrib:
            return elem.attrib[attr]
        return self.by_tag.get(tag, {}).get(attr, fallback)


def parse_scene(path: str, mesh_fallback_extent: float = 0.04) -> SceneSpec:
    """Parse a redmax model XML file into a SceneSpec.

    ``mesh_fallback_extent``: the reference computes mesh-body mass from the
    OBJ volume; the meshes are visual-only for physics here (no collision on
    mesh bodies in any reference scene) and absent from the checkout, so mesh
    bodies get a cube of this extent for their inertia model.
    """
    tree = ET.parse(path)
    root = tree.getroot()
    assert root.tag == "redmax", f"{path}: root must be <redmax>"
    base_dir = os.path.dirname(os.path.abspath(path))
    dflt = _Defaults(root)

    opt = root.find("option")
    spec = SceneSpec(name=root.get("model", os.path.basename(path)))
    if opt is not None:
        spec.integrator = opt.get("integrator", "BDF1")
        spec.timestep = _f(opt.get("timestep"), 5e-3)
        spec.gravity = _vec(opt.get("gravity"), default=[0.0, 0.0, -9.8])

    sopt = root.find("solver_option")
    if sopt is not None:
        spec.solver_tol = _f(sopt.get("tol"), 1e-9)
        # the reference allows up to 100 Newton iters with 20 line-search steps
        # (pusher.xml:4); the solvers run a fixed masked iteration count, so
        # cap at a static budget that converges in practice (integrators.py),
        # the JAX parser's caps
        spec.solver_max_iter = min(int(_f(sopt.get("max_iter"), 10)), 10)
        spec.solver_max_ls = min(int(_f(sopt.get("max_ls"), 4)), 6)

    ground = root.find("ground")
    if ground is not None:
        spec.ground_pos = _vec(ground.get("pos"), default=[0.0, 0.0, 0.0])
        n = _vec(ground.get("normal"), default=[0.0, 0.0, 1.0])
        spec.ground_normal = n / np.linalg.norm(n)

    # ---- robot trees ------------------------------------------------------
    for robot in root.findall("robot"):
        for link in robot.findall("link"):
            _parse_link(spec, link, parent=-1, dflt=dflt, base_dir=base_dir,
                        mesh_fallback_extent=mesh_fallback_extent)

    # ---- contacts ---------------------------------------------------------
    contact_root = root.find("contact")
    if contact_root is not None:
        for el in contact_root:
            if el.tag == "ground_contact":
                spec.contacts.append(ContactPairSpec(
                    general_body=spec.body_index(el.get("body")),
                    primitive_body=-1,
                    kn=float(dflt.get("general_primitive_contact", el, "kn", "1e3")),
                    kt=float(dflt.get("general_primitive_contact", el, "kt", "1.")),
                    mu=float(dflt.get("general_primitive_contact", el, "mu", "0.8")),
                    damping=float(dflt.get("general_primitive_contact", el, "damping", "0.")),
                ))
            elif el.tag == "general_primitive_contact":
                spec.contacts.append(ContactPairSpec(
                    general_body=spec.body_index(el.get("general_body")),
                    primitive_body=spec.body_index(el.get("primitive_body")),
                    kn=float(dflt.get("general_primitive_contact", el, "kn", "1e3")),
                    kt=float(dflt.get("general_primitive_contact", el, "kt", "1.")),
                    mu=float(dflt.get("general_primitive_contact", el, "mu", "0.8")),
                    damping=float(dflt.get("general_primitive_contact", el, "damping", "0.")),
                    render=dflt.get("general_primitive_contact", el, "render", "false")
                    in ("true", "True", "1"),
                ))

    # ---- actuators --------------------------------------------------------
    act_root = root.find("actuator")
    if act_root is not None:
        for el in act_root.findall("motor"):
            rng = dflt.get("motor", el, "ctrl_range")
            ctrl_range = tuple(_vec(rng, n=2)) if rng else (-np.inf, np.inf)
            spec.motors.append(MotorSpec(
                joint=spec.joint_index(el.get("joint")),
                ctrl=CTRL_POSITION if el.get("ctrl", "force") == "position" else CTRL_FORCE,
                P=float(dflt.get("motor", el, "P", "0.")),
                D=float(dflt.get("motor", el, "D", "0.")),
                ctrl_range=ctrl_range,
            ))

    # ---- tactile sensors --------------------------------------------------
    sensor_root = root.find("sensor")
    if sensor_root is not None:
        for el in sensor_root.findall("tactile"):
            body = spec.body_index(el.get("body"))
            name = el.get("name")
            kn = float(dflt.get("tactile", el, "kn", "1e2"))
            kt = float(dflt.get("tactile", el, "kt", "1."))
            mu = float(dflt.get("tactile", el, "mu", "1."))
            damping = float(dflt.get("tactile", el, "damping", "0."))
            render = dflt.get("tactile", el, "render", "false") in ("true", "True", "1")
            if el.get("type") == "rect_array":
                rows, cols = (int(x) for x in el.get("resolution").split())
                mk = assets.rect_array_markers(
                    _vec(el.get("rect_pos0")), _vec(el.get("rect_pos1")),
                    _vec(el.get("axis0")), _vec(el.get("axis1")), rows, cols)
            elif el.get("type") == "abstract":
                mk = assets.load_tactile_spec(os.path.join(base_dir, el.get("spec")))
                # sensor pos/quat maps MESH-space spec coords into the BODY
                # frame (reference dclaw_position_control.xml:121-123);
                # compose with the owning body's pos/quat for joint-frame
                # markers (body∘sensor == identity in the reference assets —
                # see the matching note on <collision> parsing below).
                bd = spec.bodies[body]
                p = _vec(el.get("pos"), default=[0.0, 0.0, 0.0])
                q = _quat(el.get("quat"))
                R = _quat_to_mat_np(bd.quat) @ _quat_to_mat_np(q)
                off = bd.pos + _quat_to_mat_np(bd.quat) @ p
                mk = dict(mk)
                mk["pos"] = mk["pos"] @ R.T + off
                for k in ("normal", "axis0", "axis1"):
                    mk[k] = mk[k] @ R.T
                rows = int(mk["image_pos"][:, 0].max()) + 1
                cols = int(mk["image_pos"][:, 1].max()) + 1
            else:
                raise ValueError(f"unknown tactile type {el.get('type')!r}")
            spec.tactiles.append(TactileSpec(
                name=name, body=body, rows=rows, cols=cols,
                pos=mk["pos"], normal=mk["normal"], axis0=mk["axis0"],
                axis1=mk["axis1"], image_pos=mk["image_pos"],
                kn=kn, kt=kt, mu=mu, damping=damping, render=render,
                in_joint_frame=el.get("type") == "abstract",
            ))

    # ---- variables / virtual objects -------------------------------------
    var_root = root.find("variable")
    if var_root is not None:
        for el in var_root.findall("endeffector"):
            spec.endeffectors.append(EndEffectorSpec(
                name=el.get("name", el.get("joint")),
                joint=spec.joint_index(el.get("joint")),
                pos=_vec(el.get("pos"), default=[0.0, 0.0, 0.0]),
                radius=_f(el.get("radius"), 0.003),
            ))
    virt_root = root.find("virtual")
    if virt_root is not None:
        for el in virt_root:
            spec.virtuals.append(VirtualObjectSpec(
                name=el.get("name"),
                pos=_vec(el.get("pos"), default=[0.0, 0.0, 0.0]),
                quat=_quat(el.get("quat")),
                size=_vec(el.get("size"), default=[0.1, 0.1, 0.1]),
                texture=el.get("texture", ""),
            ))
    return spec


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _parse_link(spec, link_el, parent, dflt, base_dir, mesh_fallback_extent):
    joint_el = link_el.find("joint")
    body_el = link_el.find("body")
    jtype = JOINT_TYPE_NAMES[joint_el.get("type")]
    lim_s = joint_el.get("lim")
    joint = JointSpec(
        name=joint_el.get("name"),
        jtype=jtype,
        parent=parent,
        pos=_vec(joint_el.get("pos"), default=[0.0, 0.0, 0.0]),
        quat=_quat(joint_el.get("quat")),
        axis0=_vec(joint_el.get("axis0") or joint_el.get("axis"), default=[1.0, 0.0, 0.0]),
        axis1=_vec(joint_el.get("axis1"), default=[0.0, 1.0, 0.0]),
        damping=float(dflt.get("joint", joint_el, "damping", "0.")),
        lim=tuple(_vec(lim_s, n=2)) if lim_s else None,
        lim_stiffness=float(dflt.get("joint", joint_el, "lim_stiffness", "0.")),
    )
    # normalize axes
    for ax in ("axis0", "axis1"):
        v = getattr(joint, ax)
        nrm = np.linalg.norm(v)
        if nrm > 0:
            setattr(joint, ax, v / nrm)
    spec.joints.append(joint)
    jidx = len(spec.joints) - 1

    if body_el is not None:
        _parse_body(spec, body_el, jidx, dflt, base_dir, mesh_fallback_extent)

    for child in link_el.findall("link"):
        _parse_link(spec, child, jidx, dflt, base_dir, mesh_fallback_extent)


def _parse_body(spec, el, joint_idx, dflt, base_dir, mesh_fallback_extent):
    btype = el.get("type")
    pos = _vec(el.get("pos"), default=[0.0, 0.0, 0.0])
    quat = _quat(el.get("quat"))
    density = _f(el.get("density"), 1000.0)
    rgba = _vec(el.get("rgba"), default=[0.5, 0.5, 0.5, 1.0], n=4)
    body = BodySpec(
        name=el.get("name"), joint=joint_idx, gtype=GEOM_CUBOID, pos=pos,
        quat=quat, size=np.array([0.1, 0.1, 0.1]), density=density, rgba=rgba,
        texture=el.get("texture", ""),
    )
    if btype == "cuboid":
        body.gtype = GEOM_CUBOID
        body.size = _vec(el.get("size"))  # full extents (pusher.xml:44 box on ground)
        res = el.get("general_contact_resolution")
        if res:
            body.contact_resolution = tuple(int(x) for x in res.split())
    elif btype == "cylinder":
        body.gtype = GEOM_CYLINDER
        body.size = np.array([_f(el.get("radius"), 0.01), _f(el.get("length"), 0.01) / 2.0, 0.0])
        if el.get("general_contact_angle_resolution"):
            body.contact_angle_resolution = int(el.get("general_contact_angle_resolution"))
            body.contact_radius_resolution = int(el.get("general_contact_radius_resolution", "2"))
    elif btype == "sphere":
        body.gtype = GEOM_SPHERE
        body.size = np.array([_f(el.get("radius"), 0.01), 0.0, 0.0])
    elif btype == "mesh":
        body.gtype = GEOM_MESH
        body.size = np.full(3, mesh_fallback_extent)
        body.pos_is_world = el.get("transform_type", "OBJ_TO_JOINT") == "OBJ_TO_WORLD"
    elif btype == "abstract":
        body.gtype = GEOM_ABSTRACT
        body.size = np.full(3, mesh_fallback_extent)
        body.mass = _f(el.get("mass"), 0.1)
        body.inertia = _vec(el.get("inertia"))
        coll = el.find("collision")
        if coll is not None:
            pts = assets.load_contact_points(os.path.join(base_dir, coll.get("contacts")))
            p = _vec(coll.get("pos"), default=[0.0, 0.0, 0.0])
            q = _quat(coll.get("quat"))
            # the collision pos/quat maps MESH space into the BODY frame;
            # composing with the body's own pos/quat gives joint-frame points.
            # (In dclaw_position_control.xml the composition body∘collision is
            # exactly identity — the OBJ/contact coordinates are authored in
            # the joint frame — verified numerically; treating the collision
            # transform as mesh->joint instead puts the fingertip point cloud
            # ~4 cm off, behind the joint.)
            pts_body = pts @ _quat_to_mat_np(q).T + p
            body.contact_points = (
                pts_body @ _quat_to_mat_np(body.quat).T + body.pos)
            body.contact_points_in_joint_frame = True
    else:
        raise ValueError(f"unknown body type {btype!r}")
    spec.bodies.append(body)
