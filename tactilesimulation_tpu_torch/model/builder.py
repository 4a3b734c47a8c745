"""SceneSpec -> (Structure, Model) compiler (host-side numpy -> torch leaves).

Port of ``tactilesimulation_tpu/model/builder.py`` (``build``):
- flatten the joint tree into parent-pointer arrays with document-order dof
  layout,
- compute primitive mass/inertia from density (cuboid/cylinder/sphere),
- generate contact point clouds (cuboid lattice, cylinder faces, explicit
  files) and re-express all point sets in their owning joint's frame,
- resolve OBJ_TO_WORLD body transforms against the zero-configuration FK,
- assemble contact pair / tactile pair tables.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..sim import contact as _contact
from ..sim import kinematics as _kin
from ..sim.types import Model, PairInfo, SensorInfo, Structure
from . import assets
from .schema import (
    CTRL_POSITION,
    GEOM_ABSTRACT,
    GEOM_CUBOID,
    GEOM_CYLINDER,
    GEOM_MESH,
    GEOM_SPHERE,
    JOINT_NDOF,
    SceneSpec,
)


def _np_quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _np_quat_rot(q, v):
    w = q[0]
    u = q[1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _np_quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _zero_config_joint_frames(spec: SceneSpec):
    """World pose of every joint frame at q = 0 (for OBJ_TO_WORLD resolution)."""
    ps, qs = [], []
    for j in spec.joints:
        if j.parent < 0:
            pp, pq = np.zeros(3), np.array([1.0, 0, 0, 0])
        else:
            pp, pq = ps[j.parent], qs[j.parent]
        ps.append(pp + _np_quat_rot(pq, j.pos))
        qs.append(_np_quat_mul(pq, j.quat))
    return ps, qs


def _primitive_mass_inertia(body):
    """Analytic (mass, diag inertia about COM) from density.

    The reference derives these inside the C++ core; cuboid ``size`` is full
    extents (pusher.xml:44: a 0.05 cube whose joint sits at z=0.025 rests on
    the ground), cylinder axis is local z.
    """
    rho = body.density
    if body.gtype == GEOM_CUBOID or body.gtype == GEOM_MESH:
        ex, ey, ez = body.size
        m = rho * ex * ey * ez
        I = m / 12.0 * np.array([ey**2 + ez**2, ex**2 + ez**2, ex**2 + ey**2])
    elif body.gtype == GEOM_CYLINDER:
        r, hl = body.size[0], body.size[1]
        m = rho * np.pi * r * r * (2 * hl)
        Iz = 0.5 * m * r * r
        Ix = m * (3 * r * r + (2 * hl) ** 2) / 12.0
        I = np.array([Ix, Ix, Iz])
    elif body.gtype == GEOM_SPHERE:
        r = body.size[0]
        m = rho * 4.0 / 3.0 * np.pi * r**3
        I = np.full(3, 0.4 * m * r * r)
    elif body.gtype == GEOM_ABSTRACT:
        return float(body.mass), np.asarray(body.inertia, dtype=np.float64)
    else:
        raise ValueError(body.gtype)
    return float(m), I


def _body_contact_points(body) -> Optional[np.ndarray]:
    """Contact point cloud in the body's own frame (or joint frame for
    abstract bodies — flagged on the spec)."""
    if body.contact_points is not None:
        return body.contact_points
    if body.gtype == GEOM_CUBOID and body.contact_resolution is not None:
        return assets.cuboid_surface_points(body.size, body.contact_resolution)
    if body.gtype == GEOM_CYLINDER and body.contact_angle_resolution is not None:
        return assets.cylinder_face_points(
            body.size[0], body.size[1],
            body.contact_angle_resolution, body.contact_radius_resolution)
    return None


def build(spec: SceneSpec, dtype=torch.float64,
          device="cpu") -> Tuple[Structure, Model]:
    """Compile ``spec``; every ``Model`` leaf is a ``dtype`` tensor on
    ``device`` (float64 on the CPU by default, as the JAX builder under x64)."""
    f = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                  dtype=dtype, device=device)

    ndof = spec.ndof_q
    dof_offsets, off = [], 0
    for j in spec.joints:
        dof_offsets.append(off)
        off += JOINT_NDOF[j.jtype]

    # per-dof joint quantities
    dof_damping = np.zeros(ndof)
    lim_lo = np.full(ndof, -1e9)
    lim_hi = np.full(ndof, 1e9)
    lim_k = np.zeros(ndof)
    for ji, j in enumerate(spec.joints):
        nd = JOINT_NDOF[j.jtype]
        sl = slice(dof_offsets[ji], dof_offsets[ji] + nd)
        dof_damping[sl] = j.damping
        if j.lim is not None and nd >= 1:
            # limits apply to scalar joints (revolute/prismatic), matching the
            # reference scenes which only set `lim` on 1-dof joints
            lim_lo[dof_offsets[ji]] = j.lim[0]
            lim_hi[dof_offsets[ji]] = j.lim[1]
            lim_k[sl] = j.lim_stiffness

    # bodies: masses, OBJ_TO_WORLD resolution
    jw_p, jw_q = _zero_config_joint_frames(spec)
    body_pos = np.zeros((len(spec.bodies), 3))
    body_quat = np.zeros((len(spec.bodies), 4))
    body_mass = np.zeros(len(spec.bodies))
    body_inertia = np.zeros((len(spec.bodies), 3))
    body_size = np.zeros((len(spec.bodies), 3))
    body_rgba = np.zeros((len(spec.bodies), 4))
    for bi, b in enumerate(spec.bodies):
        m, I = _primitive_mass_inertia(b)
        body_mass[bi] = m
        body_inertia[bi] = I
        body_size[bi] = b.size
        body_rgba[bi] = b.rgba
        if b.pos_is_world:
            # body pose given in world coords at the zero configuration
            # (reference transform_type="OBJ_TO_WORLD", pusher.xml:24)
            pq, qq = jw_p[b.joint], jw_q[b.joint]
            inv_q = _np_quat_conj(qq)
            body_pos[bi] = _np_quat_rot(inv_q, b.pos - pq)
            body_quat[bi] = _np_quat_mul(inv_q, b.quat)
        else:
            body_pos[bi] = b.pos
            body_quat[bi] = b.quat

    # contact point sets, re-expressed in the owning joint frame
    point_arrays, point_joint, body_point_slice = [], [], {}
    total = 0
    for bi, b in enumerate(spec.bodies):
        pts = _body_contact_points(b)
        if pts is None:
            continue
        if not b.contact_points_in_joint_frame:
            R_bq = _quatmat(body_quat[bi])
            pts = pts @ R_bq.T + body_pos[bi]
        point_arrays.append(pts)
        point_joint.extend([b.joint] * len(pts))
        body_point_slice[bi] = (total, len(pts))
        total += len(pts)
    cp_pos = np.concatenate(point_arrays, axis=0) if point_arrays else np.zeros((0, 3))

    # contact pair table
    pairs = []
    pair_params = []
    for k, c in enumerate(spec.contacts):
        gb = spec.bodies[c.general_body]
        if gb.gtype == GEOM_SPHERE:
            start, count, is_sphere = 0, 0, True
        else:
            if c.general_body not in body_point_slice:
                raise ValueError(
                    f"contact pair declares general body {gb.name!r} without "
                    "contact points (no resolution attrs / collision file)")
            (start, count), is_sphere = body_point_slice[c.general_body], False
        pairs.append(PairInfo(
            general_body=c.general_body, primitive_body=c.primitive_body,
            point_start=start, point_count=count,
            general_is_sphere=is_sphere, param_index=k))
        pair_params.append([c.kn, c.kt, c.mu, c.damping])
    pair_params = np.asarray(pair_params) if pair_params else np.zeros((0, 4))

    # tactile sensors: markers in joint frame + sensor-vs-primitive pairs
    tac_arrays = {k: [] for k in ("pos", "normal", "axis0", "axis1")}
    tac_joint, sensors, tactile_pairs, tac_params = [], [], [], []
    mtot = 0
    for si, t in enumerate(spec.tactiles):
        b = spec.bodies[t.body]
        pos, nrm, a0, a1 = t.pos, t.normal, t.axis0, t.axis1
        if not t.in_joint_frame:
            R_bq = _quatmat(body_quat[t.body])
            pos = pos @ R_bq.T + body_pos[t.body]
            nrm, a0, a1 = nrm @ R_bq.T, a0 @ R_bq.T, a1 @ R_bq.T
        m = len(pos)
        tac_arrays["pos"].append(pos)
        tac_arrays["normal"].append(nrm)
        tac_arrays["axis0"].append(a0)
        tac_arrays["axis1"].append(a1)
        tac_joint.extend([b.joint] * m)
        sensors.append(SensorInfo(
            name=t.name, body=t.body, marker_start=mtot, marker_count=m,
            rows=t.rows, cols=t.cols, image_pos=t.image_pos))
        tac_params.append([t.kn, t.kt, t.mu, t.damping])
        # markers feel every primitive their body has a declared contact with
        # (reference C6: marker forces = per-tactile-point penalty contacts)
        for c in spec.contacts:
            if c.general_body == t.body:
                tactile_pairs.append(PairInfo(
                    general_body=t.body, primitive_body=c.primitive_body,
                    point_start=mtot, point_count=m, general_is_sphere=False,
                    param_index=si, sensor_index=si))
        mtot += m
    tac_params = np.asarray(tac_params) if tac_params else np.zeros((0, 4))
    cat = lambda key: (np.concatenate(tac_arrays[key], axis=0)
                       if tac_arrays[key] else np.zeros((0, 3)))

    # motors -> per-actuated-dof arrays, document order (pusher u-layout:
    # [planar x, planar y, revolute, box x, box y, box z])
    motor_dof, mkp, mkd, mlo, mhi, mpos = [], [], [], [], [], []
    for mt in spec.motors:
        ji = mt.joint
        for d in range(JOINT_NDOF[spec.joints[ji].jtype]):
            motor_dof.append(dof_offsets[ji] + d)
            mkp.append(mt.P)
            mkd.append(mt.D)
            mlo.append(mt.ctrl_range[0])
            mhi.append(mt.ctrl_range[1])
            mpos.append(1.0 if mt.ctrl == CTRL_POSITION else 0.0)

    structure_kwargs = dict(
        name=spec.name,
        integrator=spec.integrator,
        njoints=len(spec.joints),
        nbodies=len(spec.bodies),
        ndof_q=ndof,
        ndof_u=len(motor_dof),
        ndof_var=spec.ndof_var,
        ndof_tactile=3 * mtot,
        joint_types=tuple(j.jtype for j in spec.joints),
        joint_parents=tuple(j.parent for j in spec.joints),
        joint_dof_offset=tuple(dof_offsets),
        joint_ndof=tuple(JOINT_NDOF[j.jtype] for j in spec.joints),
        joint_names=tuple(j.name for j in spec.joints),
        body_joint=tuple(b.joint for b in spec.bodies),
        body_gtype=tuple(b.gtype for b in spec.bodies),
        body_names=tuple(b.name for b in spec.bodies),
        motor_dof=tuple(motor_dof),
        cp_joint=tuple(point_joint),
        pairs=tuple(pairs),
        tac_joint=tuple(tac_joint),
        tactile_pairs=tuple(tactile_pairs),
        sensors=tuple(sensors),
        ee_joint=tuple(e.joint for e in spec.endeffectors),
        ee_names=tuple(e.name for e in spec.endeffectors),
        virtual_names=tuple(v.name for v in spec.virtuals),
        has_ground=spec.ground_pos is not None,
        solver_tol=spec.solver_tol,
        solver_max_iter=spec.solver_max_iter,
        solver_max_ls=spec.solver_max_ls,
    )
    fk_tables = _kin.build_fk_tables(
        structure_kwargs["joint_types"], structure_kwargs["joint_parents"],
        structure_kwargs["joint_dof_offset"],
        np.stack([j.axis0 for j in spec.joints]),
        np.stack([j.axis1 for j in spec.joints]))
    structure = Structure(contact_groups=(), fk_tables=fk_tables,
                          **structure_kwargs)
    structure = Structure(contact_groups=_contact.build_groups(structure),
                          fk_tables=fk_tables, **structure_kwargs)

    model = Model(
        h=f(spec.timestep),
        gravity=f(spec.gravity),
        joint_pos=f(np.stack([j.pos for j in spec.joints])),
        joint_quat=f(np.stack([j.quat for j in spec.joints])),
        joint_axis0=f(np.stack([j.axis0 for j in spec.joints])),
        joint_axis1=f(np.stack([j.axis1 for j in spec.joints])),
        dof_damping=f(dof_damping),
        dof_lim_lower=f(lim_lo),
        dof_lim_upper=f(lim_hi),
        dof_lim_stiffness=f(lim_k),
        q_init=f(np.zeros(ndof)),
        qdot_init=f(np.zeros(ndof)),
        body_pos=f(body_pos),
        body_quat=f(body_quat),
        body_mass=f(body_mass),
        body_inertia=f(body_inertia),
        body_size=f(body_size),
        body_rgba=f(body_rgba),
        motor_kp=f(mkp),
        motor_kd=f(mkd),
        motor_ctrl_lo=f(np.asarray(mlo)),
        motor_ctrl_hi=f(np.asarray(mhi)),
        motor_pos_mask=f(mpos),
        cp_pos=f(cp_pos),
        pair_kn=f(pair_params[:, 0]),
        pair_kt=f(pair_params[:, 1]),
        pair_mu=f(pair_params[:, 2]),
        pair_damping=f(pair_params[:, 3]),
        ground_pos=f(spec.ground_pos if spec.ground_pos is not None else np.zeros(3)),
        ground_normal=f(spec.ground_normal if spec.ground_normal is not None
                        else np.array([0.0, 0.0, 1.0])),
        tac_pos=f(cat("pos")),
        tac_normal=f(cat("normal")),
        tac_axis0=f(cat("axis0")),
        tac_axis1=f(cat("axis1")),
        tac_kn=f(tac_params[:, 0]),
        tac_kt=f(tac_params[:, 1]),
        tac_mu=f(tac_params[:, 2]),
        tac_damping=f(tac_params[:, 3]),
        ee_pos=f(np.stack([e.pos for e in spec.endeffectors])
                 if spec.endeffectors else np.zeros((0, 3))),
        virtual_pos=f(np.stack([v.pos for v in spec.virtuals])
                      if spec.virtuals else np.zeros((0, 3))),
        virtual_quat=f(np.stack([v.quat for v in spec.virtuals])
                       if spec.virtuals else np.zeros((0, 4))),
    )
    return structure, model


def _quatmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def update_body_density(spec_body_gtype, model: Model, body_index: int,
                        density: float) -> Model:
    """The reference's ``update_body_density``: body ``body_index``'s mass
    becomes its volume (from the current size leaf) times ``density``, and
    its inertia scales by the same ratio. New leaves, the old untouched."""
    old_m = model.body_mass[body_index]
    new_m = _unit(model, body_index, spec_body_gtype) * density
    ratio = new_m / torch.clamp(old_m, min=1e-30)
    mass = model.body_mass.detach().clone()
    mass[body_index] = new_m
    inertia = model.body_inertia.detach().clone()
    inertia[body_index] = inertia[body_index] * ratio
    return dataclasses.replace(model, body_mass=mass, body_inertia=inertia)


def _unit(model: Model, bi: int, gtype: int):
    """Volume of body bi from its current size leaf."""
    s = model.body_size[bi]
    if gtype == GEOM_CYLINDER:
        return np.pi * s[0] ** 2 * (2 * s[1])
    if gtype == GEOM_SPHERE:
        return 4.0 / 3.0 * np.pi * s[0] ** 3
    return s[0] * s[1] * s[2]
