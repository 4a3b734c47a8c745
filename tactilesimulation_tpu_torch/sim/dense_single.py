"""Single-instance contact in the points-major (3, N) layout: the dense
marker-field path (the 40,000-marker RollingBall pad).

Port of ``tactilesimulation_tpu/sim/dense_single.py``. The same contact
semantics as ``dynamics.contact_terms``, with the points in the LAST axis,
through the lane-major helpers of ``lanes.py`` at one lane and the segment
tables of ``ops/lane_contact.build_segments`` (host tables, not K1): per
segment the points' world positions and velocities come from their owner
joint's frame and twist (``dynamics.dof_frames`` / ``joint_twists``), the
force law runs over (3, n) arrays, and the
forces reduce to per-joint wrenches, which ``lanes.wrench_to_Q`` maps to
generalized forces. The primitive side's application point is held fixed
in the primitive's frame (its local coordinates detached).

Used by ``integrators.build_step(..., points_major=True)``, which
``Simulator`` picks for scenes with 2,048 points or more.
"""

from __future__ import annotations

import types

import torch

from . import contact, dynamics, kinematics, lanes, spatial
from ..ops import lane_contact
from .types import Model, Structure

_TABLES = {}


def _tables(struct: Structure, device):
    """Segments, the gathered point order and the tactile rows of each
    segment on ``device`` (made once per scene and device)."""
    key = (id(struct), device)
    hit = _TABLES.get(key)
    if hit is not None and hit[0] is struct:
        return hit[1]
    segments, _, src_idx, _ = lane_contact.build_segments(struct)
    t = types.SimpleNamespace(segments=segments)
    t.src_idx = torch.as_tensor(src_idx, device=device)
    t.tac_rows = [torch.arange(s.tac0, s.tac0 + s.n, device=device)
                  if s.tac0 >= 0 else None for s in segments]
    t.sphere = [(g, i) for i, g in enumerate(struct.contact_groups)
                if g.sphere_general]
    _TABLES[key] = (struct, t)
    return t


def contact_terms_points_major(struct: Structure, model: Model, q, v,
                               tactile=True):
    """(Q (n,), tac_force_world (ntac, 3)); the tactile forces are skipped
    (an empty (0, 3)) when ``tactile`` is False, as in the residual."""
    ntac = len(struct.tac_joint)
    groups = struct.contact_groups
    if not groups:
        return torch.zeros_like(q), q.new_zeros((ntac if tactile else 0, 3))
    tb = _tables(struct, q.device)

    jp, jq, w, c, rot_mask = dynamics.dof_frames(struct, model, q)
    Om, be = dynamics.joint_twists(struct, w, c, rot_mask, v)
    bj = kinematics._tables(struct, q).body_joint
    bp, bquat = spatial.transform_compose(jp[bj], jq[bj], model.body_pos,
                                          model.body_quat)
    # one lane of the lane-major helpers: (C, J|NB|n, 1)
    jp, jq, bp, bquat, w, c, Omega, beta = (
        a.T[:, :, None] for a in (jp, jq, bp, bquat, w, c, Om, be))
    J = struct.njoints
    params = contact.combined_params(model)
    xi_sel = lane_contact.pack_points(struct, model, tb.src_idx)

    F_cols = [q.new_zeros(3)] * J
    T_cols = [q.new_zeros(3)] * J
    tac = q.new_zeros((3, max(ntac, 1))) if tactile else None

    offset = 0
    for s, rows in zip(tb.segments, tb.tac_rows):
        xi = xi_sel[offset:offset + s.n].T            # (3, n) points in lanes
        offset += s.n
        j = s.joint
        x = jp[:, j] + lanes.quat_rotate(jq[:, j], xi)          # (3, n)
        v_pt = lanes.cross(Omega[:, j], x) + beta[:, j]
        if s.gtype == contact.GROUND:
            gn = model.ground_normal[:, None]
            gp = model.ground_pos[:, None]
            phi = torch.sum((x - gp) * gn, dim=0)
            nrm = gn.expand(x.shape)
            v_rel = v_pt
        else:
            pb = s.prim_body
            bR = lanes.quat_to_mat(bquat[:, pb])      # (3, 3, 1)
            xl = lanes.mat_tvec(bR, x - bp[:, pb])
            size = model.body_size[pb][:, None]
            if s.gtype == contact.GEOM_CUBOID:
                phi, gl = lanes._sdf_box(xl, size / 2.0)
            elif s.gtype == contact.GEOM_CYLINDER:
                phi, gl = lanes._sdf_cylinder(xl, size[0], size[1])
            elif s.gtype == contact.GEOM_SPHERE:
                phi, gl = lanes._sdf_sphere(xl, size[0])
            else:
                raise ValueError(s.gtype)
            nrm = lanes.mat_vec(bR, gl)
            v_prim = lanes.cross(Omega[:, s.prim_joint], x) \
                + beta[:, s.prim_joint]
            v_rel = v_pt - v_prim
        f = lanes._penalty_force(phi, nrm, v_rel, params[s.param_row][:, None])

        fs = torch.sum(f, dim=1)
        F_cols[j] = F_cols[j] + fs
        T_cols[j] = T_cols[j] + torch.sum(lanes.cross(x, f), dim=1)
        if s.gtype != contact.GROUND:
            pb = s.prim_body
            qp = bquat[:, pb]
            xi_p = lanes.quat_rotate(lanes.quat_conj(qp),
                                     x - bp[:, pb]).detach()
            x_app_p = bp[:, pb] + lanes.quat_rotate(qp, xi_p)
            F_cols[s.prim_joint] = F_cols[s.prim_joint] - fs
            T_cols[s.prim_joint] = T_cols[s.prim_joint] - torch.sum(
                lanes.cross(x_app_p, f), dim=1)
        if tactile and rows is not None:
            tac = tac.index_add(1, rows, f)

    F = torch.stack(F_cols, dim=1)[:, :, None]        # (3, J, 1)
    Tau = torch.stack(T_cols, dim=1)[:, :, None]
    # sphere_general groups (analytic sphere centers: a handful of points)
    if tb.sphere:
        ltab = lanes._tables(struct, q[:, None])
        bR_all = lanes.quat_to_mat(bquat)
        for g, gi in tb.sphere:
            F, Tau = lanes._sphere_group_wrenches(
                struct, model, g, ltab.groups[gi], bp, bquat, bR_all, Omega,
                beta, params, F, Tau)

    Q = lanes.wrench_to_Q(struct, w, c, rot_mask, F, Tau)[:, 0]
    if not tactile:
        return Q, q.new_zeros((0, 3))
    return Q, (tac[:, :ntac].T if ntac else q.new_zeros((0, 3)))


def tactile_field_points_major(struct: Structure, model: Model, q, v):
    """(Mtot, 3) sensor-frame [shear0, shear1, normal] marker forces, the
    points-major counterpart of ``dynamics.tactile_field``."""
    _, tac_force = contact_terms_points_major(struct, model, q, v)
    return dynamics.tactile_field_from_forces(struct, model, q, tac_force)


def applied_forces_points_major(struct: Structure, model: Model, q, v, u,
                                tactile=True):
    Q_contact, tac_force = contact_terms_points_major(struct, model, q, v,
                                                      tactile)
    Q = (dynamics.joint_spring_forces(model, q, v)
         + dynamics.motor_forces(struct, model, q, v, u)
         + Q_contact)
    return Q, tac_force
