"""Single-instance contact in the points-major layout: the dense
marker-field path (the 40,000-marker RollingBall pad), for one instance or
a batch of them.

Port of ``tactilesimulation_tpu/sim/dense_single.py``. The same contact
semantics as ``dynamics.contact_terms``, with the points in the LAST axis:
arrays are (component, batch..., points), so the lane-major helpers of
``lanes.py`` (component first) run over them as they are. The segment
tables of ``ops/lane_contact.build_segments`` (host tables, not K1) group
the points: per segment the points' world positions and velocities come
from their owner joint's frame and twist (``dynamics.dof_frames`` /
``joint_twists``), the force law runs over (3, ..., n) arrays, and the
forces reduce to per-joint wrenches, which ``lanes.wrench_to_Q`` maps to
generalized forces. The primitive side's application point is held fixed
in the primitive's frame (its local coordinates detached). Sums run over
the points axis only, never over the batch.

Used by ``integrators.build_step(..., points_major=True)``, which
``Simulator`` picks for scenes with 2,048 points or more.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from . import contact, dynamics, kinematics, lanes, spatial
from ..ops import lane_contact
from .types import Model, Structure

_TABLES = {}


def _tables(struct: Structure, device):
    """Segments, the gathered point order, the tactile rows of each segment
    and the sphere-centre groups' index tables on ``device`` (made once per
    scene and device)."""
    key = (id(struct), device)
    hit = _TABLES.get(key)
    if hit is not None and hit[0] is struct:
        return hit[1]
    segments, _, src_idx, _ = lane_contact.build_segments(struct)
    t = types.SimpleNamespace(segments=segments)
    t.src_idx = torch.as_tensor(src_idx, device=device)
    t.tac_rows = [torch.arange(s.tac0, s.tac0 + s.n, device=device)
                  if s.tac0 >= 0 else None for s in segments]
    li = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    bj = np.asarray(struct.body_joint)
    t.sphere = [(g, types.SimpleNamespace(
        point_idx=li(g.point_idx), gjoint=li(bj[np.asarray(g.point_idx)]),
        prim_body=li(g.prim_body), pj=li(bj[np.asarray(g.prim_body)]),
        param_idx=li(g.param_idx)))
        for g in struct.contact_groups if g.sphere_general]
    _TABLES[key] = (struct, t)
    return t


def _leaf(a, batch, base):
    """A Model leaf of ``base`` dims, expanded to the batch and moved
    component first: (C, batch..., K) for a (K, C) table."""
    return a.expand(batch + a.shape[a.ndim - base:]).movedim(-1, 0)


def _sdf(gtype, x, p_b, quat_b, size, gpos, gn):
    """(phi (..., n), outward normal (3, ..., n)) at points x (3, ..., n):
    the ground plane, or primitives at (p_b, quat_b) of ``size``, each
    broadcast against x."""
    if gtype == contact.GROUND:
        return torch.sum((x - gpos) * gn, dim=0), gn.expand(x.shape)
    R = lanes.quat_to_mat(quat_b)
    xl = lanes.mat_tvec(R, x - p_b)
    if gtype == contact.GEOM_CUBOID:
        phi, gl = lanes._sdf_box(xl, size / 2.0)
    elif gtype == contact.GEOM_CYLINDER:
        phi, gl = lanes._sdf_cylinder(xl, size[0], size[1])
    elif gtype == contact.GEOM_SPHERE:
        phi, gl = lanes._sdf_sphere(xl, size[0])
    else:
        raise ValueError(gtype)
    return phi, lanes.mat_vec(R, gl)


def _sphere_wrenches(g, gt, bp, bquat, Omega, beta, sizes, params, gpos, gn,
                     F, Tau):
    """Analytic sphere-centre contacts (a handful of bodies), added to the
    per-joint wrenches F, Tau (3, ..., J), as ``lanes._sphere_group_
    wrenches``."""
    x = bp[..., gt.point_idx]
    prim = gt.prim_body
    phi, nrm = _sdf(g.gtype, x, bp[..., prim], bquat[..., prim],
                    sizes[..., prim], gpos, gn)
    r = sizes[0][..., gt.point_idx]
    phi = phi - r
    x_eff = x - r[None] * nrm
    v_rel = lanes.cross(Omega[..., gt.gjoint], x_eff) + beta[..., gt.gjoint]
    if g.gtype != contact.GROUND:
        v_rel = v_rel - (lanes.cross(Omega[..., gt.pj], x_eff)
                         + beta[..., gt.pj])
    f = lanes._penalty_force(phi, nrm, v_rel, params[..., gt.param_idx])
    qg = bquat[..., gt.point_idx]
    xi_g = lanes.quat_rotate(lanes.quat_conj(qg), x_eff - x).detach()
    F = F.index_add(-1, gt.gjoint, f)
    Tau = Tau.index_add(-1, gt.gjoint,
                        lanes.cross(x + lanes.quat_rotate(qg, xi_g), f))
    if g.gtype != contact.GROUND:
        qp = bquat[..., prim]
        xi_p = lanes.quat_rotate(lanes.quat_conj(qp),
                                 x_eff - bp[..., prim]).detach()
        x_app_p = bp[..., prim] + lanes.quat_rotate(qp, xi_p)
        F = F.index_add(-1, gt.pj, -f)
        Tau = Tau.index_add(-1, gt.pj, lanes.cross(x_app_p, -f))
    return F, Tau


def contact_terms_points_major(struct: Structure, model: Model, q, v,
                               tactile=True):
    """(Q (..., n), tac_force_world (..., ntac, 3)); the tactile forces are
    skipped (an empty (..., 0, 3)) when ``tactile`` is False, as in the
    residual."""
    ntac = len(struct.tac_joint)
    batch = q.shape[:-1]
    groups = struct.contact_groups
    if not groups:
        return torch.zeros_like(q), q.new_zeros(
            batch + (ntac if tactile else 0, 3))
    tb = _tables(struct, q.device)

    jp, jq, w, c, rot_mask = dynamics.dof_frames(struct, model, q)
    Om, be = dynamics.joint_twists(struct, w, c, rot_mask, v)
    bj = kinematics._tables(struct, q).body_joint
    bp, bquat = spatial.transform_compose(jp[..., bj, :], jq[..., bj, :],
                                          model.body_pos, model.body_quat)
    # component first, the batch, the joints / bodies / points last
    jp, jq, bp, bquat, Omega, beta = (
        a.movedim(-1, 0) for a in (jp, jq, bp, bquat, Om, be))
    J = struct.njoints
    params = _leaf(contact.param_rows(model), batch, 2)     # (4, ..., K+S)
    sizes = _leaf(model.body_size, batch, 2)                # (3, ..., NB)
    gpos = _leaf(model.ground_pos, batch, 1)[..., None]     # (3, ..., 1)
    gn = _leaf(model.ground_normal, batch, 1)[..., None]
    # the combined [cp_pos; tac_pos] table in segment order
    tables = [a for a, idx in ((model.cp_pos, struct.cp_joint),
                               (model.tac_pos, struct.tac_joint)) if len(idx)]
    lead = torch.broadcast_shapes(*(a.shape[:-2] for a in tables))
    pts = tables[0] if len(tables) == 1 else torch.cat(
        [a.expand(lead + a.shape[-2:]) for a in tables], dim=-2)
    xi_sel = _leaf(pts[..., tb.src_idx, :], batch, 2)       # (3, ..., N)

    F_cols = [q.new_zeros((3,) + batch)] * J
    T_cols = [q.new_zeros((3,) + batch)] * J
    tac = q.new_zeros((3,) + batch + (max(ntac, 1),)) if tactile else None

    offset = 0
    for s, rows in zip(tb.segments, tb.tac_rows):
        xi = xi_sel[..., offset:offset + s.n]          # (3, ..., n)
        offset += s.n
        j = s.joint
        x = jp[..., j, None] + lanes.quat_rotate(jq[..., j, None], xi)
        v_rel = lanes.cross(Omega[..., j, None], x) + beta[..., j, None]
        pb = s.prim_body
        if s.gtype == contact.GROUND:
            phi, nrm = _sdf(s.gtype, x, None, None, None, gpos, gn)
        else:
            phi, nrm = _sdf(s.gtype, x, bp[..., pb, None],
                            bquat[..., pb, None], sizes[..., pb, None],
                            gpos, gn)
            v_rel = v_rel - (lanes.cross(Omega[..., s.prim_joint, None], x)
                             + beta[..., s.prim_joint, None])
        f = lanes._penalty_force(phi, nrm, v_rel,
                                 params[..., s.param_row, None])

        fs = torch.sum(f, dim=-1)
        F_cols[j] = F_cols[j] + fs
        T_cols[j] = T_cols[j] + torch.sum(lanes.cross(x, f), dim=-1)
        if s.gtype != contact.GROUND:
            qp = bquat[..., pb, None]
            xi_p = lanes.quat_rotate(lanes.quat_conj(qp),
                                     x - bp[..., pb, None]).detach()
            x_app_p = bp[..., pb, None] + lanes.quat_rotate(qp, xi_p)
            F_cols[s.prim_joint] = F_cols[s.prim_joint] - fs
            T_cols[s.prim_joint] = T_cols[s.prim_joint] - torch.sum(
                lanes.cross(x_app_p, f), dim=-1)
        if tactile and rows is not None:
            tac = tac.index_add(-1, rows, f)

    F = torch.stack(F_cols, dim=-1)                    # (3, ..., J)
    Tau = torch.stack(T_cols, dim=-1)
    for g, gt in tb.sphere:
        F, Tau = _sphere_wrenches(g, gt, bp, bquat, Omega, beta, sizes,
                                  params, gpos, gn, F, Tau)

    # lanes.wrench_to_Q over the batch flattened into its lane axis
    n = struct.ndof_q
    lane = lambda a, k: a.reshape(-1, k, 3).permute(2, 1, 0)
    Q = lanes.wrench_to_Q(
        struct, lane(w, n), lane(c, n), rot_mask,
        F.reshape(3, -1, J).transpose(1, 2),
        Tau.reshape(3, -1, J).transpose(1, 2)).T.reshape(batch + (n,))
    if not tactile:
        return Q, q.new_zeros(batch + (0, 3))
    return Q, (tac[..., :ntac].movedim(0, -1) if ntac
               else q.new_zeros(batch + (0, 3)))


def tactile_field_points_major(struct: Structure, model: Model, q, v):
    """(..., Mtot, 3) sensor-frame [shear0, shear1, normal] marker forces,
    the points-major counterpart of ``dynamics.tactile_field``."""
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
