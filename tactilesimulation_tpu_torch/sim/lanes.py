"""Lane-major (batch-last) physics core: the batched hot path, in PyTorch.

Port of ``tactilesimulation_tpu/sim/lanes.py``: the BDF1/BDF2 env step
with an amortized chord factor (``build_env_step``) and the per-substep
Newton step (``build_step``).
Quaternions are ``(4, ..., B)``, vectors ``(3, ..., B)``, generalized
coordinates ``(n, B)``: the batch is the last (contiguous) axis, so on the
card consecutive threads of every elementwise op touch consecutive lanes.

Differentiation:
- ``el_terms`` / ``momentum`` are gradients of a Lagrangian whose body
  velocities are the joints' analytic twists (the JAX package takes the
  JVP of FK; the two are the same function). With an outer graph they are
  built with ``create_graph=True``, so the chord Jacobian can pull back
  through them.
- The chord Jacobian is built from n reverse-mode pullbacks of the residual
  (the JAX package's ``make_chord_lu(reverse=True)``): the fused contact
  kernel (``ops/lane_contact.py``) is reverse-mode only.
- ``chord_solve`` is an ``autograd.Function``: its forward is the chord
  iteration under no graph, its backward the implicit-function-theorem
  adjoint in one of the JAX package's ``bwd_mode``s (``exact``: J^T
  rebuilt at v* from n pullbacks of one residual graph, a ridged LU,
  lambda = J^{-T} g; ``fwdfac``, ``stale``, ``refine<k>``: see
  ``chord_bwd``), and -lambda pulled back into (u, q_base, p_base, gamma)
  and every Model leaf that requires grad: a shared leaf gets the sum of
  the lanes' cotangents, a leaf with a trailing lane axis its own per lane.
- Every graph that is built and differentiated on the spot (``el_terms``,
  ``momentum``, the chord factor's and the adjoints' pullbacks) is built
  under ``dynamics.inner_graph``, outside a caller's saved-tensor hooks,
  so an env step under a non-reentrant checkpoint (``remat``) packs only
  its outer graph.

Every scatter of the JAX version (``.at[].set/add``) is out of place
(``index_copy``/``index_add`` or list-then-stack), so autograd sees a pure
graph.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from . import contact, dynamics
from .integrators import _LEAVES, _requires_grad, ridge_eps
from .types import Model, Structure
from ..model.schema import (GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE,
                            JOINT_FREE3D_EULER, JOINT_FREE3D_EXP,
                            JOINT_REVOLUTE)

_EPS = 1e-12


# ---------------------------------------------------------------------------
# per-(scene, device, dtype) constant tables
#
# Index tables are host numpy in ``Structure``. Indexing a CUDA tensor with a
# host array copies the index to the card on every call (a synchronous copy
# from pageable memory), so each table is moved to the device once and kept.
# ---------------------------------------------------------------------------

_TABLES = {}


def _tables(struct: Structure, like: torch.Tensor):
    key = (id(struct), like.device, like.dtype)
    hit = _TABLES.get(key)
    if hit is not None and hit[0] is struct:
        return hit[1]
    dev, dt = like.device, like.dtype
    li = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    fl = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dt,
                                   device=dev)
    tb = struct.fk_tables
    t = types.SimpleNamespace()
    t.trans_idx = li(tb["trans_idx"].T)                        # (3, J)
    t.rot_idx = li(tb["rot_idx"].T)                            # (3, J)
    basis = np.asarray(tb["basis"])
    t.bT = fl(basis.transpose(1, 2, 0))                        # (i, k, J)
    t.m_rev = fl(tb["m_rev"]).reshape(1, -1, 1)
    t.m_exp = fl(tb["m_exp"]).reshape(1, -1, 1)
    t.m_eul = fl(tb["m_eul"]).reshape(1, -1, 1)
    t.levels = [(li(idx), li(par), bool(root))
                for idx, par, root in tb["levels"]]
    t.ident = fl([1.0, 0.0, 0.0, 0.0]).reshape(4, 1, 1)
    t.body_joint = li(struct.body_joint)
    t.cp_joint = li(struct.cp_joint)
    t.tac_joint = li(struct.tac_joint)
    t.ee_joint = li(struct.ee_joint)
    t.motor_dof = li(struct.motor_dof)
    t.pts_joint = np.concatenate([np.asarray(struct.cp_joint, np.int64),
                                  np.asarray(struct.tac_joint, np.int64)])
    t.anc = fl(_dof_tables(struct))                            # (n, J)
    rot_mask = np.zeros(struct.ndof_q)
    for j, jt in enumerate(struct.joint_types):
        if jt == JOINT_REVOLUTE:
            rot_mask[tb["rot_idx"][j, 0]] = 1.0
        elif jt in (JOINT_FREE3D_EXP, JOINT_FREE3D_EULER):
            rot_mask[tb["rot_idx"][j]] = 1.0
    t.rot_mask = fl(rot_mask)                                  # (n,)
    t.bcol = {(j, i): fl(basis[j][:, i]).reshape(3, 1)
              for j in range(struct.njoints) for i in range(3)}
    t.eye3 = [fl(np.eye(3)[:, i]).reshape(3, 1) for i in range(3)]
    from ..ops.lane_contact import build_segments
    t.src_idx = li(build_segments(struct)[2])   # pair-wrench point order
    t.groups = []
    for g in struct.contact_groups:
        gt = types.SimpleNamespace()
        bj = np.asarray(struct.body_joint)
        if g.sphere_general:
            gjoint = bj[np.asarray(g.point_idx)]
        else:
            gjoint = t.pts_joint[np.asarray(g.point_idx)]
        gt.point_idx = li(g.point_idx)
        gt.gjoint = li(gjoint)
        gt.prim_body = li(g.prim_body)
        gt.pj = li(bj[np.asarray(g.prim_body)])
        gt.param_idx = li(g.param_idx)
        gt.rows = li(np.asarray(g.tac_row) + 1)
        gt.mask = fl([1.0 if r >= 0 else 0.0
                      for r in g.tac_row]).reshape(1, -1, 1)
        t.groups.append(gt)
    _TABLES[key] = (struct, t)
    return t


def _relu(x):
    """max(x, 0) that splits the gradient at a tie, as ``jnp.maximum``."""
    return torch.maximum(x, x.new_zeros(()))


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), whose gradient is split at a bound
    (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, lo), hi)


# ---------------------------------------------------------------------------
# component-first quaternion / SO(3) algebra  (axis 0 = component)
# ---------------------------------------------------------------------------

def cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def quat_mul(a, b):
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw])


def quat_conj(q):
    return torch.stack([q[0], -q[1], -q[2], -q[3]])


def quat_rotate(q, v):
    qv, w = q[1:], q[0:1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_mat(q):
    """(4, ...) -> (3, 3, ...) world-from-local."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)])
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)])
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)])
    return torch.stack([row0, row1, row2])


def rotvec_to_quat(r):
    angle_sq = torch.sum(r * r, dim=0, keepdim=True)
    angle = torch.sqrt(angle_sq + _EPS)
    half = 0.5 * angle
    small = angle_sq < 1e-8
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * r], dim=0)


def euler_xyz_to_quat(e):
    half = 0.5 * e
    cx, cy, cz = torch.cos(half[0]), torch.cos(half[1]), torch.cos(half[2])
    sx, sy, sz = torch.sin(half[0]), torch.sin(half[1]), torch.sin(half[2])
    return torch.stack([cx * cy * cz - sx * sy * sz,
                        sx * cy * cz + cx * sy * sz,
                        cx * sy * cz - sx * cy * sz,
                        cx * cy * sz + sx * sy * cz])


def axis_angle_quat(axis, angle):
    """axis (3, ...broadcastable), angle (...) -> (4, ...)."""
    half = 0.5 * angle[None]
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=0)


def transform_compose(p_a, q_a, p_b, q_b):
    return p_a + quat_rotate(q_a, p_b), quat_mul(q_a, q_b)


def _col(arr2d, dtype):
    """(K, 3/4) row-major table -> (3/4, K, 1) lane-major constant."""
    return arr2d.to(dtype).T[:, :, None]


def mat_vec(R, v):
    """R v, unrolled: R (3, 3, ..., B), v (3, ..., B) -> (3, ..., B)."""
    return torch.stack([R[i, 0] * v[0] + R[i, 1] * v[1] + R[i, 2] * v[2]
                        for i in range(3)])


def mat_tvec(R, v):
    """R^T v, unrolled (see mat_vec)."""
    return torch.stack([R[0, i] * v[0] + R[1, i] * v[1] + R[2, i] * v[2]
                        for i in range(3)])


# ---------------------------------------------------------------------------
# forward kinematics  (q: (n, B))
# ---------------------------------------------------------------------------

def fk_joints(struct: Structure, model: Model, q):
    """World joint frames: (p (3, J, B), quat (4, J, B))."""
    tb = _tables(struct, q)
    dtype = q.dtype
    B = q.shape[1]
    q_pad = torch.cat([q, q.new_zeros((1, B))], dim=0)
    qt = q_pad[tb.trans_idx]                                    # (3, J, B)
    trans_local = torch.stack(
        [sum(tb.bT[i, k][:, None] * qt[k] for k in range(3))
         for i in range(3)])                                    # (3, J, B)
    qr = q_pad[tb.rot_idx]                                      # (3, J, B)
    axis0 = _col(model.joint_axis0, dtype)                      # (3, J, 1)
    aa = axis_angle_quat(axis0, qr[0])
    expq = rotvec_to_quat(qr)
    eulq = euler_xyz_to_quat(qr)
    m_id = 1.0 - tb.m_rev - tb.m_exp - tb.m_eul
    quat_local = (tb.m_rev * aa + tb.m_exp * expq + tb.m_eul * eulq
                  + m_id * tb.ident)
    jpos = _col(model.joint_pos, dtype)
    jquat = _col(model.joint_quat, dtype)
    p_loc = jpos + quat_rotate(jquat, trans_local)
    q_loc = quat_mul(jquat, quat_local)

    J = struct.njoints
    wp = q.new_zeros((3, J, B))
    wq = tb.ident.expand(4, J, B).contiguous()
    for idx, par, is_root in tb.levels:
        if is_root:
            wp = wp.index_copy(1, idx, p_loc[:, idx].expand(3, len(idx), B))
            wq = wq.index_copy(1, idx, q_loc[:, idx].expand(4, len(idx), B))
        else:
            bp = wp[:, par]
            bq = wq[:, par]
            wp = wp.index_copy(1, idx, bp + quat_rotate(bq, p_loc[:, idx]))
            wq = wq.index_copy(1, idx, quat_mul(bq, q_loc[:, idx]))
    return wp, wq


def fk_bodies(struct: Structure, model: Model, q):
    jp, jq = fk_joints(struct, model, q)
    bj = _tables(struct, q).body_joint
    return transform_compose(jp[:, bj], jq[:, bj],
                             _col(model.body_pos, q.dtype),
                             _col(model.body_quat, q.dtype))


def ee_positions(struct: Structure, model: Model, q):
    """(ndof_var, B) stacked end-effector world positions."""
    if len(struct.ee_joint) == 0:
        return q.new_zeros((0, q.shape[1]))
    jp, jq = fk_joints(struct, model, q)
    idx = _tables(struct, q).ee_joint
    x = jp[:, idx] + quat_rotate(jq[:, idx], _col(model.ee_pos, q.dtype))
    # rows [x0 y0 z0 x1 y1 z1 ...], as kinematics.ee_positions
    return x.permute(1, 0, 2).reshape(-1, q.shape[1])


# ---------------------------------------------------------------------------
# dynamics  (momentum form)
# ---------------------------------------------------------------------------

def lagrangian(struct: Structure, model: Model, q, v):
    """(B,) Lagrangian per lane. Body velocities are the joints' analytic
    twists along v (``dof_frames``/``joint_twists``, the contact path's
    exact velocity kinematics), equal to the JVP of FK along v that the JAX
    package takes: no forward-mode pass, so its reverse pass (``el_terms``)
    is about 4x cheaper on the host. ``body_mass`` / ``body_inertia`` may
    carry a trailing per-lane axis ((NB, B) / (NB, 3, B))."""
    dtype = q.dtype
    jp, jq = fk_joints(struct, model, q)
    bj = _tables(struct, q).body_joint
    p, quat = transform_compose(jp[:, bj], jq[:, bj],
                                _col(model.body_pos, dtype),
                                _col(model.body_quat, dtype))
    w_dof, c_dof, rot_mask = dof_frames(struct, model, q, jp, jq)
    Omega, beta = joint_twists(struct, w_dof, c_dof, rot_mask, v)
    w = Omega[:, bj]                                    # (3, NB, B)
    pd = beta[:, bj] + cross(w, p)
    R = quat_to_mat(quat)                               # (3, 3, NB, B)
    w_local = mat_tvec(R, w)
    bm = model.body_mass.to(dtype)                      # (NB,) or (NB, B)
    mass = bm[None, :, None] if bm.ndim == 1 else bm[None]
    bi = model.body_inertia.to(dtype)                   # (NB, 3[, B])
    inertia = bi.T[:, :, None] if bi.ndim == 2 else bi.permute(1, 0, 2)
    T = (0.5 * torch.sum(mass * pd * pd, dim=(0, 1))
         + 0.5 * torch.sum(inertia * w_local * w_local, dim=(0, 1)))
    g3 = model.gravity.to(dtype)
    gdotp = g3[0] * p[0] + g3[1] * p[1] + g3[2] * p[2]
    V = -torch.sum((bm[:, None] if bm.ndim == 1 else bm) * gdotp, dim=0)
    return T - V


def _grad_input(x):
    """A handle whose gradient is the partial w.r.t. ``x`` alone: a view
    keeps ``x``'s outer graph, a detached copy starts a new one."""
    return x.view_as(x) if x.requires_grad else x.detach().requires_grad_()


def el_terms(struct: Structure, model: Model, q, v):
    """(dL/dq, dL/dv) as (n, B): lanes are independent, so the gradient of
    the lane-sum is the per-lane gradient. Differentiable again when q, v or
    a Model leaf carries an outer graph (``create_graph``)."""
    create = dynamics.outer_graph(model, q, v)
    with dynamics.inner_graph(keep=create):
        q_, v_ = _grad_input(q), _grad_input(v)
        L = torch.sum(lagrangian(struct, model, q_, v_))
        dq, dv = torch.autograd.grad(L, (q_, v_), create_graph=create)
    return dq, dv


def momentum(struct: Structure, model: Model, q, v):
    """dL/dv == dT/dv (V does not depend on v)."""
    create = dynamics.outer_graph(model, q, v)
    with dynamics.inner_graph(keep=create):
        v_ = _grad_input(v)
        L = torch.sum(lagrangian(struct, model, q, v_))
        (dv,) = torch.autograd.grad(L, (v_,), create_graph=create)
    return dv


def joint_spring_forces(model: Model, q, v):
    dtype = q.dtype
    damping = model.dof_damping.to(dtype)[:, None]
    lo = model.dof_lim_lower.to(dtype)[:, None]
    hi = model.dof_lim_upper.to(dtype)[:, None]
    stiff = model.dof_lim_stiffness.to(dtype)[:, None]
    below = _relu(lo - q)
    above = _relu(q - hi)
    return -damping * v + stiff * (below - above)


def motor_forces(struct: Structure, model: Model, q, v, u):
    if struct.ndof_u == 0:
        return torch.zeros_like(q)
    dtype = q.dtype
    dof = _tables(struct, q).motor_dof
    lo = model.motor_ctrl_lo.to(dtype)[:, None]
    hi = model.motor_ctrl_hi.to(dtype)[:, None]
    kp = model.motor_kp.to(dtype)[:, None]
    kd = model.motor_kd.to(dtype)[:, None]
    mask = model.motor_pos_mask.to(dtype)[:, None]
    uc = _clip(u, lo, hi)
    pd = kp * (uc - q[dof]) - kd * v[dof]
    tau = mask * pd + (1.0 - mask) * uc
    return torch.zeros_like(q).index_add(0, dof, tau)


# -- contact ---------------------------------------------------------------

def _sdf_box(xl, half):
    """xl (3, N, B), half (3, N, 1)."""
    d = torch.abs(xl) - half
    dmax = torch.amax(d, dim=0, keepdim=True)
    outside = _relu(d)
    out_norm = torch.sqrt(torch.sum(outside ** 2, dim=0, keepdim=True)
                          + contact._EPS ** 2)
    phi = torch.where(dmax[0] > 0, out_norm[0], dmax[0])
    g_out = outside / out_norm * torch.sign(xl)
    inside_axis = (d == dmax).to(xl.dtype)
    inside_axis = inside_axis / torch.sum(inside_axis, dim=0, keepdim=True)
    g_in = inside_axis * torch.sign(xl)
    g = torch.where(dmax > 0, g_out, g_in)
    return phi, g


def _sdf_cylinder(xl, radius, half_len):
    r2 = torch.sqrt(xl[0] ** 2 + xl[1] ** 2 + contact._EPS ** 2)
    dr = r2 - radius
    dz = torch.abs(xl[2]) - half_len
    dmax = torch.maximum(dr, dz)
    o_r = _relu(dr)
    o_z = _relu(dz)
    out_norm = torch.sqrt(o_r ** 2 + o_z ** 2 + contact._EPS ** 2)
    phi = torch.where(dmax > 0, out_norm, dmax)
    pick_r = (dr >= dz).to(xl.dtype)
    c_r = torch.where(dmax > 0, o_r / out_norm, pick_r)
    c_z = torch.where(dmax > 0, o_z / out_norm, 1.0 - pick_r)
    return phi, torch.stack([c_r * xl[0] / r2, c_r * xl[1] / r2,
                             c_z * torch.sign(xl[2])])


def _sdf_sphere(xl, radius):
    r = torch.sqrt(torch.sum(xl ** 2, dim=0) + contact._EPS ** 2)
    return r - radius, xl / r[None]


def _group_sdf(group, gt, model, x, body_p, body_R):
    """x (3, N, B) -> (phi (N, B), n (3, N, B)); ``gt`` the group's tables."""
    dtype = x.dtype
    if group.gtype == contact.GROUND:
        n = model.ground_normal.to(dtype).reshape(3, 1, 1)
        gp = model.ground_pos.to(dtype).reshape(3, 1, 1)
        phi = torch.sum((x - gp) * n, dim=0)
        return phi, n.expand(x.shape)
    pidx = gt.prim_body
    p_b = body_p[:, pidx]
    R_b = body_R[:, :, pidx]                           # (3, 3, N, B)
    size = _col(model.body_size, dtype)[:, pidx]       # (3, N, 1)
    xl = mat_tvec(R_b, x - p_b)                        # R^T d
    if group.gtype == GEOM_CUBOID:
        phi, gl = _sdf_box(xl, size / 2.0)
    elif group.gtype == GEOM_CYLINDER:
        phi, gl = _sdf_cylinder(xl, size[0], size[1])
    elif group.gtype == GEOM_SPHERE:
        phi, gl = _sdf_sphere(xl, size[0])
    else:
        raise ValueError(group.gtype)
    return phi, mat_vec(R_b, gl)


def _select_params(params, param_idx):
    """(K, 4) -> (4, N, 1); per-lane (K, 4, B) -> (4, N, B)."""
    sel = params[param_idx]
    if sel.ndim == 2:
        return sel.T[:, :, None]
    return sel.transpose(0, 1)


def _penalty_force(phi, n, v_rel, prm):
    """phi (N, B), n/v_rel (3, N, B), prm (4, N, 1|B)."""
    kn, kt, mu, damping = prm[0], prm[1], prm[2], prm[3]
    pen = _relu(-phi)
    pdot = _relu(-torch.sum(n * v_rel, dim=0))
    fn_mag = kn * pen + damping * pen * pdot
    vt = v_rel - torch.sum(v_rel * n, dim=0, keepdim=True) * n
    vt_norm = torch.sqrt(torch.sum(vt ** 2, dim=0) + contact._EPS ** 2)
    cap = mu * fn_mag
    scale = cap / torch.maximum(cap, kt * vt_norm + contact._EPS)
    return fn_mag[None] * n - (kt * scale)[None] * vt


# ---------------------------------------------------------------------------
# geometric velocity kinematics (analytic dof axes -> joint twists/wrenches)
#
# Every joint type reduces to per-dof world axes: translational dofs
# contribute w_k, rotational dofs w_k x (x - c_k); summing per owning joint
# gives twists (Omega_j, beta_j) and transposes to per-joint wrenches
# (F_j, tau_j). Exact, not an approximation.
# ---------------------------------------------------------------------------

def _dof_tables(struct: Structure):
    """(n, J) host table: anc[k, j] = dof k's joint is an ancestor-or-self
    of joint j."""
    J, n = struct.njoints, struct.ndof_q
    anc = np.zeros((J, J), bool)
    for j in range(J):
        a = j
        while a >= 0:
            anc[a, j] = True
            a = struct.joint_parents[a]
    tb = struct.fk_tables
    dof_joint = np.full(n, -1, np.int64)
    for j in range(J):
        for i in range(3):
            for d in (int(tb["trans_idx"][j, i]), int(tb["rot_idx"][j, i])):
                if d != n:
                    dof_joint[d] = j
    return anc[dof_joint]


def _jl_cols(r, eye3):
    """Columns of the SO(3) left Jacobian at rotvec r (3, B) -> (3, 3, B)."""
    th2 = torch.sum(r * r, dim=0)
    th = torch.sqrt(th2 + _EPS)
    small = th2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(th2), th2)
    a = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe2)
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (safe2 * th))
    cols = []
    for i in range(3):
        e = eye3[i].expand(r.shape)
        rxe = cross(r, e)
        cols.append(e + a * rxe + b * cross(r, rxe))
    return torch.stack(cols)                   # (col, 3, B)


def dof_frames(struct: Structure, model: Model, q, jp, jq):
    """Per-dof world axes: (w (3, n, B), c (3, n, B) rotation origin, zeros
    for translational dofs, rot_mask (n,) 1.0 on rotational dofs)."""
    tbl = _tables(struct, q)
    tb = struct.fk_tables
    dtype = q.dtype
    B = q.shape[1]
    n = struct.ndof_q
    ident = tbl.ident[:, 0]                                  # (4, 1)
    jquat = _col(model.joint_quat, dtype)                    # (4, J, 1)
    q_pad = torch.cat([q, q.new_zeros((1, B))], dim=0)
    zeros3 = q.new_zeros((3, B))
    ws = [zeros3] * n
    cs = [zeros3] * n
    for j in range(struct.njoints):
        par = struct.joint_parents[j]
        pq = jq[:, par] if par >= 0 else ident.expand(4, B)
        Fq = quat_mul(pq, jquat[:, j].expand(4, B))
        for i in range(3):                     # translational dofs
            d = int(tb["trans_idx"][j, i])
            if d == n:
                continue
            ws[d] = quat_rotate(Fq, tbl.bcol[(j, i)].expand(3, B))
        jt = struct.joint_types[j]
        origin = jp[:, j]
        if jt == JOINT_REVOLUTE:
            d = int(tb["rot_idx"][j, 0])
            ax = model.joint_axis0.to(dtype)[j].reshape(3, 1)
            ws[d] = quat_rotate(Fq, ax.expand(3, B))
            cs[d] = origin
        elif jt == JOINT_FREE3D_EXP:
            ridx = [int(k) for k in tb["rot_idx"][j]]
            cols = _jl_cols(q_pad[ridx[0]:ridx[2] + 1], tbl.eye3)
            for i in range(3):
                ws[ridx[i]] = quat_rotate(Fq, cols[i])
                cs[ridx[i]] = origin
        elif jt == JOINT_FREE3D_EULER:
            ridx = [int(k) for k in tb["rot_idx"][j]]
            ex, ey = q_pad[ridx[0]], q_pad[ridx[1]]
            cx, sx = torch.cos(ex), torch.sin(ex)
            cy, sy = torch.cos(ey), torch.sin(ey)
            zero = torch.zeros_like(ex)
            one = torch.ones_like(ex)
            # R = Rx(ex) Ry(ey) Rz(ez): generator axes x, Rx y, Rx Ry z
            locals_ = (torch.stack([one, zero, zero]),
                       torch.stack([zero, cx, sx]),
                       torch.stack([sy, -sx * cy, cx * cy]))
            for i in range(3):
                ws[ridx[i]] = quat_rotate(Fq, locals_[i])
                cs[ridx[i]] = origin
    return torch.stack(ws, dim=1), torch.stack(cs, dim=1), tbl.rot_mask


def joint_twists(struct: Structure, w, c, rot_mask, v):
    """World twist of every joint frame: (Omega (3, J, B), beta (3, J, B));
    point velocity on joint j's subtree = Omega_j x X + beta_j."""
    anc = _tables(struct, w).anc                             # (n, J)
    rm = rot_mask.reshape(1, -1, 1)
    wv = w * v[None]                                          # (3, n, B)
    u = cross(w, c)                                           # w_k x c_k
    omega_terms = rm * wv
    beta_terms = (1.0 - rm) * wv - rm * (u * v[None])
    Omega = torch.einsum("cnb,nj->cjb", omega_terms, anc)
    beta = torch.einsum("cnb,nj->cjb", beta_terms, anc)
    return Omega, beta


def wrench_to_Q(struct: Structure, w, c, rot_mask, F, Tau):
    """Generalized forces from per-joint world wrenches (force sum F (3,J,B),
    torque-about-world-origin sum Tau (3,J,B))."""
    anc = _tables(struct, w).anc                             # (n, J)
    rm = rot_mask.reshape(-1, 1, 1)
    u = cross(w, c)
    wF = torch.einsum("cnb,cjb->njb", w, F)
    wT = torch.einsum("cnb,cjb->njb", w, Tau)
    uF = torch.einsum("cnb,cjb->njb", u, F)
    per = rm * (wT - uF) + (1.0 - rm) * wF                    # (n, J, B)
    return torch.einsum("njb,nj->nb", per, anc)


def _points_world(struct, model, jp, jq):
    """Combined [contact points; tactile markers] world array (3, N, B)."""
    tb = _tables(struct, jp)
    dtype = jp.dtype
    B = jp.shape[-1]
    pts = []
    for arr, idx in ((model.cp_pos, tb.cp_joint), (model.tac_pos, tb.tac_joint)):
        if len(idx) == 0:
            pts.append(jp.new_zeros((3, 0, B)))
        else:
            pts.append(jp[:, idx] + quat_rotate(jq[:, idx], _col(arr, dtype)))
    return torch.cat(pts, dim=1)


def _add_cols(acc, idx, val):
    return acc.index_add(1, idx, val)


def contact_terms(struct: Structure, model: Model, q, v,
                  moving_point: bool = False):
    """(Q (n, B), tac_force (3, Mtot, B) world marker forces): the plain
    group loop, the oracle of the fused path. Application points are held
    fixed in their local frames under differentiation (``.detach()`` on the
    local coordinates), the JAX package's ``lanes`` convention. With
    ``moving_point`` the primitive side's torque is taken at the contact
    point itself, which moves with both bodies under differentiation: the
    JAX package's ``megastep`` convention, and the derivative of the
    residual's value (the two agree in value)."""
    groups = struct.contact_groups
    ntac = len(struct.tac_joint)
    dtype = q.dtype
    B = q.shape[1]
    if not groups:
        return torch.zeros_like(q), q.new_zeros((3, ntac, B))

    tb = _tables(struct, q)
    J = struct.njoints
    jp, jq = fk_joints(struct, model, q)
    bj = tb.body_joint
    bp, bquat = transform_compose(jp[:, bj], jq[:, bj],
                                  _col(model.body_pos, dtype),
                                  _col(model.body_quat, dtype))
    bR = quat_to_mat(bquat)
    pts = _points_world(struct, model, jp, jq)

    w, c, rot_mask = dof_frames(struct, model, q, jp, jq)
    Omega, beta = joint_twists(struct, w, c, rot_mask, v)
    params = contact.combined_params(model).to(dtype)         # (K, 4)

    F_acc = q.new_zeros((3, J, B))
    Tau_acc = q.new_zeros((3, J, B))
    tac_force = q.new_zeros((3, ntac + 1, B))

    for g, gt in zip(groups, tb.groups):
        gjoint = gt.gjoint
        x = bp[:, gt.point_idx] if g.sphere_general else pts[:, gt.point_idx]
        phi, nrm = _group_sdf(g, gt, model, x, bp, bR)
        if g.sphere_general:
            r = model.body_size.to(dtype)[gt.point_idx, 0]
            phi = phi - r[:, None]
            x_eff = x - r[None, :, None] * nrm
        else:
            x_eff = x
        v_pt = cross(Omega[:, gjoint], x_eff) + beta[:, gjoint]
        if g.gtype == contact.GROUND:
            v_rel = v_pt
        else:
            v_prim = cross(Omega[:, gt.pj], x_eff) + beta[:, gt.pj]
            v_rel = v_pt - v_prim
        f = _penalty_force(phi, nrm, v_rel, _select_params(params,
                                                           gt.param_idx))
        tac_force = _add_cols(tac_force, gt.rows, f * gt.mask)

        # +f at x_app on the general side, -f on the primitive side, with
        # application points fixed in their local frames
        if g.sphere_general:
            qg = bquat[:, gt.point_idx]
            xi_g = quat_rotate(quat_conj(qg), x_eff - x).detach()
            x_app_g = x + quat_rotate(qg, xi_g)
        else:
            x_app_g = x
        F_acc = _add_cols(F_acc, gjoint, f)
        Tau_acc = _add_cols(Tau_acc, gjoint, cross(x_app_g, f))
        if g.gtype != contact.GROUND:
            if moving_point:
                x_app_p = x_eff
            else:
                qp = bquat[:, gt.prim_body]
                xi_p = quat_rotate(quat_conj(qp),
                                   x_eff - bp[:, gt.prim_body]).detach()
                x_app_p = bp[:, gt.prim_body] + quat_rotate(qp, xi_p)
            F_acc = _add_cols(F_acc, gt.pj, -f)
            Tau_acc = _add_cols(Tau_acc, gt.pj, cross(x_app_p, -f))

    Q = wrench_to_Q(struct, w, c, rot_mask, F_acc, Tau_acc)
    return Q, tac_force[:, 1:]


def _sphere_group_wrenches(struct, model, g, gt, bp, bquat, bR, Omega, beta,
                           params, F_acc, Tau_acc):
    """Analytic sphere-center contact contributions (plain torch: a
    handful of points; used by the fused path)."""
    dtype = bp.dtype
    gjoint = gt.gjoint
    x = bp[:, gt.point_idx]
    phi, nrm = _group_sdf(g, gt, model, x, bp, bR)
    r = model.body_size.to(dtype)[gt.point_idx, 0]
    phi = phi - r[:, None]
    x_eff = x - r[None, :, None] * nrm
    v_pt = cross(Omega[:, gjoint], x_eff) + beta[:, gjoint]
    if g.gtype == contact.GROUND:
        v_rel = v_pt
    else:
        v_rel = v_pt - (cross(Omega[:, gt.pj], x_eff) + beta[:, gt.pj])
    f = _penalty_force(phi, nrm, v_rel, _select_params(params, gt.param_idx))
    qg = bquat[:, gt.point_idx]
    xi_g = quat_rotate(quat_conj(qg), x_eff - x).detach()
    x_app_g = x + quat_rotate(qg, xi_g)
    F_acc = _add_cols(F_acc, gjoint, f)
    Tau_acc = _add_cols(Tau_acc, gjoint, cross(x_app_g, f))
    if g.gtype != contact.GROUND:
        qp = bquat[:, gt.prim_body]
        xi_p = quat_rotate(quat_conj(qp),
                           x_eff - bp[:, gt.prim_body]).detach()
        x_app_p = bp[:, gt.prim_body] + quat_rotate(qp, xi_p)
        F_acc = _add_cols(F_acc, gt.pj, -f)
        Tau_acc = _add_cols(Tau_acc, gt.pj, cross(x_app_p, -f))
    return F_acc, Tau_acc


def _fused_small_stage(struct, model, q, v):
    """Joint frames, body poses, dof axes, twists: the small-array stage
    shared by the fused contact paths."""
    dtype = q.dtype
    jp, jq = fk_joints(struct, model, q)
    bj = _tables(struct, q).body_joint
    bp, bquat = transform_compose(jp[:, bj], jq[:, bj],
                                  _col(model.body_pos, dtype),
                                  _col(model.body_quat, dtype))
    w, c, rot_mask = dof_frames(struct, model, q, jp, jq)
    Omega, beta = joint_twists(struct, w, c, rot_mask, v)
    return jp, jq, bp, bquat, w, c, rot_mask, Omega, beta


def contact_terms_fused(struct: Structure, model: Model, q, v, pw, pw_meta):
    """``contact_terms`` with the per-point pipeline in the pair-wrench op
    ``pw`` (K1, ``ops/lane_contact.py``); sphere_general groups stay plain
    torch. Differentiation goes through the op's backward (plain twin)."""
    from ..ops import lane_contact
    del pw_meta   # the point order is the scene's (cached in _tables)
    dtype = q.dtype
    jp, jq, bp, bquat, w, c, rot_mask, Omega, beta = _fused_small_stage(
        struct, model, q, v)
    params = contact.combined_params(model).to(dtype)
    tb = _tables(struct, q)
    xi_packed = lane_contact.pack_points(struct, model, tb.src_idx).to(dtype)
    F, Tau, tac = pw(jp, jq, Omega, beta, bp, bquat,
                     model.body_size.to(dtype), params,
                     model.ground_pos.to(dtype),
                     model.ground_normal.to(dtype), xi_packed)
    sphere = [(g, gt) for g, gt in zip(struct.contact_groups, tb.groups)
              if g.sphere_general]
    if sphere:
        bR = quat_to_mat(bquat)
        for g, gt in sphere:
            F, Tau = _sphere_group_wrenches(struct, model, g, gt, bp, bquat,
                                            bR, Omega, beta, params, F, Tau)
    Q = wrench_to_Q(struct, w, c, rot_mask, F, Tau)
    return Q, tac


def _sensor_frame(struct, model, q, tac_force):
    """World marker forces (3, M, B) -> (M, 3, B) sensor-frame
    [shear0, shear1, normal]."""
    _, jq = fk_joints(struct, model, q)
    qw = jq[:, _tables(struct, q).tac_joint]
    dtype = q.dtype
    n_w = quat_rotate(qw, _col(model.tac_normal, dtype))
    a0_w = quat_rotate(qw, _col(model.tac_axis0, dtype))
    a1_w = quat_rotate(qw, _col(model.tac_axis1, dtype))
    return torch.stack([torch.sum(tac_force * a0_w, dim=0),
                        torch.sum(tac_force * a1_w, dim=0),
                        torch.sum(tac_force * n_w, dim=0)], dim=1)


def tactile_field_fused(struct: Structure, model: Model, q, v, pw, pw_meta):
    """(Mtot, 3, B) sensor-frame marker forces via the pair-wrench op."""
    _, tac_force = contact_terms_fused(struct, model, q, v, pw, pw_meta)
    return _sensor_frame(struct, model, q, tac_force)


def applied_forces(struct: Structure, model: Model, q, v, u,
                   moving_point: bool = False):
    Q_contact, tac_force = contact_terms(struct, model, q, v, moving_point)
    Q = (joint_spring_forces(model, q, v)
         + motor_forces(struct, model, q, v, u)
         + Q_contact)
    return Q, tac_force


def tactile_field(struct: Structure, model: Model, q, v):
    """(Mtot, 3, B) sensor-frame [shear0, shear1, normal] marker forces."""
    _, tac_force = contact_terms(struct, model, q, v)
    return _sensor_frame(struct, model, q, tac_force)


# ---------------------------------------------------------------------------
# per-lane dense linear algebra  (A (n, n, B))
# ---------------------------------------------------------------------------

def gauss_factor(A):
    """Unrolled no-pivot LU over lanes: (n, n, B) with L below / U on and
    above the diagonal. The iteration matrix is a perturbed SPD mass matrix,
    so pivoting is unnecessary; callers add a scaled ridge."""
    n = A.shape[0]
    rows = [[A[i, j] for j in range(n)] for i in range(n)]
    for k in range(n):
        inv = 1.0 / rows[k][k]
        for i in range(k + 1, n):
            f = rows[i][k] * inv
            rows[i][k] = f
            for j in range(k + 1, n):
                rows[i][j] = rows[i][j] - f * rows[k][j]
    return torch.stack([torch.stack(r) for r in rows])


def gauss_solve(lu, b):
    """Solve with gauss_factor output; b (n, B) -> x (n, B)."""
    n = lu.shape[0]
    x = [b[i] for i in range(n)]
    for i in range(n):
        for j in range(i):
            x[i] = x[i] - lu[i, j] * x[j]
    for i in reversed(range(n)):
        for j in range(i + 1, n):
            x[i] = x[i] - lu[i, j] * x[j]
        x[i] = x[i] / lu[i, i]
    return torch.stack(x)


def gauss_solve_T(lu, b):
    """Solve A^T x = b with gauss_factor(A) output (A = L U, unit-lower L):
    forward substitution with U^T, then back substitution with L^T."""
    n = lu.shape[0]
    y = [None] * n
    for i in range(n):
        acc = b[i]
        for j in range(i):
            acc = acc - lu[j, i] * y[j]
        y[i] = acc / lu[i, i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for j in range(i + 1, n):
            acc = acc - lu[j, i] * x[j]
        x[i] = acc
    return torch.stack(x)


# ---------------------------------------------------------------------------
# implicit stepper (BDF1, amortized chord)
# ---------------------------------------------------------------------------

class StepInputs(NamedTuple):
    model: Model
    u: torch.Tensor        # (nu, B)
    q_base: torch.Tensor   # (n, B)
    p_base: torch.Tensor   # (n, B)
    gamma: torch.Tensor    # (1, B) or (1, 1)


class LaneSimState(NamedTuple):
    q: torch.Tensor
    qdot: torch.Tensor
    q_prev: torch.Tensor
    qdot_prev: torch.Tensor
    t: torch.Tensor        # (B,) int32


def make_residual(struct: Structure, fused_pw=None,
                  moving_point: bool = False):
    """r(v') = p(q', v') - p_base - gamma (dL/dq + Q), q' = q_base + gamma v'.

    ``fused_pw = (pw, pw_meta)`` routes the contact chain through the
    pair-wrench op (``ops/lane_contact.py``); ``moving_point`` picks the
    megastep's contact-torque convention (``contact_terms``), plain path
    only."""
    if fused_pw is not None and moving_point:
        raise ValueError("moving_point runs on the plain contact path only")

    def residual(v_new, inputs: StepInputs):
        qn = inputs.q_base + inputs.gamma * v_new
        dLdq, p_new = el_terms(struct, inputs.model, qn, v_new)
        if fused_pw is not None:
            Qc, _ = contact_terms_fused(struct, inputs.model, qn, v_new,
                                        *fused_pw)
            Q = (joint_spring_forces(inputs.model, qn, v_new)
                 + motor_forces(struct, inputs.model, qn, v_new, inputs.u)
                 + Qc)
        else:
            Q, _ = applied_forces(struct, inputs.model, qn, v_new, inputs.u,
                                  moving_point)
        return p_new - inputs.p_base - inputs.gamma * (dLdq + Q)
    return residual


def _ridge(J):
    """J (n, n, B) + scale-aware ridge (same formula as the JAX package)."""
    n = J.shape[0]
    diag_mag = sum(torch.abs(J[i, i]) for i in range(n)) / n   # (B,)
    ridge = ridge_eps(J.dtype) * (diag_mag + 1.0)
    eye = torch.eye(n, dtype=J.dtype, device=J.device)[:, :, None]
    return J + ridge[None, None] * eye


def _detach_inputs(inputs: StepInputs) -> StepInputs:
    return StepInputs(model=inputs.model, u=inputs.u.detach(),
                      q_base=inputs.q_base.detach(),
                      p_base=inputs.p_base.detach(),
                      gamma=inputs.gamma.detach())


def make_chord_lu(residual_fn, inputs: StepInputs, v_guess):
    """LU factor of the ridge-guarded chord Jacobian J = dr/dv at
    (inputs, v_guess), detached: the factor is a solver ingredient, not a
    differentiated quantity.

    J is built from n reverse-mode pullbacks of ONE residual graph (row i =
    the pullback of the i-th basis cotangent), the JAX package's
    ``make_chord_lu(reverse=True)``: the pair-wrench op is reverse-mode
    only."""
    inputs = _detach_inputs(inputs)
    n = v_guess.shape[0]
    with dynamics.inner_graph():
        v = v_guess.detach().requires_grad_()
        r = residual_fn(v, inputs)
        basis = torch.eye(n, dtype=v.dtype, device=v.device)[:, :, None]
        rows = [torch.autograd.grad(r, v, basis[i].expand_as(r),
                                    retain_graph=i < n - 1)[0]
                for i in range(n)]
    J = torch.stack(rows)                    # J[i, k] = dr_i/dv_k
    return gauss_factor(_ridge(J)).detach()


def _chord(residual_fn, max_iter, tol, inputs, v_guess, lu):
    """Chord iteration with a provided LU factor. Always runs ``max_iter``
    sweeps; converged lanes are frozen by a mask, and the best iterate (by
    residual norm) is returned."""
    dtype = v_guess.dtype
    rel = 1e-4 if dtype == torch.float32 else 1e-7
    r0 = residual_fn(v_guess, inputs)
    rn0 = torch.sqrt(torch.sum(r0 * r0, dim=0))
    tol_eff = torch.clamp(rel * rn0, min=tol)
    v, r, rn, v_best, rn_best = v_guess, r0, rn0, v_guess, rn0
    for _ in range(max_iter):
        dv = gauss_solve(lu, r)
        v = torch.where(rn <= tol_eff, v, v - dv)
        r = residual_fn(v, inputs)
        rn = torch.sqrt(torch.sum(r * r, dim=0))
        better = rn < rn_best
        v_best = torch.where(better, v, v_best)
        rn_best = torch.where(better, rn, rn_best)
    return v_best


def _residual_graph(residual_fn, inputs: StepInputs, v_star, wrt=None):
    """r at v* and the tensors to pull back into; call under
    ``dynamics.inner_graph``. ``wrt`` None: (u, q_base, p_base) as fresh
    leaves. Otherwise ``inputs`` already holds the leaves to pull back into
    and ``wrt`` lists them (``_ChordSolveFn``: every input that requires
    grad, Model leaves included)."""
    v = v_star.detach().requires_grad_()
    if wrt is not None:
        return residual_fn(v, inputs), v, tuple(wrt)
    u = inputs.u.detach().requires_grad_()
    q_base = inputs.q_base.detach().requires_grad_()
    p_base = inputs.p_base.detach().requires_grad_()
    r = residual_fn(v, StepInputs(model=inputs.model, u=u, q_base=q_base,
                                  p_base=p_base, gamma=inputs.gamma.detach()))
    return r, v, (u, q_base, p_base)


def chord_adjoint(residual_fn, inputs: StepInputs, v_star, g, wrt=None):
    """The exact at-solution IFT adjoint of the chord solve (the JAX
    package's ``_chord_bwd(..., 'exact', ...)``): (u_bar, q_base_bar,
    p_base_bar) for the cotangent ``g`` (n, B) of v*, or the cotangents of
    ``wrt`` (``_residual_graph``).

    One residual graph at v*: its n pullbacks along the basis give the rows
    of J = dr/dv, then lambda = (ridged J^T)^{-1} g, and -lambda is pulled
    back through the same graph into the inputs."""
    n = v_star.shape[0]
    with dynamics.inner_graph():
        r, v, wrt = _residual_graph(residual_fn, inputs, v_star, wrt)
        basis = torch.eye(n, dtype=v.dtype, device=v.device)[:, :, None]
        rows = [torch.autograd.grad(r, v, basis[i].expand_as(r),
                                    retain_graph=True)[0]
                for i in range(n)]
        JT = torch.stack(rows).transpose(0, 1)   # JT[k, i] = dr_i/dv_k
        lam = gauss_solve(gauss_factor(_ridge(JT)), g.to(v.dtype))
        return torch.autograd.grad(r, wrt, -lam, allow_unused=True)


def parse_bwd_mode(bwd_mode: str):
    """(kind, k) of a chord adjoint mode: kind one of exact, fwdfac, stale,
    refine, and k the refinement sweeps (2 for a bare ``refine``, None for
    the other kinds). Raises on any other name."""
    if bwd_mode in ("exact", "fwdfac", "stale"):
        return bwd_mode, None
    k = bwd_mode[6:] if bwd_mode.startswith("refine") else None
    if k is None or not (k == "" or k.isdigit()):
        raise ValueError(f"bwd_mode {bwd_mode!r}: one of exact, fwdfac, "
                         "stale, refine, refine<k>")
    return "refine", int(k) if k else 2


def chord_bwd(residual_fn, bwd_mode: str, inputs: StepInputs, v_star, lu, g,
              wrt=None):
    """The chord solve's adjoint in ``bwd_mode`` (the JAX package's
    ``_chord_bwd``): (u_bar, q_base_bar, p_base_bar) for the cotangent ``g``
    of v*, or the cotangents of ``wrt`` (``_residual_graph``). ``lu`` is
    the factor the forward saved:

    - ``exact``: ``chord_adjoint`` (J^T rebuilt at v*; ``lu`` unused);
    - ``fwdfac``: ``lu`` is the exact J at v*, factored in the forward:
      lambda = ``gauss_solve_T(lu, g)``, the same matrix as ``exact``;
    - ``stale``: the same solve with the forward's chord factor;
    - ``refine<k>`` (k = 2 when bare): iterative refinement of
      J^T lambda = g with the chord factor as preconditioner and exact
      J^T lambda products (pullbacks of one residual graph at v*); per
      lane the lambda with the smallest exact residual is kept (a NaN
      residual compares False and is never kept)."""
    kind, k = parse_bwd_mode(bwd_mode)
    if kind == "exact":
        return chord_adjoint(residual_fn, inputs, v_star, g, wrt)
    with dynamics.inner_graph():
        r, v, wrt = _residual_graph(residual_fn, inputs, v_star, wrt)
        g = g.to(v.dtype)
        lam = gauss_solve_T(lu, g)
        if kind == "refine":
            def resid(lam):
                JT_lam = torch.autograd.grad(r, v, lam, retain_graph=True)[0]
                res = g - JT_lam
                return res, torch.sum(res * res, dim=0)

            res, rn = resid(lam)
            lam_best, rn_best = lam, rn
            for _ in range(k):
                lam = lam + gauss_solve_T(lu, res)
                res, rn = resid(lam)
                better = rn < rn_best
                lam_best = torch.where(better, lam, lam_best)
                rn_best = torch.where(better, rn, rn_best)
            lam = lam_best
        return torch.autograd.grad(r, wrt, -lam, allow_unused=True)


class _ChordSolveFn(torch.autograd.Function):
    """v* = chord(inputs) with the IFT adjoint of ``bwd_mode`` as its
    backward. Its tensor arguments are the factor, the guess, u, q_base,
    p_base, gamma and the Model's leaves in field order (a Function takes
    tensors, not the dataclass), so the backward reaches every leaf."""

    @staticmethod
    def forward(ctx, residual_fn, max_iter, tol, bwd_mode, lu, v_guess, u,
                q_base, p_base, gamma, *leaves):
        inputs = StepInputs(model=Model(*(x.detach() for x in leaves)),
                            u=u, q_base=q_base, p_base=p_base, gamma=gamma)
        v_star = _chord(residual_fn, max_iter, tol, inputs, v_guess, lu)
        if bwd_mode == "fwdfac":
            # the exact J at v*, factored here in the forward
            lu = make_chord_lu(residual_fn, inputs, v_star)
        ctx.residual_fn = residual_fn
        ctx.bwd_mode = bwd_mode
        ctx.save_for_backward(v_star, lu, u, q_base, p_base, gamma, *leaves)
        return v_star

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        v_star, lu, *xs = ctx.saved_tensors
        # u, q_base, p_base, gamma, then the leaves (lu and v_guess get
        # none); -lambda is always pulled back into u, q_base and p_base,
        # as the adjoint did before it reached gamma and the leaves, so a
        # pullback's kernel launches do not depend on what requires grad
        need = ctx.needs_input_grad[6:]
        pull = (True,) * 3 + tuple(need[3:])
        xs = [x.detach().requires_grad_(w) for x, w in zip(xs, pull)]
        inputs = StepInputs(Model(*xs[4:]), *xs[:4])
        got = iter(chord_bwd(ctx.residual_fn, ctx.bwd_mode, inputs, v_star,
                             lu, g, [x for x in xs if x.requires_grad]))
        grads = [next(got) if w else None for w in pull]
        return (None,) * 6 + tuple(x if w else None
                                   for x, w in zip(grads, need))


def chord_solve(residual_fn, max_iter, tol, bwd_mode: str,
                inputs: StepInputs, v_guess, lu):
    """Chord solve with the IFT adjoint of ``bwd_mode`` (``chord_bwd``).

    Gradients reach ``inputs.u``, ``q_base``, ``p_base``, ``gamma`` and the
    Model's leaves; the guess and the factor are solver ingredients and get
    none."""
    parse_bwd_mode(bwd_mode)
    if not (torch.is_grad_enabled() and _requires_grad(inputs)):
        with torch.no_grad():
            return _chord(residual_fn, max_iter, tol, inputs, v_guess, lu)
    m = inputs.model
    return _ChordSolveFn.apply(residual_fn, max_iter, tol, bwd_mode,
                               lu.detach(), v_guess.detach(), inputs.u,
                               inputs.q_base, inputs.p_base, inputs.gamma,
                               *(getattr(m, k) for k in _LEAVES))


def newton_solve(residual_fn, max_iter, tol, inputs: StepInputs, v_guess):
    """The JAX package's ``newton_solve``: the chord Jacobian linearized and
    factored at ``v_guess`` (``make_chord_lu``), ``max_iter`` masked sweeps
    with the per-lane best iterate (``_chord``), and the exact at-solution
    IFT adjoint (``chord_adjoint``) as its backward."""
    lu = make_chord_lu(residual_fn, inputs, v_guess)
    return chord_solve(residual_fn, max_iter, tol, "exact", inputs, v_guess,
                       lu)


def factor_substeps(frame_skip: int, refresh: int):
    """The substeps of an env step that factor the chord Jacobian afresh
    (the JAX package's schedule): ``refresh`` 0 or >= frame_skip once, at
    the entry state; otherwise every substep k with k % refresh == 0."""
    refresh = refresh or frame_skip
    return [k for k in range(frame_skip)
            if k == 0 or (refresh < frame_skip and k % refresh == 0)]


def step_bases(struct: Structure, model: Model, state: LaneSimState):
    """(gamma, q_base, p_base) of one substep from ``state`` (the JAX
    package's ``bases``). BDF1: gamma = h (1, 1). BDF2: gamma = 2h/3,
    q_base = (4q - q_)/3, p_base = (4p(q, v) - p(q_, v_))/3, and on a lane
    whose counter is 0 (no history yet) BDF1's, through ``torch.where``:
    no sync."""
    dtype = state.q.dtype
    h = model.h.to(dtype)
    p_now = momentum(struct, model, state.q, state.qdot)
    if struct.integrator.upper() != "BDF2":
        return h.reshape(1, 1), state.q, p_now
    first = (state.t == 0)[None]                                 # (1, B)
    p_prev = momentum(struct, model, state.q_prev, state.qdot_prev)
    gamma = torch.where(first, h, 2.0 * h / 3.0)
    q_base = torch.where(first, state.q, (4.0 * state.q - state.q_prev) / 3.0)
    p_base = torch.where(first, p_now, (4.0 * p_now - p_prev) / 3.0)
    return gamma, q_base, p_base


def build_env_step(struct: Structure, frame_skip: int, *, refresh: int = 0,
                   bwd_mode: str = "exact", max_iter: int = 0,
                   fused_pw=None, moving_point: bool = False):
    """``frame_skip`` implicit BDF1 or BDF2 substeps (the scene's
    integrator, ``step_bases``) under one held control.

    env_step(model, state, u) -> state', differentiable w.r.t. the state,
    ``u`` and the Model's leaves. The chord Jacobian is factored at the
    substeps of ``factor_substeps(frame_skip, refresh)``: once per env step
    at refresh 0 (the amortized default), at every substep at refresh 1,
    which with ``bwd_mode='exact'`` is ``build_step`` run frame_skip times.
    ``bwd_mode`` picks the chord solve's adjoint (``chord_bwd``).
    ``max_iter`` overrides the scene's chord budget;
    ``fused_pw = (pw, meta)`` from ``ops.lane_contact.make_pair_wrenches``
    routes contact through K1; ``moving_point`` takes the megastep's
    contact-torque convention (``contact_terms``).
    """
    parse_bwd_mode(bwd_mode)
    residual_fn = make_residual(struct, fused_pw, moving_point)
    miter = max_iter or struct.solver_max_iter
    fresh = set(factor_substeps(frame_skip, refresh))

    def env_step(model: Model, state: LaneSimState, u):
        dtype = state.q.dtype
        # lanes floor (not the fused megastep's 1e-7 in every dtype)
        tol = max(struct.solver_tol, 1e-7 if dtype == torch.float32
                  else 1e-12)
        u = u.to(dtype)
        lu = None
        for k in range(frame_skip):
            gamma, q_base, p_base = step_bases(struct, model, state)
            inputs = StepInputs(model=model, u=u, q_base=q_base,
                                p_base=p_base, gamma=gamma)
            if k in fresh:
                lu = make_chord_lu(residual_fn, inputs, state.qdot)
            v_new = chord_solve(residual_fn, miter, tol, bwd_mode, inputs,
                                state.qdot, lu)
            state = LaneSimState(q=q_base + gamma * v_new, qdot=v_new,
                                 q_prev=state.q, qdot_prev=state.qdot,
                                 t=state.t + 1)
        return state

    return env_step


def build_step(struct: Structure):
    """step(model, state (LaneSimState, (n, B) leaves), u (nu, B)) ->
    state': one implicit BDF1/BDF2 step per lane through ``newton_solve``
    (the JAX package's ``lanes.build_step``, plain contact): a chord factor
    at every step, the scene's chord budget, the exact adjoint. Model
    leaves may carry a trailing lane axis (``body_mass`` (NB, B),
    ``body_inertia`` (NB, 3, B), the contact parameters (K, B))."""
    residual_fn = make_residual(struct)
    max_iter = struct.solver_max_iter

    def step(model: Model, state: LaneSimState, u):
        dtype = state.q.dtype
        tol = max(struct.solver_tol, 1e-7 if dtype == torch.float32
                  else 1e-12)
        gamma, q_base, p_base = step_bases(struct, model, state)
        inputs = StepInputs(model=model, u=u.to(dtype), q_base=q_base,
                            p_base=p_base, gamma=gamma)
        v_new = newton_solve(residual_fn, max_iter, tol, inputs, state.qdot)
        return LaneSimState(q=q_base + gamma * v_new, qdot=v_new,
                            q_prev=state.q, qdot_prev=state.qdot,
                            t=state.t + 1)

    step.residual_fn = residual_fn
    return step


def to_lanes(state_batch) -> LaneSimState:
    """A state with (B, n) leaves (batch-first) -> LaneSimState (n, B)."""
    t = state_batch.t
    return LaneSimState(q=state_batch.q.T, qdot=state_batch.qdot.T,
                        q_prev=state_batch.q_prev.T,
                        qdot_prev=state_batch.qdot_prev.T,
                        t=t.reshape(-1) if t.ndim else t.reshape(1))

