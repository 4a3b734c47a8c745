"""Articulated dynamics of one instance in momentum form, derived from FK by
autodiff (row-major: q, v (n,)).

Port of ``tactilesimulation_tpu/sim/dynamics.py``:

    T(q, v)   kinetic energy from body velocities (one forward-mode JVP of FK)
    p(q, v) = dT/dv                     generalized momentum
    d/dt p = dL/dq + Q(q, v, u)         Euler-Lagrange, L = T - V

The body velocities (the JVP of FK along v) are the joints' world twists,
written as plain ops (``twists``). ``el_terms`` and ``momentum`` are
gradients of the Lagrangian; with an outer graph (q, v or a Model leaf
requiring grad) they are built with ``create_graph``, so the chord
Jacobian and the adjoint can pull back through them.

Generalized contact forces: Q = (dX/dq)^T f for the application points X(q),
one reverse pass through FK (the JAX package transposes ``jax.linearize``;
here ``torch.autograd.grad`` of the FK outputs with the force cotangents).
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import numpy as np
import torch

from . import contact, kinematics, spatial
from .types import Model, Structure


def _grad_input(x):
    """A handle whose gradient is the partial w.r.t. ``x`` alone: a view
    keeps ``x``'s outer graph, a detached copy starts a new one."""
    return x.view_as(x) if x.requires_grad else x.detach().requires_grad_()


def outer_graph(model: Model, *xs):
    """True if the result of an inner ``autograd.grad`` must keep its graph:
    grad mode is on and q, v or a Model leaf requires grad (a state that
    does not under a leaf that does, e.g. the momentum of the initial state
    under a design parameter)."""
    if not torch.is_grad_enabled():
        return False
    return (any(x.requires_grad for x in xs)
            or any(getattr(model, f.name).requires_grad
                   for f in dataclasses.fields(model)))


def _keep(x):
    return x


def _caller_hooks() -> bool:
    """True if a caller's saved-tensor hooks are active (a non-reentrant
    checkpoint's, say), and where torch cannot tell."""
    top = getattr(torch._C._autograd, "_top_saved_tensors_default_hooks",
                  None)
    if top is None:
        return True
    try:
        return top(False) is not None
    except TypeError:
        return top() is not None


@contextlib.contextmanager
def inner_graph():
    """Grad mode for a graph that is built and differentiated on the spot.

    Where a caller's saved-tensor hooks are active, its saved tensors are
    kept as they are, past those hooks: under
    ``torch.utils.checkpoint(use_reentrant=False)`` a tensor unpacked
    before the backward would rerun the checkpointed function up to that
    point, once per inner ``autograd.grad``. Elsewhere autograd saves them
    itself: a hook that keeps a tensor holds an op's output, and through
    it the op's own node, a reference cycle that the garbage collector
    cannot see, so each graph built under it would stay in memory."""
    if _caller_hooks():
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            yield
    else:
        with torch.enable_grad():
            yield


_DOFS = {}


def _dof_tables(struct: Structure, like: torch.Tensor):
    """Per-dof host tables on ``like``'s device and dtype (made once): the
    owning joint, the constant local axis of translational dofs, masks of
    revolute and rotational dofs, the free3d-exp / euler rotation dofs, the
    parent row of every joint (J = the identity), and anc[k, j] = dof k's
    joint is an ancestor-or-self of joint j."""
    key = (id(struct), like.device, like.dtype)
    hit = _DOFS.get(key)
    if hit is not None and hit[0] is struct:
        return hit[1]
    from . import lanes
    from ..model.schema import (JOINT_FREE3D_EULER, JOINT_FREE3D_EXP,
                                JOINT_REVOLUTE)
    tb = struct.fk_tables
    n, J = struct.ndof_q, struct.njoints
    dof_joint = np.zeros(n, np.int64)
    trans_local = np.zeros((n, 3))
    rev, rot = np.zeros(n), np.zeros(n)
    exp_dofs, eul_dofs = [], []
    for j, jt in enumerate(struct.joint_types):
        for i in range(3):
            d = int(tb["trans_idx"][j, i])
            if d != n:
                dof_joint[d] = j
                trans_local[d] = np.asarray(tb["basis"][j])[:, i]
        ridx = [int(d) for d in tb["rot_idx"][j]]
        if jt == JOINT_REVOLUTE:
            dof_joint[ridx[0]], rev[ridx[0]], rot[ridx[0]] = j, 1.0, 1.0
        elif jt in (JOINT_FREE3D_EXP, JOINT_FREE3D_EULER):
            (exp_dofs if jt == JOINT_FREE3D_EXP else eul_dofs).append(ridx)
            dof_joint[ridx], rot[ridx] = j, 1.0
    li = lambda a: torch.as_tensor(np.asarray(a, np.int64).reshape(-1, 3),
                                   device=like.device)
    fl = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                   dtype=like.dtype, device=like.device)
    t = types.SimpleNamespace(
        dof_joint=torch.as_tensor(dof_joint, device=like.device),
        trans_local=fl(trans_local), rev=fl(rev)[:, None],
        rot_mask=fl(rot), exp_dofs=li(exp_dofs) if exp_dofs else None,
        eul_dofs=li(eul_dofs) if eul_dofs else None,
        parent=torch.as_tensor([p if p >= 0 else J
                                for p in struct.joint_parents],
                               dtype=torch.int64, device=like.device),
        anc=fl(lanes._dof_tables(struct))[:, :, None],          # (n, J, 1)
        eye3=fl(np.eye(3)))
    _DOFS[key] = (struct, t)
    return t


def _jl_cols(r, eye3):
    """Columns of the SO(3) left Jacobian at rotvecs r (k, 3): (k, col, 3)."""
    th2 = torch.sum(r * r, dim=-1)[:, None, None]
    th = torch.sqrt(th2 + 1e-12)
    small = th2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(th2), th2)
    a = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe2)
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (safe2 * th))
    e = eye3[None].expand(r.shape[0], 3, 3)
    rxe = spatial.cross(r[:, None, :], e)
    return e + a * rxe + b * spatial.cross(r[:, None, :], rxe)


def dof_frames(struct: Structure, model: Model, q):
    """Joint frames and per-dof world axes: (jp (J, 3), jq (J, 4), w (n, 3),
    c (n, 3) a point on a rotational dof's axis, rot_mask (n,) 1.0 on
    rotational dofs); row-major and batched over dofs (the lane-major
    ``lanes.dof_frames`` loops over joints)."""
    t = _dof_tables(struct, q)
    jp, jq = kinematics.fk_joints(struct, model, q)
    # frame of each joint before its own variable transform
    pq = torch.cat([jq, kinematics._tables(struct, q).ident[None]])[t.parent]
    Fq = spatial.quat_mul(pq, model.joint_quat)
    local = t.trans_local + t.rev * model.joint_axis0[t.dof_joint]
    if t.exp_dofs is not None:
        cols = _jl_cols(q[t.exp_dofs], t.eye3)
        local = local.index_add(0, t.exp_dofs.reshape(-1),
                                cols.reshape(-1, 3))
    if t.eul_dofs is not None:
        # R = Rx(ex) Ry(ey) Rz(ez): generator axes x, Rx y, Rx Ry z
        ex, ey = q[t.eul_dofs[:, 0]], q[t.eul_dofs[:, 1]]
        cx, sx, cy, sy = torch.cos(ex), torch.sin(ex), torch.cos(ey), \
            torch.sin(ey)
        one, zero = torch.ones_like(ex), torch.zeros_like(ex)
        axes = torch.stack([torch.stack([one, zero, zero], dim=-1),
                            torch.stack([zero, cx, sx], dim=-1),
                            torch.stack([sy, -sx * cy, cx * cy], dim=-1)],
                           dim=1)
        local = local.index_add(0, t.eul_dofs.reshape(-1),
                                axes.reshape(-1, 3))
    w = spatial.quat_rotate(Fq[t.dof_joint], local)
    return jp, jq, w, jp[t.dof_joint], t.rot_mask


def joint_twists(struct: Structure, w, c, rot_mask, v):
    """World twist of every joint frame, (Omega (J, 3), beta (J, 3)): a
    point X rigid with joint j moves at Omega_j x X + beta_j."""
    anc = _dof_tables(struct, w).anc                      # (n, J, 1)
    rm = rot_mask[:, None]
    wv = w * v[:, None]
    omega_terms = rm * wv
    beta_terms = (1.0 - rm) * wv - rm * (spatial.cross(w, c) * v[:, None])
    return (torch.sum(anc * omega_terms[:, None, :], dim=0),
            torch.sum(anc * beta_terms[:, None, :], dim=0))


def twists(struct: Structure, model: Model, q, v):
    """Joint frames and world twists: (jp (J, 3), jq (J, 4), Omega (J, 3),
    beta (J, 3)).

    The exact JVP of FK along v, from the analytic per-dof world axes,
    written as plain reverse-differentiable ops (the JAX package takes
    ``jax.jvp``; PyTorch's forward-mode AD costs some 30x FK on the
    host)."""
    jp, jq, w, c, rot_mask = dof_frames(struct, model, q)
    Om, be = joint_twists(struct, w, c, rot_mask, v)
    return jp, jq, Om, be


def body_velocities(struct: Structure, model: Model, q, v):
    """Body poses and their linear + angular world velocities:
    (p, quat, pdot, w)."""
    jp, jq, Om, be = twists(struct, model, q, v)
    bj = kinematics._tables(struct, q).body_joint
    p, quat = spatial.transform_compose(jp[bj], jq[bj], model.body_pos,
                                        model.body_quat)
    w = Om[bj]
    return p, quat, spatial.cross(w, p) + be[bj], w


def _kinetic(model, quat, pd, w):
    w_local = spatial.mat_tvec(spatial.quat_to_mat(quat), w)
    return (0.5 * torch.sum(model.body_mass * torch.sum(pd * pd, dim=-1))
            + 0.5 * torch.sum(model.body_inertia * w_local * w_local))


def kinetic_energy(struct: Structure, model: Model, q, v):
    _, quat, pd, w = body_velocities(struct, model, q, v)
    return _kinetic(model, quat, pd, w)


def lagrangian(struct: Structure, model: Model, q, v):
    """L = T - V; body positions are shared between T's FK and V."""
    p, quat, pd, w = body_velocities(struct, model, q, v)
    V = -torch.sum(model.body_mass * torch.sum(p * model.gravity, dim=-1))
    return _kinetic(model, quat, pd, w) - V


def el_terms(struct: Structure, model: Model, q, v):
    """(dL/dq, p = dL/dv) in one reverse pass."""
    create = outer_graph(model, q, v)
    with inner_graph():
        q_, v_ = _grad_input(q), _grad_input(v)
        L = lagrangian(struct, model, q_, v_)
        dq, dv = torch.autograd.grad(L, (q_, v_), create_graph=create)
    return dq, dv


def momentum(struct: Structure, model: Model, q, v):
    """Generalized momentum p = dT/dv (equals M(q) v)."""
    create = outer_graph(model, q, v)
    with inner_graph():
        v_ = _grad_input(v)
        T = kinetic_energy(struct, model, q, v_)
        (dv,) = torch.autograd.grad(T, (v_,), create_graph=create)
    return dv


def mass_matrix(struct: Structure, model: Model, q):
    """M(q), column k = p(q, e_k) (p is linear in v); for tests and
    analysis, not the step's hot path."""
    eye = torch.eye(struct.ndof_q, dtype=q.dtype, device=q.device)
    return torch.stack([momentum(struct, model, q, eye[k])
                        for k in range(struct.ndof_q)], dim=1)


def joint_spring_forces(model: Model, q, v):
    """Viscous joint damping + joint-limit penalty."""
    below = contact._relu(model.dof_lim_lower - q)
    above = contact._relu(q - model.dof_lim_upper)
    return -model.dof_damping * v + model.dof_lim_stiffness * (below - above)


def motor_forces(struct: Structure, model: Model, q, v, u):
    """Actuation: u clipped to ctrl_range as min(max()) (``jnp.clip``'s tie
    rule), applied raw as force or as a PD position target."""
    if struct.ndof_u == 0:
        return torch.zeros_like(q)
    dof = kinematics._tables(struct, q).motor_dof
    uc = torch.minimum(torch.maximum(u, model.motor_ctrl_lo),
                       model.motor_ctrl_hi)
    pd = model.motor_kp * (uc - q[dof]) - model.motor_kd * v[dof]
    tau = model.motor_pos_mask * pd + (1.0 - model.motor_pos_mask) * uc
    return torch.zeros_like(q).index_add(0, dof, tau)


# ---------------------------------------------------------------------------
# contact
# ---------------------------------------------------------------------------

_GROUPS = {}


def _group_tables(struct: Structure, device):
    """Every contact group's index tables on ``device`` (made once) and the
    tactile-row scatter table of each."""
    key = (id(struct), device)
    hit = _GROUPS.get(key)
    if hit is not None and hit[0] is struct:
        return hit[1]
    out = []
    for g in struct.contact_groups:
        idx = contact.group_index(g, device)
        idx.rows = torch.as_tensor(np.asarray(g.tac_row, np.int64) + 1,
                                   device=device)
        idx.is_tac = torch.as_tensor(np.asarray(g.tac_row) >= 0,
                                     device=device)[:, None]
        out.append(idx)
    _GROUPS[key] = (struct, out)
    return out


def contact_terms(struct: Structure, model: Model, q, v, tactile=True):
    """All contact and tactile instance forces.

    Returns (Q (n,) generalized contact force, tac_force (Mtot, 3) world
    marker forces; an empty (0, 3) when ``tactile`` is False).

    The joints' twists give point and body velocities; the forces
    act at material points (on the general side at the contact points, for
    analytic sphere contacts at the body-frame surface point; on the
    primitive side at the body-frame coincident point, its local coordinates
    detached), and Q is the pullback of those forces through FK."""
    groups = struct.contact_groups
    ntac = len(struct.tac_joint)
    if not groups:
        return torch.zeros_like(q), q.new_zeros((ntac if tactile else 0, 3))
    create = outer_graph(model, q, v)
    tabs = _group_tables(struct, q.device)
    tb = kinematics._tables(struct, q)
    with inner_graph():
        q_ = _grad_input(q)
        jp, jq, Om, be = twists(struct, model, q_, v)
        bj = tb.body_joint
        bp, bquat = spatial.transform_compose(jp[bj], jq[bj], model.body_pos,
                                              model.body_quat)
        bw = Om[bj]
        bv = spatial.cross(bw, bp) + be[bj]
        pts = torch.cat([
            kinematics._points_world(jp, jq, model.cp_pos, tb.cp_joint),
            kinematics._points_world(jp, jq, model.tac_pos, tb.tac_joint)])
        pj = tb.pts_joint
        pts_dot = spatial.cross(Om[pj], pts) + be[pj]
        bR = spatial.quat_to_mat(bquat)
        params = contact.combined_params(model)
        per_group = [(g, idx) + contact.group_forces(
            g, model, pts, pts_dot, bp, bR, bv, bw, params, idx)
            for g, idx in zip(groups, tabs)]

        # application points and their force cotangents
        outs, cots = [], []
        pts_bar = torch.zeros_like(pts)
        for g, idx, f, x_eff, xi_p in per_group:
            if g.sphere_general:
                gi = idx.point_idx
                qg = bquat[gi]
                xi_g = spatial.quat_rotate(spatial.quat_conj(qg),
                                           x_eff - bp[gi]).detach()
                outs.append(bp[gi] + spatial.quat_rotate(qg, xi_g))
                cots.append(f)
            else:
                pts_bar = pts_bar.index_add(0, idx.point_idx, f)
            if g.gtype != contact.GROUND:
                pi = idx.prim_body
                outs.append(bp[pi] + spatial.quat_rotate(bquat[pi],
                                                         xi_p.detach()))
                cots.append(-f)
        if pts.shape[0]:
            outs.append(pts)
            cots.append(pts_bar)
        (Q,) = torch.autograd.grad(outs, q_, cots, create_graph=create)

        if tactile:
            tac = q.new_zeros((ntac + 1, 3))
            for g, idx, f, _, _ in per_group:
                tac = tac.index_add(0, idx.rows,
                                    torch.where(idx.is_tac, f, 0.0))
            tac = tac[1:]
        else:
            tac = q.new_zeros((0, 3))
    if not create:
        tac = tac.detach()
    return Q, tac


def applied_forces(struct: Structure, model: Model, q, v, u, tactile=True):
    """Non-conservative generalized forces: damping + limits + motors +
    contact (gravity lives in the Lagrangian)."""
    Q_contact, tac_force = contact_terms(struct, model, q, v, tactile)
    Q = (joint_spring_forces(model, q, v)
         + motor_forces(struct, model, q, v, u)
         + Q_contact)
    return Q, tac_force


def tactile_field(struct: Structure, model: Model, q, v):
    """Dense tactile output in the sensor frame: (Mtot, 3) rows of
    [shear_axis0, shear_axis1, normal]."""
    _, tac_force = contact_terms(struct, model, q, v)
    return tactile_field_from_forces(struct, model, q, tac_force)


def tactile_field_from_forces(struct: Structure, model: Model, q, tac_force):
    n_w, a0_w, a1_w = kinematics.tactile_frames_world(struct, model, q)
    return torch.stack([torch.sum(tac_force * a0_w, dim=-1),
                        torch.sum(tac_force * a1_w, dim=-1),
                        torch.sum(tac_force * n_w, dim=-1)], dim=-1)
