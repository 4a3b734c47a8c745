"""Reduced-coordinate forward kinematics of one instance or a batch of them
(row-major: q (..., n), frames (..., J, 3) / (..., J, 4); the single
instance is the empty batch shape), and the host-side FK tables the builder
compiles. Model leaves are shared or carry the same leading batch axes.

Port of ``tactilesimulation_tpu/sim/kinematics.py``. Child joint frames are
given in the parent joint's frame; free joints order their dofs translation
then rotation. The batched (lane-major) FK lives in ``sim/lanes.py``.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from . import spatial
from ..model.schema import (JOINT_FREE3D_EULER, JOINT_FREE3D_EXP, JOINT_NDOF,
                            JOINT_PLANAR, JOINT_PRISMATIC, JOINT_REVOLUTE,
                            JOINT_TRANSLATIONAL)


def build_fk_tables(joint_types, joint_parents, joint_dof_offset, axis0, axis1):
    """Compile the vectorized-FK tables (called by ``model/builder.py``).

    - trans_idx (J,3): q indices (padded-zero slot = ndof) whose gathered
      values, contracted with basis (J,3,3), give every joint's local
      translation at once;
    - rot_idx (J,3) + masks m_rev/m_exp/m_eul (J,1): the rotation dofs that
      feed the axis-angle / exp-map / euler quaternion formulas;
    - levels: topological depth levels (joints at equal depth compose from
      their parents in one batched transform).
    """
    J = len(joint_types)
    ndof = 0
    for j in range(J):
        ndof = max(ndof, joint_dof_offset[j] + JOINT_NDOF[joint_types[j]])
    pad = ndof  # index of the zero slot in q_pad

    trans_idx = np.full((J, 3), pad, dtype=np.int32)
    rot_idx = np.full((J, 3), pad, dtype=np.int32)
    basis = np.zeros((J, 3, 3))
    m_rev = np.zeros((J, 1))
    m_exp = np.zeros((J, 1))
    m_eul = np.zeros((J, 1))
    eye = np.eye(3)
    for j in range(J):
        t, off = joint_types[j], joint_dof_offset[j]
        if t == JOINT_PRISMATIC:
            trans_idx[j, 0] = off
            basis[j, :, 0] = axis0[j]
        elif t == JOINT_PLANAR:
            trans_idx[j, 0:2] = [off, off + 1]
            basis[j, :, 0] = axis0[j]
            basis[j, :, 1] = axis1[j]
        elif t in (JOINT_TRANSLATIONAL, JOINT_FREE3D_EXP, JOINT_FREE3D_EULER):
            trans_idx[j] = [off, off + 1, off + 2]
            basis[j] = eye
        if t == JOINT_REVOLUTE:
            rot_idx[j, 0] = off
            m_rev[j] = 1.0
        elif t == JOINT_FREE3D_EXP:
            rot_idx[j] = [off + 3, off + 4, off + 5]
            m_exp[j] = 1.0
        elif t == JOINT_FREE3D_EULER:
            rot_idx[j] = [off + 3, off + 4, off + 5]
            m_eul[j] = 1.0

    depth = [0] * J
    for j in range(J):
        depth[j] = 0 if joint_parents[j] < 0 else depth[joint_parents[j]] + 1
    levels = []
    for d in range(max(depth) + 1 if J else 0):
        idx = np.asarray([j for j in range(J) if depth[j] == d],
                         dtype=np.int32)
        par = np.asarray([max(joint_parents[j], 0) for j in idx],
                         dtype=np.int32)
        levels.append((idx, par, d == 0))
    return {"trans_idx": trans_idx, "rot_idx": rot_idx, "basis": basis,
            "m_rev": m_rev, "m_exp": m_exp, "m_eul": m_eul,
            "levels": tuple(levels)}


# ---------------------------------------------------------------------------
# per-(scene, device, dtype) constant tables
#
# Indexing a CUDA tensor with a host array copies the index to the card on
# every call, so each table is moved to the device once and kept.
# ---------------------------------------------------------------------------

_TABLES = {}


def _tables(struct, like: torch.Tensor):
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
    t.trans_idx = li(tb["trans_idx"])                          # (J, 3)
    t.rot_idx = li(tb["rot_idx"])                              # (J, 3)
    t.basis = fl(tb["basis"])                                  # (J, 3, 3)
    t.m_rev, t.m_exp, t.m_eul = fl(tb["m_rev"]), fl(tb["m_exp"]), \
        fl(tb["m_eul"])                                        # (J, 1)
    t.levels = [(li(idx), li(par), bool(root))
                for idx, par, root in tb["levels"]]
    t.ident = fl([1.0, 0.0, 0.0, 0.0])
    t.eye3 = fl(np.eye(3))
    t.body_joint = li(struct.body_joint)
    t.cp_joint = li(struct.cp_joint)
    t.tac_joint = li(struct.tac_joint)
    t.pts_joint = torch.cat([t.cp_joint, t.tac_joint])
    t.ee_joint = li(struct.ee_joint)
    t.motor_dof = li(struct.motor_dof)
    _TABLES[key] = (struct, t)
    return t


def fk_joints(struct, model, q):
    """World pose of every joint frame: (p (..., J, 3), quat (..., J, 4)).

    Batched local transforms over all joints, then depth-level chain
    composition: joints at one tree depth compose from their parents in one
    batched quaternion op (``build_fk_tables``)."""
    tb = _tables(struct, q)
    q_pad = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    qt = q_pad[..., tb.trans_idx]                              # (..., J, 3)
    trans_local = torch.sum(tb.basis * qt[..., None, :], dim=-1)
    qr = q_pad[..., tb.rot_idx]                                # (..., J, 3)
    aa = spatial.axis_angle_quat(model.joint_axis0, qr[..., 0])
    expq = spatial.rotvec_to_quat(qr)
    eulq = spatial.euler_xyz_to_quat(qr)
    m_id = 1.0 - tb.m_rev - tb.m_exp - tb.m_eul
    quat_local = (tb.m_rev * aa + tb.m_exp * expq + tb.m_eul * eulq
                  + m_id * tb.ident[None, :])
    # frame offset then variable transform (batched)
    p_loc = model.joint_pos + spatial.quat_rotate(model.joint_quat,
                                                  trans_local)
    q_loc = spatial.quat_mul(model.joint_quat, quat_local)

    wp = p_loc.new_zeros(p_loc.shape)
    wq = tb.ident.expand(q_loc.shape).contiguous()
    for idx, par, is_root in tb.levels:
        if is_root:
            wp = wp.index_copy(-2, idx, p_loc[..., idx, :])
            wq = wq.index_copy(-2, idx, q_loc[..., idx, :])
        else:
            bp, bq = wp[..., par, :], wq[..., par, :]
            wp = wp.index_copy(-2, idx, bp + spatial.quat_rotate(
                bq, p_loc[..., idx, :]))
            wq = wq.index_copy(-2, idx, spatial.quat_mul(
                bq, q_loc[..., idx, :]))
    return wp, wq


def fk_bodies(struct, model, q):
    """World pose of every body (COM) frame: (p (..., NB, 3), quat
    (..., NB, 4))."""
    jp, jq = fk_joints(struct, model, q)
    bj = _tables(struct, q).body_joint
    return spatial.transform_compose(jp[..., bj, :], jq[..., bj, :],
                                     model.body_pos, model.body_quat)


def _points_world(jp, jq, points, idx):
    if len(idx) == 0:
        return jp.new_zeros(jp.shape[:-2] + (0, 3))
    return spatial.transform_apply(jp[..., idx, :], jq[..., idx, :], points)


def points_world(struct, model, q, points, joint_index):
    """Joint-frame point set to world; ``joint_index`` is a host sequence of
    owning joints or its index tensor on q's device."""
    if len(joint_index) == 0:
        return q.new_zeros(q.shape[:-1] + (0, 3))
    jp, jq = fk_joints(struct, model, q)
    if not isinstance(joint_index, torch.Tensor):
        joint_index = torch.as_tensor(np.asarray(joint_index, np.int64),
                                      device=q.device)
    return _points_world(jp, jq, points, joint_index)


def contact_points_world(struct, model, q):
    return points_world(struct, model, q, model.cp_pos,
                        _tables(struct, q).cp_joint)


def tactile_points_world(struct, model, q):
    return points_world(struct, model, q, model.tac_pos,
                        _tables(struct, q).tac_joint)


def tactile_frames_world(struct, model, q):
    """Per-marker sensor axes in world: (normal, axis0, axis1), each
    (..., M, 3)."""
    if len(struct.tac_joint) == 0:
        z = q.new_zeros(q.shape[:-1] + (0, 3))
        return z, z, z
    _, jq = fk_joints(struct, model, q)
    qw = jq[..., _tables(struct, q).tac_joint, :]
    return (spatial.quat_rotate(qw, model.tac_normal),
            spatial.quat_rotate(qw, model.tac_axis0),
            spatial.quat_rotate(qw, model.tac_axis1))


def fk_all(struct, model, q):
    """One-pass FK for the contact pipeline: body poses and the combined
    [contact points; tactile markers] world array, from one set of joint
    transforms."""
    tb = _tables(struct, q)
    jp, jq = fk_joints(struct, model, q)
    bj = tb.body_joint
    bp, bquat = spatial.transform_compose(jp[..., bj, :], jq[..., bj, :],
                                          model.body_pos, model.body_quat)
    pts = torch.cat([_points_world(jp, jq, model.cp_pos, tb.cp_joint),
                     _points_world(jp, jq, model.tac_pos, tb.tac_joint)],
                    dim=-2)
    return bp, bquat, pts


def ee_positions(struct, model, q):
    """Stacked world positions of the end-effector markers, (..., 3 NE): the
    reference's ``get_variables()``."""
    if len(struct.ee_joint) == 0:
        return q.new_zeros(q.shape[:-1] + (0,))
    return points_world(struct, model, q, model.ee_pos,
                        _tables(struct, q).ee_joint).flatten(-2)
