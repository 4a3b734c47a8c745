"""Host-side forward-kinematics tables (the part of the JAX package's
``sim/kinematics.py`` that the model builder needs).

The batched FK itself lives in ``sim/lanes.py`` (lane-major, batch-last)."""

from __future__ import annotations

import numpy as np

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
