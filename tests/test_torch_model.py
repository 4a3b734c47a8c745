"""The port's scene compiler against the JAX package's, exactly.

Every ``Model`` leaf, the FK tables, the contact groups and the pair-wrench
segments of the port's ``task_scenes`` scenes must equal the JAX builder's
(float64, bit for bit: both run the same numpy arithmetic).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.ops import lane_contact as jax_lane_contact
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import lane_contact as torch_lane_contact
from tactilesimulation_tpu_torch.sim.types import Model

torch.set_num_threads(1)

SCENES = {
    "tactile_push": lambda m: m.tactile_push(),
    "rolling_ball_8": lambda m: m.rolling_ball(resolution=8),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    build = SCENES[request.param]
    return build(jax_scenes), build(torch_scenes)


def test_model_leaves_equal(scenes):
    (_, mj), (_, mt) = scenes
    names = [f.name for f in dataclasses.fields(Model)]
    assert names == [f.name for f in dataclasses.fields(type(mj))]
    for name in names:
        a = np.asarray(getattr(mj, name))
        b = getattr(mt, name)
        assert b.dtype == torch.float64, name
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def test_structure_tables_equal(scenes):
    (sj, _), (st, _) = scenes
    plain = ("name", "integrator", "njoints", "nbodies", "ndof_q", "ndof_u",
             "ndof_var", "ndof_tactile", "joint_types", "joint_parents",
             "joint_dof_offset", "joint_ndof", "joint_names", "body_joint",
             "body_gtype", "body_names", "motor_dof", "cp_joint", "tac_joint",
             "ee_joint", "ee_names", "virtual_names", "has_ground",
             "solver_tol", "solver_max_iter", "solver_max_ls")
    for name in plain:
        assert getattr(st, name) == getattr(sj, name), name
    for a, b in zip(sj.pairs + sj.tactile_pairs, st.pairs + st.tactile_pairs):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert len(sj.sensors) == len(st.sensors)
    for a, b in zip(sj.sensors, st.sensors):
        assert (a.name, a.body, a.marker_start, a.marker_count, a.rows,
                a.cols) == (b.name, b.body, b.marker_start, b.marker_count,
                            b.rows, b.cols)
        np.testing.assert_array_equal(a.image_pos, b.image_pos)

    tj, tt = sj.fk_tables, st.fk_tables
    assert sorted(tj) == sorted(tt)
    for key in ("trans_idx", "rot_idx", "basis", "m_rev", "m_exp", "m_eul"):
        np.testing.assert_array_equal(tt[key], tj[key], err_msg=key)
    assert len(tj["levels"]) == len(tt["levels"])
    for (ij, pj, rj), (it, pt, rt) in zip(tj["levels"], tt["levels"]):
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(pt, pj)
        assert rj == rt

    assert len(sj.contact_groups) == len(st.contact_groups)
    for gj, gt in zip(sj.contact_groups, st.contact_groups):
        assert (gj.gtype, gj.sphere_general) == (gt.gtype, gt.sphere_general)
        for key in ("point_idx", "general_body", "prim_body", "param_idx",
                    "tac_row"):
            np.testing.assert_array_equal(getattr(gt, key), getattr(gj, key),
                                          err_msg=key)


def test_segments_equal(scenes):
    (sj, _), (st, _) = scenes
    segs_j, rows_j, src_j, packed_j = jax_lane_contact.build_segments(sj)
    segs_t, rows_t, src_t, packed_t = torch_lane_contact.build_segments(st)
    assert [dataclasses.astuple(s) for s in segs_t] == \
        [dataclasses.astuple(s) for s in segs_j]
    assert rows_t == rows_j
    np.testing.assert_array_equal(src_t, src_j)
    np.testing.assert_array_equal(packed_t, packed_j)


def test_model_to_moves_every_leaf():
    _, mt = torch_scenes.tactile_push()
    m32 = mt.to("cpu", torch.float32)
    for f in dataclasses.fields(Model):
        leaf = getattr(m32, f.name)
        assert leaf.dtype == torch.float32, f.name
        np.testing.assert_array_equal(
            leaf.numpy(), getattr(mt, f.name).numpy().astype(np.float32))
