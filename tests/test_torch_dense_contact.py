"""K4's plain version and the tactile query against the JAX package (f64).

- ``ops/dense_contact.dense_point_contact`` on CPU tensors (its plain
  version; no launch) against the JAX ``dense_point_contact`` in interpret
  mode, for the four primitive types on the inputs of
  tests/test_ops.py::test_dense_contact_matches_oracle (N = 257), to 1e-12
  of the output's scale: the same arithmetic in the same order, so only
  round-off parts them;
- ``ops/tactile_query.tactile_field`` against the JAX query (interpret
  mode) on TactilePush with the box pressed into the pad and on
  RollingBall 8x8 with the ball 1 mm into the pad, to 1e-10 of scale (the
  port takes the marker velocities from the joints' twists, JAX from a JVP
  of FK: equal up to round-off).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.model.schema import (GEOM_CUBOID, GEOM_CYLINDER,
                                                GEOM_SPHERE)
from tactilesimulation_tpu.ops import dense_contact as jax_dc
from tactilesimulation_tpu.ops import tactile_query as jax_tq
from tactilesimulation_tpu.sim import kinematics as jax_kin
from tactilesimulation_tpu.sim import spatial as jax_spatial
from tactilesimulation_tpu.sim.contact import GROUND
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import dense_contact, tactile_query

torch.set_num_threads(1)

GTYPES = {"ground": GROUND, "cuboid": GEOM_CUBOID,
          "cylinder": GEOM_CYLINDER, "sphere": GEOM_SPHERE}


def _k4_inputs(gtype):
    """The inputs of tests/test_ops.py:46-57 as numpy arrays."""
    rng = np.random.default_rng(0 if gtype == GROUND else gtype)
    N = 257
    x = rng.normal(scale=0.05, size=(N, 3))
    xd = rng.normal(scale=0.2, size=(N, 3))
    R = np.array(jax_spatial.quat_to_mat(jax_spatial.rotvec_to_quat(
        jnp.asarray(rng.normal(size=3) * 0.5))))
    p = rng.normal(scale=0.01, size=3)
    v = rng.normal(size=3) * 0.1
    w = rng.normal(size=3) * 0.5
    return dict(x=x, xd=xd, p=p, R=R, v=v, w=w,
                size=np.array([0.06, 0.04, 0.05]),
                params=np.array([1e4, 5e2, 1.2, 1e3]),
                gpos=np.zeros(3), gn=np.array([0.0, 0.0, 1.0]))


def _call(fn, gtype, a, wrap):
    t = {k: wrap(v) for k, v in a.items()}
    return fn(gtype, t["x"], t["xd"], (t["p"], t["R"]), (t["v"], t["w"]),
              t["size"], t["params"], (t["gpos"], t["gn"]))


@pytest.mark.parametrize("name", sorted(GTYPES))
def test_k4_plain_version_matches_jax(name):
    gtype = GTYPES[name]
    a = _k4_inputs(gtype)
    want = np.asarray(_call(
        lambda *args: jax_dc.dense_point_contact(*args, True), gtype, a,
        jnp.asarray))
    dense_contact.reset_counts()
    got = _call(dense_contact.dense_point_contact, gtype, a, torch.as_tensor)
    # a CPU tensor takes the plain version, and nothing is launched
    assert dense_contact.launches == 0
    ref = _call(dense_contact.dense_point_contact_ref, gtype, a,
                torch.as_tensor)
    assert torch.equal(got, ref)
    scale = float(np.abs(want).max())
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-12 * scale
    # points in contact and points out of it
    active = int((np.abs(want).sum(axis=1) > 0).sum())
    assert 0 < active < want.shape[0]


def _pressed_state(name):
    """(jax struct, jax model, torch struct, torch model, q, v) with the
    sensor's primitive pressed into the tactile markers."""
    if name == "tactile_push":
        # the recipe of tests/test_ops.py:68-87: the box face 1 mm into the
        # pad
        sj, mj = jax_scenes.tactile_push()
        st, _ = torch_scenes.tactile_push()
        rng = np.random.default_rng(3)
        var = np.asarray(jax_kin.ee_positions(sj, mj, mj.q_init)).reshape(2, 3)
        off = sj.joint_dof_offset[sj.joint_index("box_translational_joint")]
        q = np.array(mj.q_init)
        q[off:off + 3] += var[0] - var[1] - np.array([0.001, 0.0, 0.0])
        v = rng.normal(scale=0.1, size=sj.ndof_q)
    else:
        # the pad's underside (z = 0.055) 1 mm below the ball's top (0.04)
        sj, mj = jax_scenes.rolling_ball(resolution=8)
        st, _ = torch_scenes.rolling_ball(resolution=8)
        rng = np.random.RandomState(5)
        q = np.array(mj.q_init)
        q[2] = -0.016
        q[3:6] += 1e-3 * rng.randn(3)
        q[6:9] = 0.1 * rng.randn(3)
        v = 0.05 * rng.randn(sj.ndof_q)
    leaves = {f.name: np.asarray(getattr(mj, f.name))
              for f in dataclasses.fields(mj)}
    return sj, mj, st, convert.model_from_numpy(leaves), q, v


@pytest.mark.parametrize("name", ["tactile_push", "rolling_ball_8"])
def test_tactile_query_matches_jax(name):
    sj, mj, st, mt, q, v = _pressed_state(name)
    assert tactile_query.supported(st) == jax_tq.supported(sj) == True
    want = np.asarray(jax_tq.tactile_field(sj, mj, jnp.asarray(q),
                                           jnp.asarray(v), interpret=True))
    dense_contact.reset_counts()
    got = tactile_query.tactile_field(st, mt, torch.as_tensor(q),
                                      torch.as_tensor(v))
    assert dense_contact.launches == 0
    assert tuple(got.shape) == want.shape == (st.ndof_tactile // 3, 3)
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(want[:, 2]).max()) > 0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-10 * scale
