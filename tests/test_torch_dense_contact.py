"""K4's plain version and the tactile query against the JAX package (f64).

- ``ops/dense_contact.dense_point_contact`` on CPU tensors (its plain
  version; no launch) against the JAX ``dense_point_contact`` in interpret
  mode, for the four primitive types on the inputs of
  tests/test_ops.py::test_dense_contact_matches_oracle (N = 257), to 1e-12
  of the output's scale: the same arithmetic in the same order, so only
  round-off parts them;
- ``ops/tactile_query.tactile_field`` against the JAX query (interpret
  mode) on TactilePush with the box pressed into the pad, RollingBall 8x8
  with the ball 1 mm into the pad, TactileInsertion and DClaw, pressed as
  ``chip_smoke.read_state`` presses them (their pairs keep their rows
  apart), to 1e-10 of scale (the port takes the marker velocities from
  the joints' twists, JAX from a JVP of FK: equal up to round-off);
- the query where pairs share marker rows (StableGrasp's pads against the
  bar's 11 blocks; a pad on the ground and a coin) against JAX's
  ``dynamics.tactile_field``, which adds the pairs' forces per row (the
  JAX query writes each pair's rows, so there the last pair wins);
- ``megastep_host.HostTactileRead``, the read kernel's CUDA source built
  with g++, against JAX's ``dynamics.tactile_field`` on the seven scenes of
  ``chip_smoke.READ_SCENES``, to 1e-12 of scale; and the read plan made
  again after a model edit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megastep_host
from chip_smoke import READ_SCENES, read_scene, read_state
from tactilesimulation_tpu.model import scenes as jax_scene_builder
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.model.schema import (GEOM_CUBOID, GEOM_CYLINDER,
                                                GEOM_SPHERE)
from tactilesimulation_tpu.ops import dense_contact as jax_dc
from tactilesimulation_tpu.ops import tactile_query as jax_tq
from tactilesimulation_tpu.sim import dynamics as jax_dyn
from tactilesimulation_tpu.sim import spatial as jax_spatial
from tactilesimulation_tpu.sim.contact import GROUND
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.model import scenes as torch_scene_builder
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


def _leaves(model):
    return {f.name: np.asarray(getattr(model, f.name))
            for f in dataclasses.fields(model)}


def _pressed_state(name):
    """(jax struct, jax model, torch struct, torch model, q, v) at
    ``chip_smoke.read_state``'s pressed state of scene ``name`` (with its
    model edits); the port's model is made from the JAX model's leaves."""
    sj, mj = read_scene(name, jax_scenes, jax_scene_builder)
    st, mt = read_scene(name, torch_scenes, torch_scene_builder)
    q, v, edits = read_state(name, st, mt)
    mj = dataclasses.replace(mj, **{k: jnp.asarray(a)
                                    for k, a in edits.items()})
    return sj, mj, st, convert.model_from_numpy(_leaves(mj)), q, v


@pytest.mark.parametrize("name", ["tactile_push", "rolling_ball_8",
                                  "tactile_insertion", "dclaw"])
def test_tactile_query_matches_jax(name):
    sj, mj, st, mt, q, v = _pressed_state(name)
    assert tactile_query.supported(st) == jax_tq.supported(sj) == True
    want = np.asarray(jax_tq.tactile_field(sj, mj, jnp.asarray(q),
                                           jnp.asarray(v), interpret=True))
    dense_contact.reset_counts()
    got = tactile_query.tactile_field(st, mt, torch.as_tensor(q),
                                      torch.as_tensor(v))
    assert dense_contact.launches == dense_contact.read_launches == 0
    assert tuple(got.shape) == want.shape == (st.ndof_tactile // 3, 3)
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(want[:, 2]).max()) > 0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-10 * scale


def _jax_field(sj, mj, q, v):
    """JAX's step-side field (``dynamics.tactile_field``, jitted: a tenth
    of its eager time): the pairs' forces added per marker row."""
    field = jax.jit(lambda m, q, v: jax_dyn.tactile_field(sj, m, q, v))
    return np.asarray(field(mj, jnp.asarray(q), jnp.asarray(v)))


@pytest.mark.parametrize("name", ["stable_grasp", "ground_pad"])
def test_tactile_query_sums_pairs_that_share_rows(name):
    """StableGrasp's pads hold 11 pairs each in the same 130 rows (one per
    block of the bar); ground_pad's 64 rows hold the ground's pair and the
    coin's. The query adds them per row as the step does."""
    sj, mj, st, mt, q, v = _pressed_state(name)
    rows = {}
    for p in st.tactile_pairs:
        rows.setdefault((p.point_start, p.point_count), []).append(p)
    assert max(len(ps) for ps in rows.values()) == (
        11 if name == "stable_grasp" else 2)
    want = _jax_field(sj, mj, q, v)
    got = tactile_query.tactile_field(st, mt, torch.as_tensor(q),
                                      torch.as_tensor(v)).numpy()
    scale = float(np.abs(want).max())
    in_contact = int((np.abs(want).sum(axis=1) > 0).sum())
    assert in_contact >= (100 if name == "stable_grasp" else 40)
    assert float(np.abs(got - want).max()) <= 1e-10 * scale


@pytest.fixture(scope="module")
def host_read():
    if not megastep_host.available():
        pytest.skip("needs g++ to build the read kernel's source on the host")
    return megastep_host.HostTactileRead()


@pytest.mark.parametrize("name", READ_SCENES)
def test_host_tactile_read_matches_jax(host_read, name):
    """The read kernel's prologue and rows (csrc/dense_contact.cu, g++,
    float64) against JAX's step-side field: the kernel takes the marker
    velocities from its FK's dual part, JAX from the JVP of its FK, and the
    orders of the sums differ, so only round-off parts them."""
    sj, mj, st, mt, q, v = _pressed_state(name)
    want = _jax_field(sj, mj, q, v)
    got = host_read.field(st, mt, q, v).numpy()
    assert got.shape == want.shape == (st.ndof_tactile // 3, 3)
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(want[:, :2]).max()) > 0
    assert float(np.abs(got - want).max()) <= 1e-12 * scale
    assert host_read.count(st, mt, q, v) > 0


def test_read_plan_follows_model_edits():
    """The read plan is made once per (struct, model) and made again when a
    leaf it packed is replaced or changed in place; on the CPU it is only
    built (the kernel runs on the card)."""
    st, mt = torch_scenes.rolling_ball(resolution=8)
    plan = tactile_query.read_plan(st, mt)
    assert tactile_query.read_plan(st, mt) is plan and plan.fresh()
    assert plan.floats.dtype == torch.float64 and plan.N == 64
    mt.body_size[1, 0] += 1e-3                      # in place
    assert not plan.fresh()
    edited = tactile_query.read_plan(st, mt)
    assert edited is not plan and edited.fresh()
    assert not torch.equal(edited.floats, plan.floats)
    moved = dataclasses.replace(mt, tac_kn=mt.tac_kn * 2.0)
    assert tactile_query.read_plan(st, moved) is not edited
    assert tactile_query.read_plan(st, mt) is edited
