"""The port's single-instance sim core against the JAX package (f64).

On RollingBall 8x8 (the pad pressed onto the ball, the ball on the ground)
and TactilePush (the pad pressed into the box, the box into the ground), at
seeded states in contact, to 1e-10 of each output's scale:
- FK: ``fk_bodies``, ``fk_all``, ``tactile_frames_world``,
  ``contact_points_world``, ``tactile_points_world``, ``ee_positions``;
- dynamics: ``el_terms``, ``momentum``, ``mass_matrix`` (the port takes the
  body velocities from the joints' twists, JAX from a JVP of FK);
- contact: the row-major ``dynamics.contact_terms`` and ``tactile_field``
  and the points-major ``dense_single.contact_terms_points_major``.
The JAX side is one jitted function per scene.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import dense_single as jax_ds
from tactilesimulation_tpu.sim import dynamics as jax_dyn
from tactilesimulation_tpu.sim import kinematics as jax_kin
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.sim import dense_single, dynamics, kinematics

torch.set_num_threads(1)

TOL = 1e-10


def contact_state(name, q_init, seed=0):
    rng = np.random.RandomState(seed)
    q = q_init + 1e-3 * rng.randn(q_init.shape[0])
    if name == "tactile_push":
        q[1] = 0.002                     # pad into the box
        q[5] = -0.0005                   # box into the ground
    else:
        q[2] = -0.0175                   # pad onto the ball
        q[5] = -0.0005                   # ball into the ground
    return q, 0.1 * rng.randn(q_init.shape[0])


def _jax_outputs(sj):
    def fn(m, q, v):
        out = {"fk_bodies": jax_kin.fk_bodies(sj, m, q),
               "fk_all": jax_kin.fk_all(sj, m, q),
               "frames": jax_kin.tactile_frames_world(sj, m, q),
               "contact_points": jax_kin.contact_points_world(sj, m, q),
               "tactile_points": jax_kin.tactile_points_world(sj, m, q),
               "ee": jax_kin.ee_positions(sj, m, q),
               "el_terms": jax_dyn.el_terms(sj, m, q, v),
               "momentum": jax_dyn.momentum(sj, m, q, v),
               "mass": jax_dyn.mass_matrix(sj, m, q),
               "contact": jax_dyn.contact_terms(sj, m, q, v),
               "tactile": jax_dyn.tactile_field(sj, m, q, v),
               "points_major": jax_ds.contact_terms_points_major(sj, m, q, v)}
        return out
    return jax.jit(fn)


@pytest.fixture(scope="module", params=["rolling_ball_8", "tactile_push"])
def scene(request):
    name = request.param
    build = {"rolling_ball_8": lambda m: m.rolling_ball(resolution=8),
             "tactile_push": lambda m: m.tactile_push()}[name]
    sj, mj = build(jax_scenes)
    st, _ = build(torch_scenes)
    mt = convert.model_from_numpy({f.name: np.asarray(getattr(mj, f.name))
                                   for f in dataclasses.fields(mj)})
    q, v = contact_state(name, np.asarray(mj.q_init))
    want = jax.tree.map(np.asarray,
                        _jax_outputs(sj)(mj, jnp.asarray(q), jnp.asarray(v)))
    return dict(st=st, mt=mt, q=torch.as_tensor(q), v=torch.as_tensor(v),
                want=want)


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    got = got.detach().numpy()
    assert got.shape == want.shape
    if want.size:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= TOL * scale


def test_kinematics(scene):
    st, mt, q, want = scene["st"], scene["mt"], scene["q"], scene["want"]
    _close(kinematics.fk_bodies(st, mt, q), want["fk_bodies"])
    _close(kinematics.fk_all(st, mt, q), want["fk_all"])
    _close(kinematics.tactile_frames_world(st, mt, q), want["frames"])
    _close(kinematics.contact_points_world(st, mt, q),
           want["contact_points"])
    _close(kinematics.tactile_points_world(st, mt, q),
           want["tactile_points"])
    _close(kinematics.ee_positions(st, mt, q), want["ee"])


def test_dynamics(scene):
    st, mt, q, v, want = (scene[k] for k in ("st", "mt", "q", "v", "want"))
    _close(dynamics.el_terms(st, mt, q, v), want["el_terms"])
    _close(dynamics.momentum(st, mt, q, v), want["momentum"])
    _close(dynamics.mass_matrix(st, mt, q), want["mass"])


def test_contact(scene):
    st, mt, q, v, want = (scene[k] for k in ("st", "mt", "q", "v", "want"))
    Q, tac = dynamics.contact_terms(st, mt, q, v)
    _close((Q, tac), want["contact"])
    assert float(np.abs(want["contact"][1]).max()) > 0     # markers touch
    _close(dynamics.tactile_field(st, mt, q, v), want["tactile"])
    _close(dense_single.contact_terms_points_major(st, mt, q, v),
           want["points_major"])
