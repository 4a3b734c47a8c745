"""The port's single-instance backward against the JAX package (f64, CPU),
on the small scenes:

- ``scenes.falling_box`` (6 dofs, ground contact, row-major contact,
  BDF1): 5 steps of a box sliding through contact, the gradient of seeded
  cotangents on q w.r.t. q0, qdot0 and every Model leaf against JAX's
  ``jax.vjp`` through ``Simulator._step`` (``jax_step_vjp``), within 1e-7
  of scale;
- JAX's ``test_design_parameter_gradients`` protocol (d q_T[2] / d s
  with body_mass scaled by s; the state requires no grad, so the first
  step's momentum depends on the mass alone), from the model's initial
  state and from a state in contact: against JAX and against central
  differences (rtol 1e-4);
- the facade's ``backward()`` and ``backward_steps(n)`` on
  ``scenes.pendulum(damping=0.05)`` against the JAX facade's (JAX's
  ``tests/test_facade.py`` protocol, with ``flag_p``: ``df_dp`` leaf by
  leaf);
- each ``update_*`` edit leaves the port's Model equal to the JAX facade's
  after the same edits, and a tactile read after an edit sees it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import scenes as jax_scenes
from tactilesimulation_tpu.model import task_scenes as jax_task_scenes
from tactilesimulation_tpu.sim import simulation as jax_sim
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.model import scenes as torch_scenes
from tactilesimulation_tpu_torch.model import task_scenes as torch_task_scenes
from tactilesimulation_tpu_torch.sim import simulation

from test_torch_backward import (LEAVES, close, close_model, jax_rollout_vjp,
                                 jax_step_vjp, leaves, port_rollout_vjp,
                                 pressed)

torch.set_num_threads(1)

BOX = dict(kn=1e3, kt=5.0, mu=0.8, damping=1.0)


@pytest.fixture(scope="module")
def box():
    sj, mj = jax_scenes.falling_box(**BOX)
    st, _ = torch_scenes.falling_box(**BOX)
    mt = convert.model_from_numpy(leaves(mj))
    jsim = jax_sim.Simulator(sj, mj)
    tsim = simulation.Simulator(st, mt)
    assert not tsim.points_major and st.integrator == "BDF1"
    return dict(sj=sj, mj=mj, st=st, mt=mt, tsim=tsim,
                fn=jax_step_vjp(jsim, False))


def test_rollout_gradient_matches_jax(box):
    """5 steps from just above the ground, sliding and spinning into it."""
    q0 = np.array([0.0, 0.0, -0.145, 0.1, 0.05, 0.0])
    v0 = np.array([0.5, 0.0, -0.3, 0.1, 0.0, 0.2])
    T, n = 5, box["st"].ndof_q
    us = np.zeros((T, 0))
    cq = np.random.RandomState(4).randn(T, n)
    ctac = np.zeros((T, 0))
    s0 = box["tsim"].init_state(q=q0, qdot=v0)
    got = port_rollout_vjp(box["tsim"], box["mt"], s0, us, cq, ctac)
    want = jax_rollout_vjp(box["fn"], box["mj"], (q0, v0, q0, v0, 0), us,
                           cq, ctac)
    assert float(want[0][:, 2].min()) < -0.15         # through the ground
    for g, w, what in zip(got[:4], want[:4], ("qs", "tactiles", "q0",
                                              "qdot0")):
        close(g, w, what=what)
    close_model(got[5], want[5], box["mj"])


@pytest.mark.parametrize("case", ["jax_protocol", "in_contact"])
def test_design_parameter_gradient(box, case):
    """d q_T[2] / d s, body_mass -> s body_mass, 5 steps; the state
    requires no grad, so the first step's momentum carries the mass's
    cotangent alone. ``jax_protocol``: JAX's test (``falling_box()``, the
    model's initial state, its tolerances): a free fall, whose gradient is
    zero to round-off. ``in_contact``: the box sliding through the ground,
    where the mass moves the result."""
    st, tsim = box["st"], box["tsim"]
    if case == "jax_protocol":
        mj = jax_scenes.falling_box()[1]
        q0, v0 = np.asarray(mj.q_init), np.asarray(mj.qdot_init)
    else:
        mj = box["mj"]
        q0 = np.array([0.0, 0.0, -0.145, 0.1, 0.05, 0.0])
        v0 = np.array([0.5, 0.0, -0.3, 0.1, 0.0, 0.2])
    mt = convert.model_from_numpy(leaves(mj))

    def loss(s):
        m = dataclasses.replace(mt, body_mass=mt.body_mass * s)
        state = tsim.init_state(m, q=q0, qdot=v0)
        for _ in range(5):
            state = tsim.step(m, state, torch.zeros(0, dtype=torch.float64))
        return state.q[2]

    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(s), s)
    eps = 1e-6
    with torch.no_grad():
        fd = (float(loss(torch.tensor(1.0 + eps, dtype=torch.float64)))
              - float(loss(torch.tensor(1.0 - eps, dtype=torch.float64)))) \
            / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-4, atol=1e-9)
    # JAX: the mass leaf's cotangent of the same rollout, contracted with
    # d body_mass / d s = body_mass
    cq = np.zeros((5, st.ndof_q))
    cq[-1, 2] = 1.0
    *_, gm = jax_rollout_vjp(box["fn"], mj, (q0, v0, q0, v0, 0),
                             np.zeros((5, 0)), cq, np.zeros((5, 0)))
    want = float(np.sum(gm["body_mass"] * np.asarray(mj.body_mass)))
    if case == "in_contact":
        assert abs(want) > 1e-4
    np.testing.assert_allclose(float(g), want, rtol=1e-7, atol=1e-12)


def test_facade_backward_matches_jax_facade():
    """The JAX facade test's protocol (``tests/test_facade.py``): 6 steps
    of ``forward(1)``, ``backward()`` with df_dq = 1, then
    ``backward_steps(3)`` on the last q; every flag on."""
    T = 6
    q0 = np.array([0.3])
    us = 0.2 * np.sin(np.arange(T))[:, None]
    sj, mj = jax_scenes.pendulum(damping=0.05)
    st, _ = torch_scenes.pendulum(damping=0.05)
    sims = (jax_sim.Simulation((sj, mj)),
            simulation.Simulation((st, convert.model_from_numpy(leaves(mj))),
                                  device="cpu"))
    got = []
    for sim in sims:
        sim.set_state_init(q0, np.array([0.1]))
        sim.reset(backward_flag=True)
        for t in range(T):
            sim.set_u(us[t])
            sim.forward(1)
        bi = sim.backward_info
        bi.set_flags(flag_q0=True, flag_qdot0=True, flag_p=True, flag_u=True)
        bi.df_dq = np.ones(T)
        bi.df_dvar = np.zeros(0)
        bi.df_dtactile = np.zeros(0)
        sim.backward()
        r = sim.backward_results
        out = [r.df_dq0, r.df_dqdot0, r.df_du, leaves(r.df_dp)]
        bi.df_dq = np.zeros(3)
        bi.df_dq[-1] = 1.0
        sim.backward_steps(3)
        out += [r.df_dq0, r.df_dqdot0, r.df_du]
        got.append(out)
    want, got = got
    assert got[2].shape == (T,) and got[6].shape == (3,)
    for i in (0, 1, 2, 4, 5, 6):
        close(got[i], want[i], what=str(i))
    assert abs(got[6][-1]) > 0
    close_model(got[3], want[3], mj)


def _edit(sim):
    """The same edits on a port facade and a JAX facade of TactilePush."""
    sim.update_body_density("box", 800.0)
    sim.update_body_color("box", [0.1, 0.2, 0.3])
    sim.update_body_size("box", [0.06, 0.05, 0.04])                 # cuboid
    sim.update_body_size("tactile_pad_left", [0.004, 0.012])     # cylinder
    sim.update_body_density("tactile_pad_left", 1500.0)
    sim.update_joint_damping("box", 0.3)
    sim.update_joint_location("finger_left_joint", [0.01, -0.02, 0.03])
    sim.update_endeffector_position("box", [0.0, 0.01, 0.02])
    sim.update_contact_parameters("tactile_pad_left", "box", kn=3e3,
                                  mu=0.7)
    sim.update_tactile_parameters("tactile_pad_left", kn=2e3, damping=0.5)
    sim.update_virtual_object("goal", [0.1, 0.2, 0.0, 0.0, 0.0, 0.0, 1.0])


def test_update_edits_match_jax_facade():
    sj, mj = jax_task_scenes.tactile_push()
    st, _ = torch_task_scenes.tactile_push()
    jfac = jax_sim.Simulation((sj, mj))
    sim = simulation.Simulation((st, convert.model_from_numpy(leaves(mj))),
                                device="cpu")
    before = {k: getattr(sim.model, k) for k in LEAVES}
    for s in (jfac, sim):
        _edit(s)
    want = leaves(jfac.model)
    got = convert.model_to_numpy(sim.model)
    changed = []
    for k in LEAVES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-15, atol=0,
                                   err_msg=k)
        if not np.array_equal(want[k], np.asarray(getattr(mj, k))):
            changed.append(k)
            # a new tensor: the old one is untouched
            assert getattr(sim.model, k) is not before[k]
            np.testing.assert_array_equal(before[k].numpy(),
                                          np.asarray(getattr(mj, k)))
    assert sim.sim.model is sim.model
    assert {"body_mass", "body_inertia", "body_rgba", "body_size",
            "dof_damping", "joint_pos", "ee_pos", "pair_kn", "pair_mu",
            "tac_kn", "tac_damping", "virtual_pos",
            "virtual_quat"} <= set(changed)


def test_tactile_read_sees_edits():
    """RollingBall 8x8 pressed: the facade's tactile vector after
    ``update_tactile_parameters`` and after ``update_body_size`` (the
    ball, a sphere) differs from before and equals a fresh facade's built
    from the JAX facade's edited Model."""
    sj, mj = jax_task_scenes.rolling_ball(resolution=8)
    st, _ = torch_task_scenes.rolling_ball(resolution=8)
    jfac = jax_sim.Simulation((sj, mj))
    sim = simulation.Simulation((st, convert.model_from_numpy(leaves(mj))),
                                device="cpu")
    q, v = pressed(mj.q_init)
    sim.set_state_init(q, v)
    sim.reset()
    prev = sim.get_tactile_force_vector()
    assert np.abs(prev).max() > 0
    for edit in (lambda s: s.update_tactile_parameters("pad", kn=2 * float(
                     np.asarray(mj.tac_kn)[0])),
                 lambda s: s.update_body_size("object", [0.021])):
        edit(sim)
        edit(jfac)
        got = sim.get_tactile_force_vector()
        fresh = simulation.Simulation(
            (st, convert.model_from_numpy(leaves(jfac.model))), device="cpu")
        fresh.set_state_init(q, v)
        fresh.reset()
        np.testing.assert_array_equal(got, fresh.get_tactile_force_vector())
        assert not np.array_equal(got, prev)
        prev = got
    assert float(jnp.asarray(jfac.model.body_size)[1, 0]) == 0.021
