"""The port's single-instance stepper, strided rollout and facade against the
JAX package (f64, CPU).

- ``Simulator.step`` on RollingBall 8x8 (BDF2, points-major contact), 3
  steps from a state with the pad pressed onto the ball: BDF2's first-step
  fallback to BDF1, then two BDF2 steps; q and qdot to 1e-9 of scale
  against the JAX ``Simulator.step`` under ``jit``.
- TactilePush through the row-major contact path (``points_major=False``,
  BDF1), 2 steps, to the same tolerance.
- ``make_rollout_strided(5, fast_tactile=True)`` over 2 chunks against the
  JAX rollout's chunk body with ``fast_tactile=False`` (its jitted step 5
  times, then its tactile field): on CPU tensors the port's query is the
  plain path, and JAX's fast route runs only on a TPU (the two routes are
  pinned together by tests/test_ops.py and test_torch_dense_contact.py).
- The facade: ``forward(3)`` equals three ``forward(1)``;
  ``get_tactile_force_vector`` matches the JAX facade's; the flow images'
  shapes; the card is the default; ``reset(backward_flag=True)`` records
  the controls and the state before each step.
- ``convert.model_from_numpy`` / ``state_from_numpy`` round trips.
  The gradients are in ``test_torch_backward.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import simulation as jax_sim
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import dense_contact
from tactilesimulation_tpu_torch.sim import simulation
from tactilesimulation_tpu_torch.sim.types import Model

torch.set_num_threads(1)

TOL = 1e-9


def _leaves(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


def _pressed(q_init, seed=0):
    """RollingBall 8x8: the pad's underside 0.3 mm into the ball's top, the
    ball on the ground, slightly off centre and moving (the ball is light,
    3.4e-5 kg: pressed harder, it squirts out sideways within a few
    steps)."""
    rng = np.random.RandomState(seed)
    q = np.array(q_init)
    q[2] = -0.0153
    q[3:5] = 2e-3 * rng.randn(2)
    return q, 0.005 * rng.randn(q.shape[0])


@pytest.fixture(scope="module")
def rolling():
    sj, mj = jax_scenes.rolling_ball(resolution=8)
    st, _ = torch_scenes.rolling_ball(resolution=8)
    mt = convert.model_from_numpy(_leaves(mj))
    jsim = jax_sim.Simulator(sj, mj)
    tsim = simulation.Simulator(st, mt)
    assert jsim.points_major and tsim.points_major
    q, v = _pressed(mj.q_init)
    return dict(sj=sj, mj=mj, st=st, mt=mt, jsim=jsim, tsim=tsim, q=q, v=v)


def test_step_bdf2_matches_jax(rolling):
    jsim, tsim, mj, mt = (rolling[k] for k in ("jsim", "tsim", "mj", "mt"))
    js = jsim.init_state(mj, q=jnp.asarray(rolling["q"]),
                         qdot=jnp.asarray(rolling["v"]))
    ts = tsim.init_state(q=rolling["q"], qdot=rolling["v"])
    assert ts.t.dtype == torch.int32 and ts.t.ndim == 0
    assert float(np.abs(np.asarray(jsim.tactile(mj, js))).max()) > 0
    us = [[0.1, 0.0, 0.2], [0.1, 0.0, 0.2], [0.1, -0.1, 0.2]]
    for k, u in enumerate(us):
        js = jsim.step(mj, js, jnp.asarray(u))
        ts = tsim.step(mt, ts, torch.tensor(u, dtype=torch.float64))
        for name in ("q", "qdot", "q_prev", "qdot_prev"):
            _close(getattr(ts, name), getattr(js, name))
        assert int(ts.t) == int(js.t) == k + 1


def test_strided_rollout_matches_jax(rolling):
    jsim, tsim, mj, mt = (rolling[k] for k in ("jsim", "tsim", "mj", "mt"))
    us = np.array([[0.1, 0.0, 0.2], [0.1, 0.0, 0.2]])
    js = jsim.init_state(mj, q=jnp.asarray(rolling["q"]),
                         qdot=jnp.asarray(rolling["v"]))
    want_q, want_tac = [], []
    for u in us:
        for _ in range(5):
            js = jsim.step(mj, js, jnp.asarray(u))
        want_q.append(np.asarray(js.q))
        want_tac.append(np.asarray(jsim.tactile(mj, js)))
    rollout = tsim.make_rollout_strided(5, remat=False, fast_tactile=True)
    dense_contact.reset_counts()
    state, qs, vars_, tacs = rollout(
        mt, tsim.init_state(q=rolling["q"], qdot=rolling["v"]),
        torch.as_tensor(us))
    assert dense_contact.launches == 0          # CPU: the plain path
    assert tuple(vars_.shape) == (2, 0) and int(state.t) == 10
    _close(qs, np.stack(want_q))
    _close(state.q, want_q[-1])
    _close(tacs, np.stack(want_tac))
    assert all(float(np.abs(t).max()) > 0 for t in want_tac)


def test_step_row_major_bdf1_matches_jax():
    sj, mj = jax_scenes.tactile_push()
    st, _ = torch_scenes.tactile_push()
    mt = convert.model_from_numpy(_leaves(mj))
    jsim = jax_sim.Simulator(sj, mj, points_major=False)
    tsim = simulation.Simulator(st, mt, points_major=False)
    rng = np.random.RandomState(2)
    q = np.array(mj.q_init) + 1e-3 * rng.randn(sj.ndof_q)
    q[1] = 0.001                                    # pad into the box
    q[5] = -0.0002                                  # box into the ground
    v = 0.05 * rng.randn(sj.ndof_q)
    js = jsim.init_state(mj, q=jnp.asarray(q), qdot=jnp.asarray(v))
    ts = tsim.init_state(q=q, qdot=v)
    for u in (0.3 * rng.randn(sj.ndof_u), 0.3 * rng.randn(sj.ndof_u)):
        js = jsim.step(mj, js, jnp.asarray(u))
        ts = tsim.step(mt, ts, torch.as_tensor(u))
        _close(ts.q, js.q)
        _close(ts.qdot, js.qdot)


def test_facade(rolling):
    st, mt, sj, mj = (rolling[k] for k in ("st", "mt", "sj", "mj"))
    q, v = rolling["q"], rolling["v"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            simulation.Simulation((st, mt))         # the card is the default
    sim = simulation.Simulation((st, mt), device="cpu")
    assert (sim.ndof_r, sim.ndof_u, sim.ndof_var, sim.ndof_tactile) == \
        (9, 3, 0, 3 * 64)
    sim.set_state_init(q, v)
    np.testing.assert_array_equal(sim.get_q_init(), q)
    sim.reset()
    np.testing.assert_array_equal(sim.get_q(), q)
    # the tactile query against the JAX facade's, at the same state
    jfac = jax_sim.Simulation((sj, mj))
    jfac.set_state_init(q, v)
    jfac.reset()
    _close(sim.get_tactile_force_vector(), jfac.get_tactile_force_vector(),
           1e-10)
    images = sim.get_tactile_flow_images()
    assert [im.shape for im in images] == [(8, 8, 3)]
    assert len(sim.get_tactile_image_pos("pad")) == 64
    assert sim.get_variables().shape == (0,)

    sim.set_u([0.0, 0.0, 0.2])
    sim.forward(3)
    q_scan, traj_scan = sim.get_q(), sim.export_trajectory()
    assert traj_scan.shape == (4, 9)
    sim.reset()
    sim.set_u([0.0, 0.0, 0.2])
    for _ in range(3):
        sim.forward(1)
    np.testing.assert_allclose(sim.get_q(), q_scan, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(sim.export_trajectory(), traj_scan,
                               rtol=1e-12, atol=1e-15)
    assert np.all(np.isfinite(sim.get_qdot()))
    # recording for the backward engine: reset seeds the first snapshot,
    # each step appends its control and the state before it (JAX's facade
    # records the same)
    sim.reset(backward_flag=True)
    sim.set_u([0.0, 0.0, 0.2])
    sim.forward(1)
    sim.forward(2)
    ep = sim._episode
    assert len(ep.us) == 3 and len(ep.state_snapshots) == 4
    np.testing.assert_array_equal(ep.q0, q)
    np.testing.assert_array_equal(ep.state_snapshots[0].q.numpy(), q)
    assert [int(s.t) for s in ep.state_snapshots] == [0, 0, 1, 2]
    np.testing.assert_allclose(ep.state_snapshots[-1].q.numpy(),
                               traj_scan[2], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(sim.get_q(), q_scan, rtol=1e-12, atol=1e-15)


def test_convert_round_trip(rolling):
    mj, st, mt = rolling["mj"], rolling["st"], rolling["mt"]
    _, built = torch_scenes.rolling_ball(resolution=8)
    for f in dataclasses.fields(Model):
        a, b = getattr(mt, f.name), getattr(built, f.name)
        assert a.dtype == torch.float64 and torch.equal(a, b), f.name
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(mj,
                                                                    f.name)))
    js = rolling["jsim"].init_state(mj, q=jnp.asarray(rolling["q"]),
                                    qdot=jnp.asarray(rolling["v"]))
    ts = convert.state_from_numpy(_leaves(js))
    for name in ("q", "qdot", "q_prev", "qdot_prev", "t"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert ts.t.dtype == torch.int32
    for k, a in convert.model_to_numpy(mt).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(mj, k)))
    m32 = convert.model_from_numpy(_leaves(mj), dtype=torch.float32)
    assert m32.dtype == torch.float32
    with pytest.raises(KeyError):
        convert.model_from_numpy({"h": np.zeros(())})
