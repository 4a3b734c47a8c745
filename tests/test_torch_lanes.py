"""The port's lane-major core (``sim/lanes.py``) against the JAX package, f64.

- FK, momentum, the Euler-Lagrange terms (mixed-order AD: a gradient of a
  Lagrangian holding a JVP of FK) and the residual, to rtol 1e-9 (the bar of
  tests/test_megastep.py::test_residual_parity);
- the chord factor (n reverse-mode pullbacks through the fused op's twin)
  against the JAX factor (forward-mode linearisation of the plain residual);
- one amortized env step (refresh 0, max_iter 8) against
  ``lanes.build_env_step(..., refresh=0, bwd_mode='exact', max_iter=8)``, to
  1e-6 relative on q and qdot: a lane whose residual norm straddles the
  tolerance can take one more masked chord iteration on one side. Both use
  the lanes tolerance floor max(solver_tol, 1e-12 in f64), not the fused
  megastep's 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import lanes as jax_lanes
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import lane_contact as torch_lc
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes

torch.set_num_threads(1)

B = 4


@pytest.fixture(scope="module")
def scene():
    sj, mj = jax_scenes.tactile_push()
    st, mt = torch_scenes.tactile_push()
    rng = np.random.RandomState(0)
    n = st.ndof_q
    q = np.asarray(mj.q_init)[:, None] + 0.01 * rng.randn(n, B)
    q[1] = rng.uniform(0.0005, 0.003, B)     # pad pressing on the box
    q[5] = rng.uniform(-0.0005, 0.0, B)      # box pressing on the ground
    v = 0.1 * rng.randn(n, B)
    u = 0.3 * rng.randn(st.ndof_u, B)
    return dict(sj=sj, mj=mj, st=st, mt=mt, q=q, v=v, u=u)


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def _t(a):
    return torch.as_tensor(np.array(a))


def _inputs(sc):
    """(jax StepInputs, torch StepInputs) at the scene's state."""
    sj, mj, st, mt = sc["sj"], sc["mj"], sc["st"], sc["mt"]
    q, v, u = sc["q"], sc["v"], sc["u"]
    p_j = jax_lanes.momentum(sj, mj, jnp.asarray(q), jnp.asarray(v))
    h = float(mj.h)
    ij = jax_lanes.StepInputs(model=mj, u=jnp.asarray(u), q_base=jnp.asarray(q),
                              p_base=p_j, gamma=jnp.full((1, 1), h))
    it = torch_lanes.StepInputs(model=mt, u=_t(u), q_base=_t(q),
                                p_base=torch_lanes.momentum(st, mt, _t(q),
                                                            _t(v)),
                                gamma=mt.h.reshape(1, 1))
    return ij, it


def test_fk_joints_and_bodies(scene):
    sj, mj, st, mt, q = (scene[k] for k in ("sj", "mj", "st", "mt", "q"))
    for got, want in zip(torch_lanes.fk_joints(st, mt, _t(q)),
                         jax_lanes.fk_joints(sj, mj, jnp.asarray(q))):
        _close(got, want, 1e-9)
    for got, want in zip(torch_lanes.fk_bodies(st, mt, _t(q)),
                         jax_lanes.fk_bodies(sj, mj, jnp.asarray(q))):
        _close(got, want, 1e-9)
    _close(torch_lanes.ee_positions(st, mt, _t(q)),
           jax_lanes.ee_positions(sj, mj, jnp.asarray(q)), 1e-9)


def test_momentum_and_el_terms(scene):
    sj, mj, st, mt, q, v = (scene[k] for k in ("sj", "mj", "st", "mt", "q",
                                               "v"))
    _close(torch_lanes.momentum(st, mt, _t(q), _t(v)),
           jax_lanes.momentum(sj, mj, jnp.asarray(q), jnp.asarray(v)), 1e-9)
    _close(torch_lanes.lagrangian(st, mt, _t(q), _t(v)),
           jax_lanes.lagrangian(sj, mj, jnp.asarray(q), jnp.asarray(v)), 1e-9)
    for got, want in zip(torch_lanes.el_terms(st, mt, _t(q), _t(v)),
                         jax_lanes.el_terms(sj, mj, jnp.asarray(q),
                                            jnp.asarray(v))):
        _close(got, want, 1e-9)


def test_el_terms_pullback_matches_jax(scene):
    """The mixed-order graph: a VJP of (dL/dq, dL/dv) w.r.t. (q, v)."""
    sj, mj, st, mt, q, v = (scene[k] for k in ("sj", "mj", "st", "mt", "q",
                                               "v"))
    rng = np.random.RandomState(5)
    cq, cv = rng.randn(*q.shape), rng.randn(*q.shape)
    _, pull = jax.vjp(lambda a, b: jax_lanes.el_terms(sj, mj, a, b),
                      jnp.asarray(q), jnp.asarray(v))
    want = pull((jnp.asarray(cq), jnp.asarray(cv)))
    qt, vt = _t(q).requires_grad_(), _t(v).requires_grad_()
    dq, dv = torch_lanes.el_terms(st, mt, qt, vt)
    got = torch.autograd.grad((dq, dv), (qt, vt), (_t(cq), _t(cv)))
    for g, w in zip(got, want):
        _close(g, w, 1e-9)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_residual(scene, fused):
    ij, it = _inputs(scene)
    pw = torch_lc.make_pair_wrenches(scene["st"]) if fused else None
    r_t = torch_lanes.make_residual(scene["st"], pw)(_t(scene["v"]), it)
    r_j = jax_lanes.make_residual(scene["sj"])(jnp.asarray(scene["v"]), ij)
    _close(r_t, r_j, 1e-9)


def test_chord_factor(scene):
    ij, it = _inputs(scene)
    pw = torch_lc.make_pair_wrenches(scene["st"])
    lu_t = torch_lanes.make_chord_lu(
        torch_lanes.make_residual(scene["st"], pw), it, _t(scene["v"]))
    lu_j = jax_lanes.make_chord_lu(jax_lanes.make_residual(scene["sj"]), ij,
                                   jnp.asarray(scene["v"]))
    _close(lu_t, lu_j, 1e-9)
    r = np.random.RandomState(7).randn(scene["st"].ndof_q, B)
    _close(torch_lanes.gauss_solve(lu_t, _t(r)),
           jax_lanes.gauss_solve(lu_j, jnp.asarray(r)), 1e-9)


def test_env_step(scene):
    sj, mj, st, mt = (scene[k] for k in ("sj", "mj", "st", "mt"))
    q, v, u = scene["q"], 0.1 * scene["v"], scene["u"]
    step_j = jax_lanes.build_env_step(sj, 5, refresh=0, bwd_mode="exact",
                                      max_iter=8)
    s_j = step_j(mj, jax_lanes.LaneSimState(
        q=jnp.asarray(q), qdot=jnp.asarray(v), q_prev=jnp.asarray(q),
        qdot_prev=jnp.asarray(v), t=jnp.zeros(B, jnp.int32)), jnp.asarray(u))
    pw = torch_lc.make_pair_wrenches(st)
    step_t = torch_lanes.build_env_step(st, 5, max_iter=8, fused_pw=pw)
    s_t = step_t(mt, torch_lanes.LaneSimState(
        q=_t(q), qdot=_t(v), q_prev=_t(q), qdot_prev=_t(v),
        t=torch.zeros(B, dtype=torch.int32)), _t(u))
    _close(s_t.q, s_j.q, 1e-6)
    _close(s_t.qdot, s_j.qdot, 1e-6)
    _close(s_t.q_prev, s_j.q_prev, 1e-6)
    np.testing.assert_array_equal(s_t.t.numpy(), np.asarray(s_j.t))
    # the CPU route launched nothing; one chord factor = 7 twin pullbacks
    # sharing one twin recompute
    op = pw[0]
    assert (op.launches, op.twin_recomputes, op.twin_vjps) == \
        (0, 1, st.ndof_q)
