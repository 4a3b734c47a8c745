"""The port's single-instance backward against the JAX package (f64, CPU),
on RollingBall 8x8 with the pad pressed onto the ball (points-major
contact, BDF2 with its first-step fallback):

- the gradient of a dense rollout (``Simulator.make_rollout_dense``) with
  seeded cotangents on q and the tactile field, with respect to the
  controls, q0, qdot0 and every Model leaf, against JAX's ``jax.vjp``
  through ``Simulator._step`` chained step by step (one jitted step VJP
  serves every horizon here), within 1e-7 of each gradient's scale;
- ``remat`` true and false give bit-equal gradients;
- the strided rollout keeps the tactile field's graph: the ``--grad``
  loss (``rolling_ball_speed.bptt_loss``) has a non-zero gradient equal to
  JAX's, and the read kernel is never asked for under grad;
- the facade's ``backward()`` and ``backward_steps(n)`` with a tactile
  cotangent and ``flag_p`` (``df_dp`` leaf by leaf through
  ``convert.model_to_numpy``), and its cache, against the same JAX VJP of
  the rollout the JAX facade pulls back through (its ``_run_backward`` is
  ``jax.vjp`` of ``make_rollout_dense``);
- ``forward(test_derivatives=True)`` passes where the solve converges;
- the ``--grad`` CLI at ``--cpu --resolution 8 --steps 10 --grad-steps 10
  --f64`` runs and prints a finite |g| equal to JAX's gradient of its loss
  at the same controls. From the CLI's initial state the pad reaches the
  ball only at step 75, so within 10 steps the ball does not depend on the
  controls and the gradient is exactly zero on both sides; the pressed
  state above gives the loss its non-zero gradient.

``test_torch_backward_scenes.py`` holds the row-major BDF1 step
(falling_box), the design-parameter gradient, the pendulum facade against
the JAX facade and the model edits, using ``jax_step_vjp`` and
``jax_rollout_vjp`` from here.
"""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import simulation as jax_sim
from tactilesimulation_tpu.sim.types import SimState as JaxState
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.examples import rolling_ball_speed
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import dense_contact
from tactilesimulation_tpu_torch.sim import simulation
from tactilesimulation_tpu_torch.sim.types import Model

torch.set_num_threads(1)

TOL = 1e-7
LEAVES = [f.name for f in dataclasses.fields(Model)]


def leaves(tree):
    return {k: np.asarray(getattr(tree, k)) for k in LEAVES}


def close(got, want, tol=TOL, what="", scale=None):
    """max |got - want| within tol of ``scale`` (default: max |want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


UNIT_LEAVES = ("joint_quat", "body_quat", "virtual_quat", "joint_axis0",
               "joint_axis1")


def tangent(g, unit):
    """A unit-length leaf's cotangent (row by row) with its radial part,
    along the leaf itself, taken out."""
    unit = np.asarray(unit)
    nn = np.maximum(np.sum(unit * unit, axis=-1, keepdims=True), 1e-300)
    return g - np.sum(g * unit, axis=-1, keepdims=True) / nn * unit


def close_model(got, want, model, tol=TOL):
    """Leaf-by-leaf cotangents ({name: array}), each within tol of its
    scale; a leaf with no cotangent on the JAX side must have none here.
    The unit-length leaves (quaternions, joint axes) are compared in the
    tangent space of the unit sphere: their radial part, a change of
    length that no rotation or axis has, differs because the port takes
    the joints' world axes and twists analytically where JAX takes a JVP
    of FK, and the two agree only at unit length. Their scale stays the
    whole cotangent's."""
    for k in LEAVES:
        g, w = got[k], want[k]
        scale = float(np.abs(w).max()) if w.size else 0.0
        if k in UNIT_LEAVES:
            g, w = tangent(g, getattr(model, k)), tangent(w, getattr(model, k))
        close(g, w, tol, k, scale)


def jax_step_vjp(jsim, with_tactile):
    """One jitted VJP of ``jsim._step`` (and of the tactile field at the
    new state): ((q', qdot', q_prev', qdot_prev'), tac') and the pullback
    of their cotangents into (model, q, qdot, q_prev, qdot_prev, u)."""
    def out(m, q, v, qp, vp, t, u):
        s = jsim._step(m, JaxState(q=q, qdot=v, q_prev=qp, qdot_prev=vp,
                                   t=t), u)
        tac = (jsim._tactile_field(m, s.q, s.qdot).reshape(-1)
               if with_tactile else jnp.zeros((0,), s.q.dtype))
        return (s.q, s.qdot, s.q_prev, s.qdot_prev), tac

    @jax.jit
    def fn(m, q, v, qp, vp, t, u, ct_state, ct_tac):
        o, pb = jax.vjp(lambda m, q, v, qp, vp, u:
                        out(m, q, v, qp, vp, t, u), m, q, v, qp, vp, u)
        return o, pb((ct_state, ct_tac))
    return fn


def jax_rollout_vjp(fn, model, s0, us, cq, ctac):
    """JAX's dense rollout from the state ``s0`` = (q, qdot, q_prev,
    qdot_prev, t) under ``us``, and the VJP of the cotangents ``cq``
    (T, n) on q and ``ctac`` (T, ntac) on the field, chained through
    ``fn`` (``jax_step_vjp``) step by step. Returns numpy (qs, tacs, gq0,
    gqdot0, gus, {leaf: cotangent})."""
    T = us.shape[0]
    z = np.zeros_like(s0[0])
    state, states, qs, tacs = tuple(s0[:4]), [], [], []
    t0 = int(s0[4])
    for k in range(T):
        states.append(state)
        (state, tac), _ = fn(model, *state, jnp.int32(t0 + k), us[k],
                             (z, z, z, z), np.zeros(ctac.shape[1]))
        state = tuple(np.asarray(x) for x in state)
        qs.append(state[0])
        tacs.append(np.asarray(tac))
    ct = [z, z, z, z]
    gus = np.zeros_like(us)
    gm = {k: np.zeros_like(np.asarray(getattr(model, k))) for k in LEAVES}
    for k in reversed(range(T)):
        ct[0] = ct[0] + cq[k]
        _, (m_bar, q_bar, v_bar, qp_bar, vp_bar, u_bar) = fn(
            model, *states[k], jnp.int32(t0 + k), us[k], tuple(ct), ctac[k])
        ct = [np.asarray(q_bar), np.asarray(v_bar), np.asarray(qp_bar),
              np.asarray(vp_bar)]
        gus[k] = np.asarray(u_bar)
        for name in LEAVES:
            gm[name] = gm[name] + np.asarray(getattr(m_bar, name))
    # the facade's convention: q_prev and qdot_prev of the start state are
    # constants, only (q, qdot) are the variables
    return np.stack(qs), np.stack(tacs), ct[0], ct[1], gus, gm


def port_rollout_vjp(sim, model, s0, us, cq, ctac, remat=False):
    """The port's dense rollout from ``s0`` (a SimState whose q and qdot
    become the variables) and the VJP of (cq, ctac) into (q0, qdot0, us,
    every Model leaf)."""
    q0 = s0.q.detach().clone().requires_grad_()
    v0 = s0.qdot.detach().clone().requires_grad_()
    us = torch.as_tensor(us).clone().requires_grad_()
    m = Model(**{k: getattr(model, k).detach().clone().requires_grad_()
                 for k in LEAVES})
    rollout = sim.make_rollout_dense(remat=remat)
    _, qs, _, tacs = rollout(m, s0.replace(q=q0, qdot=v0), us)
    wrt = [q0, v0, us] + [getattr(m, k) for k in LEAVES]
    g = torch.autograd.grad([qs, tacs],
                            wrt, [torch.as_tensor(cq), torch.as_tensor(ctac)],
                            materialize_grads=True)
    return (qs.detach(), tacs.detach(), g[0], g[1], g[2],
            {k: y.numpy() for k, y in zip(LEAVES, g[3:])})


def pressed(q_init, seed=0):
    """RollingBall 8x8: the pad's underside 0.3 mm into the ball's top, the
    ball on the ground, slightly off centre and moving."""
    rng = np.random.RandomState(seed)
    q = np.array(q_init)
    q[2] = -0.0153
    q[3:5] = 2e-3 * rng.randn(2)
    return q, 0.005 * rng.randn(q.shape[0])


@pytest.fixture(scope="module")
def rolling():
    sj, mj = jax_scenes.rolling_ball(resolution=8)
    st, _ = torch_scenes.rolling_ball(resolution=8)
    mt = convert.model_from_numpy(leaves(mj))
    jsim = jax_sim.Simulator(sj, mj)
    tsim = simulation.Simulator(st, mt)
    assert jsim.points_major and tsim.points_major and st.integrator == "BDF2"
    q, v = pressed(mj.q_init)
    return dict(sj=sj, mj=mj, st=st, mt=mt, jsim=jsim, tsim=tsim, q=q, v=v,
                fn=jax_step_vjp(jsim, True))


def _seeded(T, n, ntac, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(T, n), 1e2 * rng.randn(T, ntac)


def test_rollout_gradient_matches_jax(rolling):
    """3 dense steps from the pressed state (BDF2's first step falls back
    to BDF1), cotangents on q and the field: the values, and gradients
    w.r.t. u, q0, qdot0 and every Model leaf."""
    r = rolling
    T, n, ntac = 3, r["st"].ndof_q, r["st"].ndof_tactile
    us = np.array([[0.1, 0.0, 0.2], [0.1, -0.05, 0.2], [0.0, 0.1, 0.25]])
    cq, ctac = _seeded(T, n, ntac, 1)
    s0 = r["tsim"].init_state(q=r["q"], qdot=r["v"])
    got = port_rollout_vjp(r["tsim"], r["mt"], s0, us, cq, ctac)
    want = jax_rollout_vjp(r["fn"], r["mj"], (r["q"], r["v"], r["q"],
                                              r["v"], 0), us, cq, ctac)
    assert float(np.abs(want[1]).max()) > 0          # in contact
    for g, w, what in zip(got[:5], want[:5],
                          ("qs", "tactiles", "q0", "qdot0", "u")):
        close(g, w, what=what)
    assert float(np.abs(want[4]).max()) > 0
    close_model(got[5], want[5], r["mj"])


def test_dense_rollout_remat_is_bit_equal(rolling):
    r = rolling
    T, n, ntac = 3, r["st"].ndof_q, r["st"].ndof_tactile
    us = np.array([[0.1, 0.0, 0.2]] * T)
    cq, ctac = _seeded(T, n, ntac, 2)
    s0 = r["tsim"].init_state(q=r["q"], qdot=r["v"])
    a = port_rollout_vjp(r["tsim"], r["mt"], s0, us, cq, ctac, remat=True)
    b = port_rollout_vjp(r["tsim"], r["mt"], s0, us, cq, ctac, remat=False)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    for k in LEAVES:
        np.testing.assert_array_equal(a[5][k], b[5][k], err_msg=k)


def _chunk_gradient(r, s0, us_chunks, stride=5, w_tac=1e3, w_q=1.0):
    """JAX's gradient of the ``--grad`` loss (w_tac sum(tacs^2) + w_q
    sum(q_T[3:6]^2)) w.r.t. the chunk controls: the dense rollout's VJP
    with the loss's cotangents at chunk ends, summed over each chunk's
    steps."""
    n, ntac = r["st"].ndof_q, r["st"].ndof_tactile
    us = np.repeat(us_chunks, stride, axis=0)
    T = us.shape[0]
    z = (np.zeros((T, n)), np.zeros((T, ntac)))
    qs, tacs, *_ = jax_rollout_vjp(r["fn"], r["mj"], s0, us, *z)
    cq, ctac = z
    ends = np.arange(stride - 1, T, stride)
    ctac[ends] = 2.0 * w_tac * tacs[ends]
    cq[-1, 3:6] = 2.0 * w_q * qs[-1, 3:6]
    *_, gus, _ = jax_rollout_vjp(r["fn"], r["mj"], s0, us, cq, ctac)
    return gus.reshape(-1, stride, us.shape[1]).sum(axis=1)


def test_strided_rollout_keeps_the_tactile_gradient(rolling):
    """2 chunks of 5 steps from the pressed state: the ``--grad`` loss
    through ``make_rollout_strided(remat=True, fast_tactile=False)``
    against JAX; its tactile term carries most of the gradient (a field
    computed under ``no_grad`` gave that term none)."""
    r = rolling
    us = np.array([[0.1, 0.0, 0.2], [0.05, 0.05, 0.2]])
    s0 = r["tsim"].init_state(q=r["q"], qdot=r["v"])
    loss = rolling_ball_speed.bptt_loss(r["tsim"], r["mt"], s0)
    dense_contact.reset_counts()
    g = rolling_ball_speed.grad_of(loss, torch.as_tensor(us))
    assert dense_contact.read_launches == 0
    s0 = (r["q"], r["v"], r["q"], r["v"], 0)
    want = _chunk_gradient(r, s0, us)
    close(g, want, what="d loss / d us")
    g_tac = _chunk_gradient(r, s0, us, w_q=0.0)
    assert np.linalg.norm(g_tac) > 0.5 * np.linalg.norm(want)


def test_facade_backward_matches_jax(rolling):
    """``reset(backward_flag=True)``, 3 steps (one, then two in one call),
    ``backward()`` and ``backward_steps(2)`` with q and tactile cotangents
    and ``flag_p``; the backward cache."""
    r = rolling
    st, n, ntac = r["st"], r["st"].ndof_q, r["st"].ndof_tactile
    sim = simulation.Simulation((st, r["mt"]), device="cpu")
    sim.set_state_init(r["q"], r["v"])
    sim.reset(backward_flag=True)
    u1, u2 = np.array([0.1, 0.0, 0.2]), np.array([0.0, 0.1, 0.25])
    sim.set_u(u1)
    sim.forward(1)
    sim.set_u(u2)
    sim.forward(2)
    ep = sim._episode
    assert len(ep.us) == 3 and len(ep.state_snapshots) == 4
    us = np.stack([u1, u2, u2])
    cq, ctac = _seeded(3, n, ntac, 3)
    bi = sim.backward_info
    bi.set_flags(flag_q0=True, flag_qdot0=True, flag_p=True, flag_u=True)
    bi.df_dq, bi.df_dtactile = cq.reshape(-1), ctac.reshape(-1)
    bi.df_dvar = np.zeros(0)
    sim.saveBackwardCache()
    sim.reset(backward_flag=False)
    sim.popBackwardCache()
    sim.backward()
    res = sim.backward_results
    want = jax_rollout_vjp(r["fn"], r["mj"], (r["q"], r["v"], r["q"], r["v"],
                                              0), us, cq, ctac)
    close(res.df_dq0, want[2], what="df_dq0")
    close(res.df_dqdot0, want[3], what="df_dqdot0")
    close(res.df_du, want[4].reshape(-1), what="df_du")
    close_model(convert.model_to_numpy(res.df_dp), want[5], r["mj"])

    # the last 2 steps, from the snapshot before step 2 (t = 1)
    bi.df_dq, bi.df_dtactile = cq[1:].reshape(-1), ctac[1:].reshape(-1)
    bi.flag_p = False
    sim.backward_steps(2)
    snap = ep.state_snapshots[-2]
    s0 = tuple(x.numpy() for x in (snap.q, snap.qdot, snap.q_prev,
                                   snap.qdot_prev)) + (int(snap.t),)
    assert s0[4] == 1
    want = jax_rollout_vjp(r["fn"], r["mj"], s0, us[1:], cq[1:], ctac[1:])
    close(res.df_dq0, want[2], what="df_dq0 (steps)")
    close(res.df_dqdot0, want[3], what="df_dqdot0 (steps)")
    close(res.df_du, want[4].reshape(-1), what="df_du (steps)")
    assert res.df_dp is None
    sim.clearBackwardCache()
    with pytest.raises(IndexError):
        sim.popBackwardCache()


def test_forward_test_derivatives(rolling):
    """The self-check passes where the step's solve converges (the
    initial state: the ball resting on the ground), in both branches of
    ``forward``; on the pressed state the 10 chord sweeps cut the residual
    only about 12-fold, the solver's output is not v*, and the check
    (FD of the solver against the adjoint at v*) fails, as it should."""
    r = rolling
    sim = simulation.Simulation((r["st"], r["mt"]), device="cpu")
    sim.reset(backward_flag=True)
    sim.set_u([0.1, 0.0, 0.2])
    sim.forward(1, test_derivatives=True)
    sim.forward(2, test_derivatives=True)
    sim.set_state_init(r["q"], r["v"])
    sim.reset()
    with pytest.raises(AssertionError, match="self-check"):
        sim.forward(1, test_derivatives=True)


def test_grad_cli_matches_jax(rolling):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, (us_g, g) = rolling_ball_speed.main(
            ["--cpu", "--resolution", "8", "--steps", "10",
             "--grad-steps", "10", "--grad", "--f64"])
    text = out.getvalue()
    m = re.search(r"BPTT 10 steps: .*\|g\| = (\S+), finite = (\w+)", text)
    assert m is not None, text
    assert m.group(2) == "True" and np.isfinite(float(m.group(1)))
    assert tuple(g.shape) == (2, 3) and us_g.dtype == torch.float64
    mj = rolling["mj"]
    q0, v0 = np.asarray(mj.q_init), np.asarray(mj.qdot_init)
    want = _chunk_gradient(rolling, (q0, v0, q0, v0, 0), us_g.numpy())
    np.testing.assert_array_equal(g.numpy(), want)
    assert float(m.group(1)) == float(np.linalg.norm(want))
