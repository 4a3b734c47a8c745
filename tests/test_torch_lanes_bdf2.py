"""The lanes stepper's BDF2, its per-step Newton solve and the Model-leaf
cotangents of its chord solve (``sim/lanes.py``) against the JAX package's,
float64 on the CPU, at B = 4 lanes over 2 steps. Each JAX function is
jitted once per module, its steps in one ``lax.scan`` (a jitted step VJP
costs 25-70 s to trace and compile on a CPU; two are compiled).

- TactilePush (BDF1, the pad pressed into the box) with per-lane body
  masses and inertias as trailing lane axes (JAX's
  ``test_step_parity_batched_model`` case): ``build_step`` against JAX's
  ``build_step``; and the chord solve's Model-leaf cotangents through
  ``build_env_step(frame_skip=2, refresh=1)`` in ``bwd_mode`` exact and
  fwdfac against the same JAX run (JAX's ``build_env_step`` states that at
  refresh 1 with the exact adjoint it reproduces the scan of
  ``build_step``; fwdfac factors the same matrix): the per-lane leaves get
  per-lane cotangents, the shared ones the lanes' sum.
- ``rolling_ball(resolution=8)`` (BDF2, the pad pressed onto the ball)
  with the step counter at 0 on two lanes and 1 on the others, so BDF2's
  first-step fallback is taken lane by lane: ``build_step`` against JAX's,
  ``build_env_step(frame_skip=2)`` at refresh 1 against the same JAX run and
  at refresh 0 against JAX's refresh-0 env step (values).

States are held to 1e-10 of their scale; the VJP into the state, ``u`` and
every Model leaf to 1e-9 of each cotangent's scale. Unit-length leaves
(``*_quat``, ``joint_axis*``) are compared in the tangent space of the unit
sphere: the port takes joint axes analytically where JAX differentiates FK,
and the two cotangents differ only along the leaf itself. A leaf whose
cotangent moves the loss, for a change of the leaf relative to its own
size, by less than 1e-12 of the most sensitive leaf's (TactilePush's
``tac_mu``: 1.8e-20 with no slip) is round-off on both sides: its scale is
taken at that floor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import resting_contact
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import lanes as jax_lanes
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes
from tactilesimulation_tpu_torch.sim.types import Model

torch.set_num_threads(1)

B = 4
VAL_TOL, VJP_TOL = 1e-10, 1e-9
ROUND_OFF = 1e-12
LEAVES = tuple(f.name for f in dataclasses.fields(Model))
UNIT = ("joint_quat", "body_quat", "virtual_quat", "joint_axis0",
        "joint_axis1")


def _leaves(tree):
    return {k: np.asarray(getattr(tree, k)) for k in LEAVES}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol, what):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else (
        got.detach().numpy() if isinstance(got, torch.Tensor) else got)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _tangent(g, x):
    """The part of cotangent rows g orthogonal to the unit rows x."""
    return g - np.sum(g * x, axis=-1, keepdims=True) * x


def _check_vjp(got, want, model):
    """got: {name: tensor or None}, want: {name: array} (JAX), every leaf
    to VJP_TOL of its scale, the scale at least ROUND_OFF x the largest
    loss sensitivity to a relative change of a leaf over its size."""
    size = {k: float(np.abs(np.asarray(getattr(model, k))).max(initial=0.0))
            for k in want}
    most = max(float(np.abs(w).max(initial=0.0)) * size[k]
               for k, w in want.items())
    for k, w in want.items():
        g = got[k]
        g = np.zeros_like(w) if g is None else g.detach().numpy()
        if k in UNIT:
            x = np.asarray(getattr(model, k))
            g, w = _tangent(g, x), _tangent(w, x)
        scale = float(np.abs(w).max(initial=0.0))
        if size[k] > 0:
            scale = max(scale, ROUND_OFF * most / size[k])
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= VJP_TOL * scale, \
            f"{k}: {err:.3e} > {VJP_TOL:g} x {scale:.3e}"


def _jax_vjp(step, nsteps):
    """jit of (model, q, v, q_prev, v_prev, t, u, gq, gv) -> ((q', v'),
    (model_bar, q_bar, v_bar, u_bar)) over ``nsteps`` calls of
    ``step(model, state, u)``."""
    def run(model, q, v, q_prev, v_prev, t, u, gq, gv):
        def f(m, q, v, u):
            s = jax_lanes.LaneSimState(q=q, qdot=v, q_prev=q_prev,
                                       qdot_prev=v_prev, t=t)
            s, _ = jax.lax.scan(lambda s, _: (step(m, s, u), None), s, None,
                                length=nsteps)
            return s.q, s.qdot
        out, pull = jax.vjp(f, model, q, v, u)
        return out, pull((gq, gv))
    return jax.jit(run)


def _torch_vjp(step, nsteps, model, q, v, q_prev, v_prev, t, u, gq, gv):
    """((q', v'), {leaf: cotangent}, (q_bar, v_bar, u_bar)) of the port."""
    m = Model(**{k: getattr(model, k).detach().clone().requires_grad_()
                 for k in LEAVES})
    q_, v_, u_ = (_t(a).requires_grad_() for a in (q, v, u))
    s = torch_lanes.LaneSimState(q=q_, qdot=v_, q_prev=_t(q_prev),
                                 qdot_prev=_t(v_prev), t=_t(t))
    for _ in range(nsteps):
        s = step(m, s, u_)
    wrt = [q_, v_, u_] + [getattr(m, k) for k in LEAVES]
    g = torch.autograd.grad((s.q, s.qdot), wrt, (_t(gq), _t(gv)),
                            allow_unused=True)
    return (s.q, s.qdot), dict(zip(LEAVES, g[3:])), g[:3]


def _case(scene, B, seed):
    """(JAX struct, JAX model, port struct, port model, q, v, q_prev,
    v_prev, t, u, gq, gv): float64 numpy (n, B) states in contact."""
    rng = np.random.RandomState(seed)
    if scene == "push":
        sj, mj = jax_scenes.tactile_push()
        st, _ = torch_scenes.tactile_push()
        q, v = resting_contact(np.asarray(mj.q_init), B, seed,
                               pad_speed=0.01)
        t = np.zeros(B, np.int32)
        q_prev, v_prev = q, v
    else:
        sj, mj = jax_scenes.rolling_ball(resolution=8)
        st, _ = torch_scenes.rolling_ball(resolution=8)
        q = np.repeat(np.asarray(mj.q_init)[:, None], B, axis=1)
        q[2] = -0.0153                   # the pad 0.3 mm into the ball
        q[3:5] = 2e-3 * rng.randn(2, B)
        v = 0.005 * rng.randn(q.shape[0], B)
        t = np.array([0, 1] * (B // 2), np.int32)
        h = float(mj.h)
        q_prev, v_prev = q - h * v, v + 0.01 * rng.randn(*v.shape)
    n, nu = sj.ndof_q, sj.ndof_u
    u = 0.1 * rng.randn(nu, B) + (np.array([[0.1], [0.0], [0.2]])
                                  if scene == "ball" else 0.0)
    gq, gv = rng.randn(n, B), rng.randn(n, B)
    mt = convert.model_from_numpy(_leaves(mj))
    return sj, mj, st, mt, q, v, q_prev, v_prev, t, u, gq, gv


@pytest.fixture(scope="module")
def push():
    """TactilePush with per-lane body masses and inertias (trailing lane
    axes): JAX's build_step over 2 steps, values and VJP."""
    sj, mj, st, mt, *arrays = _case("push", B, 7)
    scale = 1.0 + 0.3 * np.random.RandomState(7).uniform(-1, 1, B)
    bm = np.asarray(mj.body_mass)[:, None] * scale             # (NB, B)
    bi = np.asarray(mj.body_inertia)[:, :, None] * scale       # (NB, 3, B)
    mj = mj.replace(body_mass=jnp.asarray(bm), body_inertia=jnp.asarray(bi))
    mt = dataclasses.replace(mt, body_mass=_t(bm), body_inertia=_t(bi))
    want = _jax_vjp(jax_lanes.build_step(sj), 2)(
        mj, *(jnp.asarray(a) for a in arrays))
    return st, mt, mj, arrays, want


def _vs_jax(step, nsteps, mt, mj, arrays, want):
    """The port's ``nsteps`` calls of ``step`` against JAX's run: values
    and the VJP; returns the port's Model cotangents."""
    (wq, wv), (wm, wqb, wvb, wub) = want
    (q, v), got_m, (gq, gv, gu) = _torch_vjp(step, nsteps, mt, *arrays)
    _close(q, wq, VAL_TOL, "q")
    _close(v, wv, VAL_TOL, "qdot")
    for name, g, w in (("q_bar", gq, wqb), ("qdot_bar", gv, wvb),
                       ("u_bar", gu, wub)):
        _close(g, w, VJP_TOL, name)
    _check_vjp(got_m, _leaves(wm), mj)
    return got_m


def test_step_parity_batched_model(push):
    """Values alone, no grad anywhere: the chord solve's plain route."""
    st, mt, mj, arrays, ((wq, wv), _) = push
    step = torch_lanes.build_step(st)
    s = torch_lanes.LaneSimState(*(_t(a) for a in arrays[:5]))
    with torch.no_grad():
        for _ in range(2):
            s = step(mt, s, _t(arrays[5]))
    _close(s.q, wq, VAL_TOL, "q")
    _close(s.qdot, wv, VAL_TOL, "qdot")
    assert s.t.tolist() == [2] * B


def test_step_vjp_per_lane_leaves(push):
    st, mt, mj, arrays, want = push
    got = _vs_jax(torch_lanes.build_step(st), 2, mt, mj, arrays, want)
    assert tuple(got["body_mass"].shape) == (st.nbodies, B)
    assert tuple(got["body_inertia"].shape) == (st.nbodies, 3, B)


@pytest.mark.parametrize("bwd_mode", ["exact", "fwdfac"])
def test_env_step_model_leaf_cotangents(push, bwd_mode):
    st, mt, mj, arrays, want = push
    step = torch_lanes.build_env_step(st, 2, refresh=1, bwd_mode=bwd_mode)
    got = _vs_jax(step, 1, mt, mj, arrays, want)
    for k in ("body_mass", "body_inertia", "tac_kn", "dof_damping"):
        assert got[k] is not None and bool(got[k].abs().max() > 0), k


@pytest.fixture(scope="module")
def ball():
    """rolling_ball(8), BDF2, counters (0, 1, 0, 1): JAX's build_step over
    2 steps, values and VJP."""
    sj, mj, st, mt, *arrays = _case("ball", B, 5)
    want = _jax_vjp(jax_lanes.build_step(sj), 2)(
        mj, *(jnp.asarray(a) for a in arrays))
    return sj, st, mt, mj, arrays, want


def test_step_bdf2_matches_jax(ball):
    sj, st, mt, mj, arrays, want = ball
    assert st.integrator == "BDF2"
    _vs_jax(torch_lanes.build_step(st), 2, mt, mj, arrays, want)


def test_env_step_bdf2_refresh1_matches_jax(ball):
    sj, st, mt, mj, arrays, want = ball
    _vs_jax(torch_lanes.build_env_step(st, 2, refresh=1), 1, mt, mj, arrays,
            want)


def test_env_step_bdf2_refresh0_matches_jax(ball):
    """Values only: the amortized factor changes the chord's iterates, and
    the exact adjoint is the refresh-1 step's at the new v* (JAX's VJP of
    this env step alone takes 66 s to trace and compile on a CPU)."""
    sj, st, mt, mj, arrays, _ = ball
    q, v, q_prev, v_prev, t, u = (jnp.asarray(a) for a in arrays[:6])
    want = jax.jit(jax_lanes.build_env_step(sj, 2, refresh=0))(
        mj, jax_lanes.LaneSimState(q=q, qdot=v, q_prev=q_prev,
                                   qdot_prev=v_prev, t=t), u)
    s = torch_lanes.LaneSimState(*(_t(a) for a in arrays[:5]))
    got = torch_lanes.build_env_step(st, 2, refresh=0)(mt, s, _t(arrays[5]))
    for k in ("q", "qdot", "q_prev", "qdot_prev"):
        _close(getattr(got, k), getattr(want, k), VAL_TOL, k)
    assert got.t.tolist() == np.asarray(want.t).tolist()
