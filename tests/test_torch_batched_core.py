"""The batched single-instance core (``sim/{kinematics,dynamics,contact,
dense_single,integrators,simulation}.py`` over (B, n) states), the batched
tactile read's plain versions and the RollingBall CLI's ``--batch``,
``--lanes`` and ``--viz``, float64 on the CPU, on ``rolling_ball(8)``.

- B = 3 from the pad pressed onto the ball, against ``jax.vmap`` of JAX's
  single instance: ``integrators.build_step`` over 2 steps (values), and
  ``Simulator.make_rollout_strided(5, fast_tactile=False)`` over 2 chunks
  with per-instance controls (values, and the VJP of seeded cotangents on
  every output into the controls, q0 and the shared Model's leaves). The
  port's rollout runs with ``remat`` (one checkpoint per chunk for the
  batch) and ``fast_tactile`` (the read's plain version on the CPU).
  Values to 1e-10 of scale, the VJP to 1e-9 of each cotangent's scale.
- A batch of one against today's unbatched path, values and VJP, to 1e-12.
- B = 3 against three single-instance runs, one instance falling freely
  (its chord meets the stop rule after one sweep, the pressed ones never
  within the budget): each instance's state equals its own run's.
- The lanes stepper (``lanes.build_step``, plain residual) against the
  batched core (JAX's ``test_step_parity`` relation, its bars).
- The batched ``tactile_field_ref`` and ``tactile_field`` (the CPU route)
  against per-instance reads on scenes of the kernel's read phase; the read
  plan refuses a per-instance leaf, and the read refuses a mis-shaped batch
  without launching.
- The CLI in-process at ``--resolution 8 --steps 10 --cpu``: ``--batch 2``,
  ``--lanes --batch 2`` and ``--viz``; its images against JAX's
  ``tactile_viz`` on one array.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import read_case
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import integrators as jax_integrators
from tactilesimulation_tpu.sim import simulation as jax_sim
from tactilesimulation_tpu.utils import tactile_viz as jax_viz
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.examples import rolling_ball_speed
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import dense_contact, tactile_query
from tactilesimulation_tpu_torch.sim import integrators, lanes, simulation
from tactilesimulation_tpu_torch.sim.types import Model, SimState
from tactilesimulation_tpu_torch.utils import tactile_viz

torch.set_num_threads(1)

B, K, STRIDE = 3, 2, 5
VAL_TOL, VJP_TOL = 1e-10, 1e-9
ROUND_OFF = 1e-12
LEAVES = tuple(f.name for f in dataclasses.fields(Model))
UNIT = ("joint_quat", "body_quat", "virtual_quat", "joint_axis0",
        "joint_axis1")


def _leaves(tree):
    return {k: np.asarray(getattr(tree, k)) for k in LEAVES}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol, what=""):
    want = (want.detach().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want))
    got = np.zeros_like(want) if got is None else (
        got.detach().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got))
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max(initial=0.0))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _check_leaves(got, want, model):
    """Every Model leaf's cotangent (got: {name: tensor or None}, want:
    JAX's {name: array}) to VJP_TOL of its scale, as
    tests/test_torch_lanes_bdf2.py holds them: unit-length leaves in the
    tangent space of the unit sphere, and a scale at least ROUND_OFF x the
    largest loss sensitivity to a relative change of a leaf over its size
    (RollingBall's ``pair_kt``: 6.6e-3, where ``dof_damping``'s is
    3.9e10)."""
    size = {k: float(np.abs(np.asarray(getattr(model, k))).max(initial=0.0))
            for k in want}
    most = max(float(np.abs(w).max(initial=0.0)) * size[k]
               for k, w in want.items())
    for k, w in want.items():
        g = got[k]
        g = np.zeros_like(w) if g is None else g.detach().numpy()
        if k in UNIT:
            x = np.asarray(getattr(model, k))
            g, w = (a - np.sum(a * x, axis=-1, keepdims=True) * x
                    for a in (g, w))
        scale = float(np.abs(w).max(initial=0.0))
        if size[k] > 0:
            scale = max(scale, ROUND_OFF * most / size[k])
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= VJP_TOL * scale, \
            f"{k}: {err:.3e} > {VJP_TOL:g} x {scale:.3e}"


def _pressed(q_init, B, seed=0):
    """(q, v) (B, n): the pad's underside 0.3 mm into the ball's top, the
    ball slightly off centre and moving, per instance."""
    rng = np.random.RandomState(seed)
    q = np.repeat(np.asarray(q_init)[None], B, axis=0)
    q[:, 2] = -0.0153
    q[:, 3:5] = 2e-3 * rng.randn(B, 2)
    return q, 0.005 * rng.randn(*q.shape)


@pytest.fixture(scope="module")
def ball():
    sj, mj = jax_scenes.rolling_ball(resolution=8)
    st, _ = torch_scenes.rolling_ball(resolution=8)
    mt = convert.model_from_numpy(_leaves(mj))
    q, v = _pressed(mj.q_init, B)
    rng = np.random.RandomState(1)
    us = np.array([0.1, 0.0, 0.2]) + 0.05 * rng.randn(B, K, sj.ndof_u)
    return dict(sj=sj, mj=mj, st=st, mt=mt, q=q, v=v, us=us,
                tsim=simulation.Simulator(st, mt))


def test_step_matches_jax_vmap(ball):
    sj, mj, st, mt, q, v, us = (ball[k] for k in
                                ("sj", "mj", "st", "mt", "q", "v", "us"))
    jstep = jax_integrators.build_step(sj, points_major=True)
    jsim = jax_sim.Simulator(sj, mj)

    def two(q, v, u):
        s = jsim.init_state(mj, q=q, qdot=v)
        s, _ = jax.lax.scan(lambda s, _: (jstep(mj, s, u), None), s, None,
                            length=2)
        return s

    want = jax.jit(jax.vmap(two))(jnp.asarray(q), jnp.asarray(v),
                                  jnp.asarray(us[:, 0]))
    tsim = ball["tsim"]
    s = tsim.init_state(q=q, qdot=v)
    assert tuple(s.t.shape) == (B,) and s.t.dtype == torch.int32
    for _ in range(2):
        s = tsim.step(mt, s, _t(us[:, 0]))
    for k in ("q", "qdot", "q_prev", "qdot_prev"):
        _close(getattr(s, k), getattr(want, k), VAL_TOL, k)
    assert s.t.tolist() == [2] * B


def _cots(st, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, K, st.ndof_q),
            1e2 * rng.randn(B, K, st.ndof_tactile), rng.randn(B, st.ndof_q))


def _port_vjp(tsim, mt, q, v, us, cots, remat=True):
    """The port's strided rollout from (q, v) (B, n) or (n,) under ``us``:
    (qs, tacs, q_K) and the cotangents of (us, q0, each Model leaf)."""
    m = Model(**{k: getattr(mt, k).detach().clone().requires_grad_()
                 for k in LEAVES})
    q0, u = _t(q).requires_grad_(), _t(us).requires_grad_()
    state0 = tsim.init_state(m, q=q, qdot=v).replace(q=q0, q_prev=q0)
    rollout = tsim.make_rollout_strided(STRIDE, remat=remat,
                                        fast_tactile=True)
    state, qs, _, tacs = rollout(m, state0, u)
    outs = (qs, tacs, state.q)
    g = torch.autograd.grad(outs, [u, q0] + [getattr(m, k) for k in LEAVES],
                            [_t(c) for c in cots], allow_unused=True)
    return outs, g[0], g[1], dict(zip(LEAVES, g[2:]))


@pytest.fixture(scope="module")
def rollout_vjp(ball):
    """jax.vmap of JAX's strided rollout over (q0, us) with the Model
    shared: outputs and the VJP into (Model, q0, us)."""
    sj, mj, q, v, us = (ball[k] for k in ("sj", "mj", "q", "v", "us"))
    jsim = jax_sim.Simulator(sj, mj)
    roll = jsim.make_rollout_strided(STRIDE, remat=False, fast_tactile=False)

    def one(model, q0, v0, us1):
        state, qs, _, tacs = roll(model, jsim.init_state(model, q=q0,
                                                         qdot=v0), us1)
        return qs, tacs, state.q

    def run(model, q0, v0, us, cq, ct, cK):
        f = lambda m, q0, us: jax.vmap(one, in_axes=(None, 0, 0, 0))(
            m, q0, v0, us)
        out, pull = jax.vjp(f, model, q0, us)
        return out, pull((cq, ct, cK))

    cots = _cots(ball["st"])
    out, (gm, gq0, gus) = jax.jit(run)(
        mj, jnp.asarray(q), jnp.asarray(v), jnp.asarray(us),
        *(jnp.asarray(c) for c in cots))
    return cots, out, gm, gq0, gus


def test_strided_rollout_matches_jax_vmap(ball, rollout_vjp):
    cots, (wqs, wtacs, wqK), gm, gq0, gus = rollout_vjp
    dense_contact.reset_counts()
    (qs, tacs, qK), g_us, g_q0, g_m = _port_vjp(
        ball["tsim"], ball["mt"], ball["q"], ball["v"], ball["us"], cots)
    assert dense_contact.read_launches == 0          # CPU: the plain path
    assert float(np.abs(np.asarray(wtacs)).max()) > 0
    for name, got, want in (("qs", qs, wqs), ("tactile", tacs, wtacs),
                            ("q_K", qK, wqK)):
        _close(got, want, VAL_TOL, name)
    _close(g_us, gus, VJP_TOL, "us_bar")
    _close(g_q0, gq0, VJP_TOL, "q0_bar")
    _check_leaves(g_m, _leaves(gm), ball["mj"])
    for k in ("body_mass", "body_inertia", "tac_kn", "dof_damping"):
        assert bool(g_m[k].abs().max() > 0), k


def test_batch_of_one_is_the_single_instance(ball):
    """(1, n) against (n,): outputs and the VJP, remat on one side and off
    on the other, to 1e-12."""
    tsim, mt, q, v, us = (ball[k] for k in ("tsim", "mt", "q", "v", "us"))
    cq, ct, cK = _cots(ball["st"])
    one = _port_vjp(tsim, mt, q[:1], v[:1], us[:1],
                    (cq[:1], ct[:1], cK[:1]), remat=True)
    single = _port_vjp(tsim, mt, q[0], v[0], us[0], (cq[0], ct[0], cK[0]),
                       remat=False)
    for a, b in zip(one[0], single[0]):
        _close(a[0], b, 1e-12)
    _close(one[1][0], single[1], 1e-12, "us_bar")
    _close(one[2][0], single[2], 1e-12, "q0_bar")
    for k in LEAVES:
        if single[3][k] is not None:
            _close(one[3][k], single[3][k], 1e-12, k)


def _sweeps_to_stop(struct, step, model, state, u):
    """The sweep at which the chord's stop rule (|r| <= max(tol, rel |r0|))
    first holds for one instance, or None within the scene's budget: the
    sweeps of ``integrators.chord_sweeps`` followed one by one."""
    inputs = integrators.step_inputs(struct, model, state, u)
    lu, piv, r = integrators.chord_factor(step.residual_fn, inputs,
                                          state.qdot)
    tol_eff = max(integrators.solver_tol(struct, state.q.dtype),
                  1e-7 * float(torch.linalg.norm(r)))
    v = state.qdot
    for k in range(struct.solver_max_iter + 1):
        if float(torch.linalg.norm(r)) <= tol_eff:
            return k
        v = v - torch.linalg.lu_solve(lu, piv, r[:, None])[:, 0]
        r = step.residual_fn(v, inputs)
    return None


def test_instances_stop_on_their_own(ball):
    """Instance 0 falls freely, clear of the pad and 5 mm above the ground:
    its chord meets the stop rule after one sweep, while the pressed ones
    never do within the budget (the light ball chatters on the ground).
    The batch's states equal each instance's own run over 3 steps."""
    st, mt, tsim = ball["st"], ball["mt"], ball["tsim"]
    q, v = ball["q"].copy(), ball["v"].copy()
    q[0], v[0] = np.asarray(mt.q_init), 0.0
    q[0, 5] = 0.005
    u = _t(ball["us"][:, 0])
    step = tsim.step
    singles = [tsim.init_state(q=q[b], qdot=v[b]) for b in range(B)]
    stops = [_sweeps_to_stop(st, step, mt, s, u[b])
             for b, s in enumerate(singles)]
    assert stops == [1, None, None], stops
    batch = tsim.init_state(q=q, qdot=v)
    for _ in range(3):
        batch = step(mt, batch, u)
        singles = [step(mt, s, u[b]) for b, s in enumerate(singles)]
    for b, s in enumerate(singles):
        for k in ("q", "qdot"):
            _close(getattr(batch, k)[b], getattr(s, k), 1e-12, f"{k}[{b}]")


PER_INSTANCE = {"body_mass": 0.2, "body_inertia": 0.2, "body_size": 0.01,
                "pair_kn": 0.3, "tac_kn": 0.3}


@pytest.mark.parametrize("points_major", [True, False])
def test_per_instance_model_leaves(ball, points_major):
    """Model leaves with a leading per-instance axis (masses, inertias, the
    ball's size, the contact stiffnesses): each instance of the batch, its
    values over 2 steps and its leaves' cotangents, equals a single run on
    its own Model, to 1e-12; the other leaves (shared) get the instances'
    sum."""
    st, mt, q, v, us = (ball[k] for k in ("st", "mt", "q", "v", "us"))
    sim = simulation.Simulator(st, mt, points_major=points_major)
    rng = np.random.RandomState(6)
    per = {k: getattr(mt, k)[None] * _t(1.0 + s * rng.uniform(
        -1, 1, (B,) + (1,) * getattr(mt, k).ndim)) for k, s in
        PER_INSTANCE.items()}
    cq = _t(rng.randn(B, st.ndof_q))

    def run(model, q0, v0, u, cot):
        m = Model(**{k: getattr(model, k).detach().clone().requires_grad_()
                     for k in LEAVES})
        s = sim.init_state(m, q=q0, qdot=v0)
        for _ in range(2):
            s = sim.step(m, s, u)
        g = torch.autograd.grad(s.q, [getattr(m, k) for k in LEAVES], cot,
                                allow_unused=True)
        return s.q, dict(zip(LEAVES, g))

    qb, gb = run(dataclasses.replace(mt, **per), q, v, _t(us[:, 0]), cq)
    shared = {k: 0.0 for k in LEAVES if k not in PER_INSTANCE}
    for b in range(B):
        mb = dataclasses.replace(mt, **{k: x[b] for k, x in per.items()})
        q1, g1 = run(mb, q[b], v[b], _t(us[b, 0]), cq[b])
        _close(qb[b], q1, 1e-12, f"q[{b}]")
        for k in PER_INSTANCE:
            _close(gb[k][b], g1[k], 1e-12, f"{k}[{b}]")
        for k in shared:
            if g1[k] is not None:
                shared[k] = shared[k] + g1[k]
    for k, want in shared.items():
        if isinstance(want, torch.Tensor):
            _close(gb[k], want, 1e-12, k)


@pytest.mark.parametrize("scene", ["push", "ball"])
def test_lanes_step_matches_the_batched_core(scene):
    """lanes.build_step on (n, B) against the batched core's step on
    (B, n) (JAX's tests/test_lanes.py::test_step_parity relation and its
    bars: the two factor J differently, a pivoted LU against the lanes'
    unpivoted one)."""
    if scene == "push":
        st, mt = torch_scenes.tactile_push()
        rng = np.random.RandomState(1)
        q = mt.q_init.numpy()[None] + 0.02 * rng.randn(B, st.ndof_q)
    else:
        st, mt = torch_scenes.rolling_ball(resolution=8)
        rng = np.random.RandomState(2)
        q, _ = _pressed(mt.q_init, B, 2)
    v = 0.1 * rng.randn(B, st.ndof_q)
    u = 0.05 * rng.randn(B, st.ndof_u)
    sim = simulation.Simulator(st, mt, points_major=scene == "ball")
    got = sim.step(mt, sim.init_state(q=q, qdot=v), _t(u))
    ls = lanes.LaneSimState(q=_t(q.T), qdot=_t(v.T), q_prev=_t(q.T),
                            qdot_prev=_t(v.T),
                            t=torch.zeros(B, dtype=torch.int32))
    want = lanes.build_step(st)(mt, ls, _t(u.T))
    np.testing.assert_allclose(got.q.numpy(), want.q.numpy().T, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(got.qdot.numpy(), want.qdot.numpy().T,
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", ["rolling_ball_8", "tactile_push",
                                  "stable_grasp"])
def test_batched_read_plain_versions(name):
    struct, model, q0, v0 = read_case(name)
    rng = np.random.RandomState(3)
    q = q0 + 1e-4 * _t(rng.randn(B, q0.shape[0]))
    v = v0 + 1e-2 * _t(rng.randn(B, q0.shape[0]))
    got = tactile_query.tactile_field_ref(struct, model, q, v)
    via = tactile_query.tactile_field(struct, model, q, v)
    assert tuple(got.shape) == (B, len(struct.tac_joint), 3)
    for b in range(B):
        one = tactile_query.tactile_field_ref(struct, model, q[b], v[b])
        assert float(one.abs().max()) > 0
        _close(got[b], one.numpy(), 1e-12, f"instance {b}")
    assert torch.equal(got, via)


def test_batched_read_refusals():
    struct, model, q, v = read_case("rolling_ball_8")
    per = dataclasses.replace(model, tac_kn=model.tac_kn.expand(B, -1))
    with pytest.raises(ValueError, match="tac_kn"):
        dense_contact.ReadPlan(struct, per)
    plan = dense_contact.ReadPlan(struct, model)
    qb = q.expand(B, -1).contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        dense_contact.tactile_read(plan, qb.T.contiguous().T, qb)
    with pytest.raises(ValueError, match="shape"):
        dense_contact.tactile_read(plan, qb, qb[:2])
    with pytest.raises(ValueError, match="shape"):
        dense_contact.tactile_read(plan, qb[None], qb[None])


def _cli(argv, capsys):
    out = rolling_ball_speed.main(["--resolution", "8", "--steps", "10",
                                   "--cpu", "--f64"] + argv)
    text = capsys.readouterr().out
    fps = [ln for ln in text.splitlines() if ln.startswith("time elapsed")]
    assert len(fps) == 1 and float(fps[0].split("FPS = ")[1]) > 0
    return out, text


def test_cli_batch_and_lanes(capsys, tmp_path):
    (out, _), text = _cli(["--batch", "2", "--viz", str(tmp_path)], capsys)
    state, qs, _, tacs = out
    assert tuple(state.q.shape) == (2, 9) and tuple(qs.shape) == (2, 2, 9)
    assert tuple(tacs.shape) == (2, 2, 64 * 3)
    for name in ("depth.png", "force.png"):
        assert os.path.getsize(tmp_path / name) > 0
    (lout, _), _ = _cli(["--lanes", "--batch", "2"], capsys)
    lstate, ltacs = lout
    assert tuple(lstate.q.shape) == (9, 2) and tuple(ltacs.shape) == (
        2, 64, 3, 2)
    # the same 10 steps of the same scene: the lanes stepper against the
    # batched core at JAX's test_step_parity bars
    np.testing.assert_allclose(lstate.q.numpy().T, state.q.numpy(),
                               rtol=1e-8, atol=1e-10)


def test_viz_matches_jax():
    rng = np.random.RandomState(4)
    arr = rng.randn(8, 8, 3)
    arr[..., 2] = np.abs(arr[..., 2])
    np.testing.assert_array_equal(tactile_viz.visualize_depth_image(arr),
                                  jax_viz.visualize_depth_image(arr))
    np.testing.assert_array_equal(tactile_viz.visualize_tactile_image(arr),
                                  jax_viz.visualize_tactile_image(arr))


def test_batched_state_layout(ball):
    tsim = ball["tsim"]
    s = tsim.init_state(batch=B)
    assert isinstance(s, SimState)
    assert tuple(s.q.shape) == (B, 9) and tuple(s.t.shape) == (B,)
    states = tsim.make_rollout_states()(
        ball["mt"], tsim.init_state(q=ball["q"], qdot=ball["v"]),
        _t(ball["us"][:, 0]).unsqueeze(1))
    assert tuple(states.q.shape) == (B, 1, 9)
    assert tuple(states.t.shape) == (B, 1)


def test_push_lanes_env_keeps_the_newton_step():
    """``TactilePushLanes._step_sim`` is ``lanes.build_step`` (the JAX env's
    attribute): one step of it equals the lanes stepper's own."""
    from tactilesimulation_tpu_torch.envs import tactile_push_lanes
    env = tactile_push_lanes.TactilePushLanes(device="cpu",
                                              dtype=torch.float64)
    st, mt = env.struct, env.model
    rng = np.random.RandomState(5)
    q = mt.q_init.numpy()[:, None] + 0.01 * rng.randn(st.ndof_q, 2)
    s = lanes.LaneSimState(q=_t(q), qdot=_t(0 * q), q_prev=_t(q),
                           qdot_prev=_t(0 * q),
                           t=torch.zeros(2, dtype=torch.int32))
    u = _t(0.1 * rng.randn(st.ndof_u, 2))
    got = env._step_sim(mt, s, u)
    want = lanes.build_step(st)(mt, s, u)
    assert torch.equal(got.q, want.q) and torch.equal(got.qdot, want.qdot)
