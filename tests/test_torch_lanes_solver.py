"""The lanes stepper's solver options (``sim/lanes.py``:
``build_env_step(refresh=...)``, ``chord_solve``'s ``bwd_mode``s) and
``TactilePushLanes``'s (``rebuild_solver``, ``batched_rollout_fn(remat)``),
float64 on the CPU.

- the chord factor's schedule, ``lanes.factor_substeps``, against the one
  the JAX package's ``build_env_step`` runs: its ``make_chord_lu`` and
  ``chord_solve`` calls read under ``jax.disable_jit()`` (its scans then
  run as Python loops) with both stubbed, so no physics runs; and the
  refresh-2 env step against its substeps composed by hand, port against
  port. The env steps at refresh 1 and 2 and the adjoint modes against
  JAX's: ``tests/test_torch_chord_bwd.py``;
- ``TactilePushLanes(solver_refresh=1)`` against the port's single-instance
  ``TactilePushEnv.step`` lane by lane (B = 2 and 3, 3 env steps, the same
  draws): q and qdot to 1e-8 of scale;
- ``rebuild_solver``'s rules: the chord budget, ``fused=False`` against the
  pair-wrench op's CPU route to 1e-12 of scale, the megastep never on the
  CPU by "auto";
- a rollout with ``remat`` equals one without (loss and the policy's
  gradient to 1e-12 of scale), and the op's CPU route counts the pullbacks
  ``chip_smoke.lanes_launches`` derives (K1T on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import lanes_launches, resting_contact
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import lanes as jax_lanes
from tactilesimulation_tpu_torch.envs import tactile_push, tactile_push_lanes
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import lane_contact as torch_lc
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes

torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def scene():
    return torch_scenes.tactile_push()


@pytest.mark.parametrize("refresh", [0, 1, 2, 3, 5, 7])
def test_factor_schedule_is_jax_s(refresh, monkeypatch):
    """The substeps at which JAX's env step factors J: the number of chord
    solves before each of its ``make_chord_lu`` calls, over one env step of
    frame_skip 5."""
    sj, mj = jax_scenes.tactile_push()
    calls = []

    def factor(residual_fn, inputs, v_guess, reverse=False):
        calls.append("factor")
        return v_guess

    def solve(residual_fn, max_iter, tol, bwd_mode, inputs, v_guess, lu):
        calls.append("solve")
        return v_guess

    monkeypatch.setattr(jax_lanes, "make_residual", lambda struct, pw=None:
                        None)
    monkeypatch.setattr(jax_lanes, "momentum", lambda struct, m, q, v: v)
    monkeypatch.setattr(jax_lanes, "make_chord_lu", factor)
    monkeypatch.setattr(jax_lanes, "chord_solve", solve)
    z = jnp.zeros((sj.ndof_q, 2))
    with jax.disable_jit():
        jax_lanes.build_env_step(sj, 5, refresh=refresh)(
            mj, jax_lanes.LaneSimState(q=z, qdot=z, q_prev=z, qdot_prev=z,
                                       t=jnp.zeros(2, jnp.int32)),
            jnp.zeros((sj.ndof_u, 2)))
    assert calls.count("solve") == 5
    want = [calls[:i].count("solve") for i, c in enumerate(calls)
            if c == "factor"]
    assert torch_lanes.factor_substeps(5, refresh) == want


def test_env_step_refresh2_composes_substeps(scene):
    """refresh 2: the env step equals its substeps run one by one with a
    fresh chord factor at substeps 0, 2 and 4 and the last one reused in
    between (the factor and the chord are held to JAX's by
    tests/test_torch_lanes.py; the refresh-1 step to the single instance
    below)."""
    st, mt = scene
    B, n = 2, st.ndof_q
    rng = np.random.RandomState(0)
    q = mt.q_init.numpy()[:, None] + 0.01 * rng.randn(n, B)
    q[1] = rng.uniform(0.0005, 0.003, B)     # pad pressing on the box
    q[5] = rng.uniform(-0.0005, 0.0, B)      # box pressing on the ground
    v = 0.01 * rng.randn(n, B)
    u = _t(0.3 * rng.randn(st.ndof_u, B))
    pw = torch_lc.make_pair_wrenches(st)
    state = torch_lanes.LaneSimState(
        q=_t(q), qdot=_t(v), q_prev=_t(q), qdot_prev=_t(v),
        t=torch.zeros(B, dtype=torch.int32))
    got = torch_lanes.build_env_step(st, 5, refresh=2, fused_pw=pw)(
        mt, state, u)
    assert pw[0].twin_vjps == 3 * n
    res = torch_lanes.make_residual(st, pw)
    tol = max(st.solver_tol, 1e-12)
    s, lu = state, None
    for k in range(5):
        inputs = torch_lanes.StepInputs(
            model=mt, u=u, q_base=s.q,
            p_base=torch_lanes.momentum(st, mt, s.q, s.qdot),
            gamma=mt.h.reshape(1, 1))
        if k % 2 == 0:
            lu = torch_lanes.make_chord_lu(res, inputs, s.qdot)
        v_new = torch_lanes._chord(res, st.solver_max_iter, tol, inputs,
                                   s.qdot, lu)
        s = torch_lanes.LaneSimState(q=s.q + mt.h * v_new, qdot=v_new,
                                     q_prev=s.q, qdot_prev=s.qdot,
                                     t=s.t + 1)
    for a, b in zip(got, s):
        assert torch.equal(a, b)


def _inject(env, reset, steps):
    """Hand ``env`` the draws: reset (box y (B,), goal (3, B)), then one
    (keep_zero (B,), force (2, B)) per step, for lanes ``idx``."""
    it = iter(steps)

    def draw(what, nb):
        if what == "reset":
            return tuple(x[..., :nb].clone() for x in reset)
        keep, force = next(it)
        return keep[:nb].clone(), force[:, :nb].clone()
    env._draw = draw


def test_refresh1_lanes_match_single_instance():
    rng = np.random.RandomState(3)
    B, H = 3, 3
    reset = (_t(rng.uniform(-0.02, 0.02, B)),
             _t(np.stack([rng.uniform(0.15, 0.25, B),
                          rng.uniform(-0.2, 0.2, B),
                          rng.uniform(-0.5, 0.5, B)])))
    steps = [(_t(rng.uniform(size=B) >= 0.5), _t(rng.uniform(-1, 1, (2, B))))
             for _ in range(H)]
    us = [_t(np.stack([np.full(B, 1.5), 0.3 * rng.randn(B),
                       0.3 * rng.randn(B)], axis=1)) for _ in range(H)]
    singles = []
    for lane in range(B):
        env = tactile_push.make("no_tactile", device="cpu", dtype=F64)
        _inject(env, [x[..., lane:lane + 1] for x in reset],
                [(k[lane:lane + 1], f[:, lane:lane + 1]) for k, f in steps])
        state, _ = env.reset()
        qs = []
        with torch.no_grad():
            for u in us:
                state, *_ = env.step(state, u[lane])
                qs.append((state.sim.q, state.sim.qdot))
        singles.append(qs)
    for nb in (2, 3):
        lenv = tactile_push_lanes.make("no_tactile", device="cpu", dtype=F64,
                                       solver_refresh=1)
        assert lenv.max_iter == lenv.struct.solver_max_iter
        _inject(lenv, reset, steps)
        state, _ = lenv.reset(nb)
        with torch.no_grad():
            for k, u in enumerate(us):
                state, *_ = lenv.step(state, u[:nb])
                for lane in range(nb):
                    q, qd = singles[lane][k]
                    _close(state.sim.q[:, lane], q, 1e-8)
                    _close(state.sim.qdot[:, lane], qd, 1e-8)


def test_rebuild_solver_rules():
    env = tactile_push_lanes.make("privilege", device="cpu", dtype=F64)
    m = env.struct.solver_max_iter
    assert (env.max_iter, env.solver_mega) == (max(m + 2, 8), False)
    env.rebuild_solver(refresh=1)
    assert (env.max_iter, env.solver_mega) == (m, False)
    env.rebuild_solver(max_iter=3)
    assert env.max_iter == 3
    env.rebuild_solver(refresh=2, bwd_mode="refine3", max_iter=4)
    assert (env.max_iter, env.solver_mega) == (4, False)
    assert lanes_launches(env) == (3 + 5 * 5, 21, 5, 25)
    with pytest.raises(ValueError, match="bwd_mode"):
        env.rebuild_solver(bwd_mode="exactly")

    rng = np.random.RandomState(2)
    q, v = resting_contact(env.model.q_init.numpy(), 2, 7, pad_speed=0.01)
    u = _t(0.3 * rng.randn(env.ndof_u + 3, 2))
    state = torch_lanes.LaneSimState(q=_t(q), qdot=_t(v), q_prev=_t(q),
                                     qdot_prev=_t(v),
                                     t=torch.zeros(2, dtype=torch.int32))
    outs = []
    for fused in (True, False):
        env.rebuild_solver(fused=fused)
        assert (env.pair_wrenches is not None) == fused
        with torch.no_grad():
            s = env._multi_step(env.model, state, u)
            outs.append((s.q, s.qdot, env.tactile(state.q, state.qdot)))
    for a, b in zip(*outs):
        _close(a, b, 1e-12)
    assert float(outs[0][2].abs().max()) > 0


def test_lanes_remat_matches_without():
    env = tactile_push_lanes.make("tactile_flatten", device="cpu",
                                  dtype=F64, max_iter=2)
    torch.manual_seed(0)
    policy = torch.nn.Linear(env.obs_size()[0], env.ndof_u).double()
    torch.nn.init.normal_(policy.weight, std=1e-3)
    with torch.no_grad():
        policy.bias.copy_(torch.tensor([2.0, 0.0, 0.0]))
    B, H = 2, 2
    runs = []
    for remat in (False, True):
        env.generator.manual_seed(5)
        env.pair_wrenches.reset_counts()
        loss = -torch.sum(env.batched_rollout_fn(policy, H, remat=remat)(B)[0])
        grads = torch.autograd.grad(loss, list(policy.parameters()))
        runs.append((loss.detach(), *grads, env.pair_wrenches.twin_vjps))
    for a, b in zip(runs[0][:-1], runs[1][:-1]):
        _close(b, a, 1e-12)
    _, fwd_k1t, _, bwd_k1t = lanes_launches(env)
    obs_pulls = H - 1
    assert runs[0][-1] == H * (fwd_k1t + bwd_k1t) + obs_pulls
    assert runs[1][-1] == H * (2 * fwd_k1t + bwd_k1t) + obs_pulls
