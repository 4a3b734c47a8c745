"""The port's env base and single-instance envs against the JAX package's
``make()`` envs, float64 on the CPU.

- TactilePush: a reset and 3 env steps (frame_skip 5 each) pushing the pad
  into the box, with JAX's reset and disturbance draws handed to the port
  through ``_draw`` (the t = 0 step resamples a non-zero disturbance):
  q, qdot and the observation of every obs type within 1e-9 of their
  scale; the reward and each ``info`` term within 1e-9 of the reward's
  scale. JAX runs one jitted ``value_and_grad`` of a step (its outputs
  and d reward / d u), from which the first step's action gradient (H = 1
  BPTT) is held to 1e-8 relative; the JAX observation of each obs type is
  its env's ``_get_obs`` on the JAX trajectory and its field (the
  dynamics do not depend on the obs type);
- the observation's read route: under ``no_grad`` the field comes from
  the read kernel's query (its plain version on the CPU), under grad from
  ``dynamics.tactile_field`` with its graph;
- the pendulum: reset and 2 steps, and the 2-step BPTT gradient of
  ``rollout_fn`` (remat) with a linear policy against ``jax.grad`` of the
  JAX env's ``rollout_fn``, to 1e-8 relative; ``batched_rollout_fn``
  against single rollouts;
- ``tactile_forces_array``, the two TactilePush envs' ``_draw`` (the same
  draws from equally seeded generators), the registry and the gym
  wrapper.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.envs import pendulum as jax_pend
from tactilesimulation_tpu.envs import tactile_insertion as jax_ti
from tactilesimulation_tpu.envs import tactile_push as jax_tp
from tactilesimulation_tpu.sim import dynamics as jax_dynamics
from tactilesimulation_tpu_torch import envs
from tactilesimulation_tpu_torch.envs import dclaw_rotate as torch_dc
from tactilesimulation_tpu_torch.envs import gym_wrapper
from tactilesimulation_tpu_torch.envs import pendulum as torch_pend
from tactilesimulation_tpu_torch.envs import stable_grasp as torch_sg
from tactilesimulation_tpu_torch.envs import tactile_insertion as torch_ti
from tactilesimulation_tpu_torch.envs import tactile_push as torch_tp
from tactilesimulation_tpu_torch.envs import tactile_push_lanes
from tactilesimulation_tpu_torch.ops import tactile_query

torch.set_num_threads(1)

F64 = torch.float64
PUSH_KEY = 2            # its t = 0 step resamples a non-zero disturbance
PUSH_US = np.array([[2.0, 0.3, -0.2], [2.0, -0.1, 0.1], [1.5, 0.0, 0.0]])


def injector(reset, steps):
    """A ``_draw`` for either TactilePush env (the single instance at
    B = 1): ``reset`` = (box y (B,), goal (3, B)), ``steps`` = per step
    (keep_zero (B,), sampled force (2, B)), numpy."""
    it = iter(steps)

    def draw(what, B):
        if what == "reset":
            box_y, goal = reset
            assert box_y.shape == (B,)
            return torch.tensor(box_y), torch.tensor(goal)
        keep_zero, sampled = next(it)
        assert keep_zero.shape == (B,)
        return torch.tensor(keep_zero), torch.tensor(sampled)
    return draw


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


@pytest.fixture(scope="module")
def push_jax():
    """JAX's TactilePush trajectory, its draws and the first step's
    d reward / d u. The step runs in the privilege env (whose step reads no
    field; the dynamics and the reward do not depend on the obs type), and
    the field of each state comes from ``dynamics.tactile_field`` as the
    tactile envs' steps take it."""
    jenv = jax_tp.make("privilege")

    def step_and_grad(state, u):
        def reward(u):
            s, _, r, _, info = jenv.step(state, u)
            return r, (s, info)
        (r, aux), g = jax.value_and_grad(reward, has_aux=True)(u)
        return r, aux, g

    fn = jax.jit(step_and_grad)
    field = jax.jit(lambda q, v: jax_dynamics.tactile_field(
        jenv.struct, jenv.model, q, v).reshape(-1))
    state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(PUSH_KEY))
    draws_reset = (np.asarray(state.sim.q[4:5]),
                   np.asarray(state.extras.goal)[:, None])
    q = state.sim.q
    traj = [dict(q=q, qdot=state.sim.qdot, tactile=field(q, 0 * q))]
    draws, rewards, infos, grads = [], [], [], []
    for u in PUSH_US:
        kf1, kf2, _ = jax.random.split(state.key, 3)
        keep_zero = jax.random.uniform(kf1) >= 0.5
        sampled = jax.random.uniform(kf2, (2,), minval=-1.0, maxval=1.0,
                                     dtype=jnp.float64)
        draws.append((np.asarray(keep_zero)[None],
                      np.asarray(sampled)[:, None]))
        r, (state, info), g = fn(state, jnp.asarray(u))
        traj.append(dict(q=state.sim.q, qdot=state.sim.qdot,
                         tactile=field(state.sim.q, state.sim.qdot)))
        rewards.append(float(r))
        infos.append({k: float(v) for k, v in info.items()})
        grads.append(np.asarray(g))
    assert not draws[0][0][0], "the t = 0 step must resample a force"
    assert np.abs(np.asarray(traj[-1]["tactile"])).max() > 0, \
        "the pad never touched the box"
    return dict(traj=traj, goal=state.extras.goal,
                draws=(draws_reset, draws), rewards=rewards, infos=infos,
                grad0=grads[0])


def jax_obs(obs_type, row, goal):
    return jax_tp.make(obs_type)._get_obs(row["q"], row["tactile"], goal)


@pytest.mark.parametrize("obs_type", torch_tp.OBS_TYPES)
def test_tactile_push_matches_jax(push_jax, obs_type):
    env = torch_tp.make(obs_type, device="cpu", dtype=F64)
    env._draw = injector(*push_jax["draws"])
    traj, goal = push_jax["traj"], push_jax["goal"]
    with torch.no_grad():
        state, obs = env.reset()
        rows = [(state, obs, None, None)]
        for u in PUSH_US:
            state, obs, r, done, info = env.step(state, torch.tensor(u))
            rows.append((state, obs, r, info))
            assert not bool(done)
    r_scale = max(abs(r) for r in push_jax["rewards"])
    for k, ((state, obs, r, info), want) in enumerate(zip(rows, traj)):
        for name in ("q", "qdot"):
            err = scale_err(getattr(state.sim, name), want[name])
            assert err <= 1e-9, (k, name, err)
        want_obs = jax_obs(obs_type, want, goal)
        if obs_type == "tactile_map":
            assert obs[0].shape == (3, 13, 10) and obs[1].shape == (3,)
            pairs = zip(obs, want_obs)
        else:
            pairs = [(obs, want_obs)]
        for got, w in pairs:
            assert got.shape == w.shape
            err = scale_err(got, w)
            assert err <= 1e-9, (k, obs_type, err)
        if obs_type == "tactile_flatten":
            # the field alone, against its own scale (zero before contact)
            field = np.asarray(want["tactile"])
            err = np.abs(obs[3:].numpy() - field).max()
            assert err <= 1e-9 * max(np.abs(field).max(), 1e-12), (k, err)
        if not env._needs_tactile:
            assert not bool(state.extras.tactile.any())
        if r is None:
            continue
        assert abs(float(r) - push_jax["rewards"][k - 1]) <= 1e-9 * r_scale
        for name, w in push_jax["infos"][k - 1].items():
            assert abs(float(info[name]) - w) <= 1e-9 * r_scale, (k, name)
    assert int(state.t) == len(PUSH_US)


def test_tactile_push_action_gradient_matches_jax(push_jax):
    """H = 1: d reward / d u of the first step, from the reset."""
    env = torch_tp.make("tactile_flatten", device="cpu", dtype=F64)
    env._draw = injector(*push_jax["draws"])
    state, _ = env.reset()
    u = torch.tensor(PUSH_US[0], requires_grad=True)
    _, obs, reward, _, _ = env.step(state, u)
    # under grad the field keeps its graph (dynamics.tactile_field)
    assert obs.requires_grad
    (g,) = torch.autograd.grad(reward, u)
    want = push_jax["grad0"]
    err = np.abs(g.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-8, (g.numpy(), want, err)


def test_observation_read_route(monkeypatch):
    """No grad: the read kernel's query, once per read; under grad: the
    differentiable field, no query."""
    calls = []
    query = tactile_query.tactile_field

    def counted(*args):
        calls.append(1)
        return query(*args)

    monkeypatch.setattr(tactile_query, "tactile_field", counted)
    env = torch_tp.make("tactile_map", device="cpu", dtype=F64)
    with torch.no_grad():
        state, (img, _) = env.reset()
    assert len(calls) == 1 and not img.requires_grad
    q = state.sim.q.clone().requires_grad_()
    field = env._tactile(q, torch.zeros_like(q))
    assert len(calls) == 1 and field.requires_grad
    priv = torch_tp.make("privilege", device="cpu", dtype=F64)
    with torch.no_grad():
        priv.reset()
    assert len(calls) == 1          # privilege reads no field


def test_tactile_forces_array_matches_jax():
    flat = np.random.RandomState(0).randn(390) * 1e-3
    env = torch_tp.make("tactile_flatten", device="cpu", dtype=F64)
    got = env.tactile_forces_array(torch.tensor(flat)).numpy()
    want = np.asarray(jax_tp.make().tactile_forces_array(jnp.asarray(flat)))
    assert got.shape == (1, 1, 13, 10, 3)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def test_draws_match_the_lanes_env():
    """Both TactilePush envs take the same draws in the same order."""
    single = torch_tp.make("privilege", device="cpu", dtype=F64, seed=7)
    lanes = tactile_push_lanes.make("privilege", device="cpu", dtype=F64,
                                    seed=7)
    for what in ("reset", "disturbance", "disturbance"):
        for a, b in zip(single._draw(what, 1), lanes._draw(what, 1)):
            assert torch.equal(a, b), what
    twin = single.lane_env()
    assert twin.env is single and twin.model is single.model


def _pend_draws(key):
    kq, kw, _ = jax.random.split(key, 3)
    q = jax.random.uniform(kq, (1,), minval=-jnp.pi, maxval=jnp.pi,
                           dtype=jnp.float64)
    w = jax.random.uniform(kw, (1,), minval=-1.0, maxval=1.0,
                           dtype=jnp.float64)
    return torch.tensor(np.asarray(q)), torch.tensor(np.asarray(w))


def _pend_env(keys):
    env = torch_pend.make(device="cpu", dtype=F64)
    it = iter(keys)
    env._draw = lambda what, B: _pend_draws(next(it))
    return env


def test_pendulum_matches_jax():
    jenv = jax_pend.make()
    key = jax.random.PRNGKey(4)
    js, jo = jenv.reset(key)
    env = _pend_env([key])
    with torch.no_grad():
        s, o = env.reset()
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-12)
        step = jax.jit(jenv.step)
        for u in ([0.7], [-0.4]):
            js, jo, jr, _, jinfo = step(js, jnp.asarray(u))
            s, o, r, d, info = env.step(s, torch.tensor(u, dtype=F64))
            assert scale_err(s.sim.q, js.sim.q) <= 1e-9
            assert scale_err(s.sim.qdot, js.sim.qdot) <= 1e-9
            assert scale_err(o, jo) <= 1e-9
            assert abs(float(r) - float(jr)) <= 1e-9 * abs(float(jr))
            assert abs(float(info["angle_err"]) - float(
                jinfo["angle_err"])) <= 1e-9
            assert not bool(d)


def test_pendulum_bptt_gradient_matches_jax():
    """2 steps of ``rollout_fn`` (remat, a checkpoint per step) with a
    linear policy: the gradient of the summed reward w.r.t. its
    parameters against ``jax.grad`` of the JAX env's ``rollout_fn``."""
    jenv = jax_pend.make()
    rng = np.random.RandomState(0)
    W0, b0 = 0.5 * rng.randn(1, 3), np.array([0.3])
    key = jax.random.PRNGKey(5)
    run_j = jenv.rollout_fn(lambda p, o: p["W"] @ o + p["b"], 2)
    gj = jax.jit(jax.grad(lambda p: jnp.sum(run_j(p, key)[0])))(
        {"W": jnp.asarray(W0), "b": jnp.asarray(b0)})

    W = torch.tensor(W0, requires_grad=True)
    b = torch.tensor(b0, requires_grad=True)
    for remat in (True, False):
        env = _pend_env([key])
        rewards, dones, infos = env.rollout_fn(lambda o: W @ o + b, 2,
                                               remat=remat)()
        assert rewards.shape == (2,) and infos["angle_err"].shape == (2,)
        gW, gb = torch.autograd.grad(torch.sum(rewards), (W, b))
        for got, want in ((gW, gj["W"]), (gb, gj["b"])):
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert err <= 1e-8, (remat, got, want)


def test_batched_rollout_matches_single_rollouts():
    keys = [jax.random.PRNGKey(k) for k in (1, 2)]
    policy = lambda o: 0.5 * o[:1]
    env = _pend_env(keys)
    with torch.no_grad():
        rewards, dones, infos, obs = env.batched_rollout_fn(
            policy, 2, with_obs=True)(2)
    assert rewards.shape == (2, 2) and dones.shape == (2, 2)
    assert obs.shape == (2, 2, 3) and infos["angle_err"].shape == (2, 2)
    for e, key in enumerate(keys):
        with torch.no_grad():
            r, _, _ = _pend_env([key]).rollout_fn(policy, 2)()
        assert torch.equal(r, rewards[e])


def _no_settle(*args, **kwargs):
    raise AssertionError("the shipped start pose was not used")


def test_registry():
    env = envs.make("TactilePush-v1", observation_type="privilege",
                    device="cpu", dtype=F64)
    assert isinstance(env, torch_tp.TactilePushEnv)
    assert env.max_episode_steps == 100 and env.ndof_u == 3
    assert env.obs_size() == (6,)
    assert not hasattr(envs, "_not_ported")
    # StableGrasp-v1 builds from its shipped start pose: no settle runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_sg, "settle", _no_settle)
        grasp = envs.make("StableGrasp-v1", device="cpu", dtype=F64)
    assert isinstance(grasp, torch_sg.StableGraspEnv)
    assert grasp.max_episode_steps == 10 and grasp.ndof_u == 1
    assert grasp.obs_size() == (4, 13, 10)
    claw = envs.make("TactileRotation-v1", observation_type="no_tactile",
                     device="cpu", dtype=F64)
    assert isinstance(claw, torch_dc.DClawRotateEnv)
    assert claw.max_episode_steps == 200 and claw.ndof_u == 9
    assert claw.obs_size() == (18,)
    # Insertion-v3 builds from the shipped start pose: no settle runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_ti, "settle", _no_settle)
        ins = envs.make("Insertion-v3", device="cpu", dtype=F64,
                        num_obs_frames=5)
    assert isinstance(ins, torch_ti.TactileInsertionEnv)
    assert ins.max_episode_steps == 15
    assert ins.obs_size() == jax_ti.TactileInsertionEnv.obs_size(
        types.SimpleNamespace(observation_type="tactile_map",
                              tactile_samples=5))
    with pytest.raises(NotImplementedError):
        torch_tp.make(scene_path="pusher.xml", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_tp.make()


def test_gym_wrapper():
    env = torch_pend.make(device="cpu", dtype=F64)
    env.max_episode_steps = 2
    gym = gym_wrapper.GymEnv(env, seed=3)
    obs = gym.reset()
    assert isinstance(obs, np.ndarray) and obs.shape == (3,)
    assert gym.action_shape == (1,) and gym.observation_shape == (3,)
    obs1, r, done, info = gym.step(np.array([0.2]))
    assert isinstance(r, float) and not done and "angle_err" in info
    obs2, r2, done, info = gym.step(np.array([0.2]))
    assert done and info["TimeLimit.truncated"]
    # the same episode straight through the functional env
    ref = torch_pend.make(device="cpu", dtype=F64, seed=3)
    with torch.no_grad():
        s, o = ref.reset()
        s, o, rr, _, _ = ref.step(s, torch.tensor([0.2], dtype=F64))
    np.testing.assert_array_equal(obs1, o.numpy())
    assert r == float(rr)
    with pytest.raises(NotImplementedError):
        gym.render()
