"""The port's DClaw env steps against the JAX package, float64 on the CPU.

A reset (key 25 of ``tests/test_torch_dclaw.py``: all three fingertips on
the cap) and 2 env steps in relative control, against JAX's jitted
``value_and_grad`` of the step's reward (one trace and compile serve both
steps; the trace of the step's Newton solve takes most of this file's
time): q, qdot, the three observation types, reward, done and success
within 1e-9 of scale, and the first step's action gradient within 1e-6
(the second action reaches past the clip, where the power penalty still
takes the unclipped action).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.envs import dclaw_rotate as jdc
from tactilesimulation_tpu_torch.envs import dclaw_rotate as tdc

torch.set_num_threads(1)

F64 = torch.float64
KEY = 25
ACTIONS = (np.array([0.4, -0.3, 0.8, 0.1, 0.5, -0.6, 0.2, -0.2, 0.9]),
           np.array([1.6, -0.5, 0.3, -1.3, 0.2, 0.7, 0.0, 1.2, -0.4]))


def scale_err(got, want):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def port_env():
    """The port's env with JAX's reset draws from KEY."""
    kq, kd, kr, kxy, _ = jax.random.split(jax.random.PRNGKey(KEY), 5)
    f64 = jnp.float64
    d = {"noise": jax.random.normal(kq, (9,), f64),
         "damping": jax.random.uniform(kd, minval=0.01, maxval=0.7,
                                       dtype=f64),
         "radius": jax.random.uniform(kr, minval=0.02, maxval=0.08,
                                      dtype=f64),
         "dxy": jax.random.uniform(kxy, (2,), minval=-0.02, maxval=0.02,
                                   dtype=f64)}
    draws = {k: torch.tensor(np.asarray(v))[None] for k, v in d.items()}
    env = tdc.make(device="cpu", dtype=F64)
    env._draw = lambda what, B: draws
    return env


def with_type(env, observation_type):
    other = copy.copy(env)
    other.observation_type = observation_type
    return other


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's reset and 2 relative-control steps from KEY, each step with
    d reward / d u (one jitted value_and_grad)."""
    env_j = jdc.make("tactile")

    def step_and_grad(state, u):
        def reward(u):
            s, obs, r, done, info = env_j.step(state, u)
            return r, (s, obs, done, info)
        (r, aux), g = jax.value_and_grad(reward, has_aux=True)(u)
        return r, aux, g

    fn = jax.jit(step_and_grad)
    state, obs = jax.jit(env_j.reset)(jax.random.PRNGKey(KEY))
    rows = [dict(state=state, obs=obs)]
    for u in ACTIONS:
        r, (state, obs, done, info), g = fn(state, jnp.asarray(u))
        rows.append(dict(state=state, obs=obs, reward=float(r),
                         done=bool(done), success=bool(info["success"]),
                         grad=np.asarray(g)))
    return env_j, rows


def test_steps_and_action_gradient_match_jax(jax_steps):
    env_j, rows = jax_steps
    env = port_env()
    with torch.no_grad():
        state, _ = env.reset()
    got = []
    for i, u in enumerate(ACTIONS):
        u = torch.tensor(u, requires_grad=i == 0)
        with torch.set_grad_enabled(i == 0):
            state, obs, r, done, info = env.step(state, u)
        if i == 0:
            (g,) = torch.autograd.grad(r, u)
            assert scale_err(g, rows[1]["grad"]) <= 1e-6
            assert float(np.abs(rows[1]["grad"]).max()) > 0
        got.append(dict(state=state, obs=obs.detach(), reward=float(r),
                        done=bool(done), success=bool(info["success"])))
    for mine, want in zip(got, rows[1:]):
        sim, sim_j = mine["state"].sim, want["state"].sim
        assert scale_err(sim.q, sim_j.q) <= 1e-9
        assert scale_err(sim.qdot, sim_j.qdot) <= 1e-9
        assert scale_err(mine["obs"], want["obs"]) <= 1e-9
        assert abs(mine["reward"] - want["reward"]) <= \
            1e-9 * max(abs(want["reward"]), 1.0)
        assert (mine["done"], mine["success"]) == (want["done"],
                                                   want["success"])
        # the other observation types at the same state
        model_j = env_j._model_for(want["state"].extras)
        model = env._model_for(mine["state"].extras)
        for ot in ("tactile_flatten", "no_tactile"):
            o_j = copy.copy(env_j)
            o_j.observation_type = ot
            want_o = o_j._get_obs(model_j, sim_j.q, sim_j.qdot,
                                  want["state"].extras.tactile_imgs)
            got_o = with_type(env, ot)._get_obs(
                model, sim.q, mine["state"].extras.tactile_imgs)
            assert scale_err(got_o, want_o) <= 1e-9, ot
    # the fingers moved the cap, and the images saw contact
    assert abs(float(got[-1]["state"].sim.q[-1])) > 0
    assert float(got[0]["obs"][18:].abs().max()) > 0
