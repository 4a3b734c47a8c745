"""The slice end to end: a TactilePush ``tactile_flatten`` forward policy
rollout of the port against the JAX lanes env (mega=False), float64.

H = 3 env steps at B = 4, with the flax actor's parameters carried over by
``convert.py``, and JAX's reset state and disturbance draws handed to the
port through ``TactilePushLanes._draw``. Observations (tactile field
included), rewards and every ``info`` key must agree to 1e-6 relative: the
chord solves can differ by one masked iteration on a lane whose residual
straddles the tolerance (see tests/test_torch_lanes.py).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.envs import tactile_push_lanes as jax_tpl
from tactilesimulation_tpu.models import nets as jax_nets
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.envs import tactile_push_lanes as torch_tpl
from tactilesimulation_tpu_torch.models import nets as torch_nets

torch.set_num_threads(1)

B, H = 4, 3
CFG = {"actor_mlp": {"layer_sizes": [64, 64], "activation": "elu",
                     "layernorm": False},
       "actor_logstd_init": -1.0}


def _jax_draws(jenv, keys, horizon):
    """JAX's reset draws and per-step disturbance draws (numpy)."""
    state, _ = jenv.reset(keys)
    reset = (np.asarray(state.sim.q[4]), np.asarray(state.goal))
    steps = []
    k = state.keys
    for _ in range(horizon):
        k3 = jax.vmap(lambda kk: jax.random.split(kk, 3))(k)
        kf1, kf2, k = k3[:, 0], k3[:, 1], k3[:, 2]
        keep_zero = jax.vmap(jax.random.uniform)(kf1) >= 0.5
        sampled = jax.vmap(lambda kk: jax.random.uniform(
            kk, (2,), minval=-1.0, maxval=1.0, dtype=jnp.float64))(kf2).T
        steps.append((np.asarray(keep_zero), np.asarray(sampled)))
    return reset, steps


def test_rollout_matches_jax_lanes_env():
    jenv = jax_tpl.make("tactile_flatten")
    assert not jenv.solver_mega and jenv._pw is None   # the lanes stepper
    actor_j = jax_nets.DiagGaussianActor(3, CFG)
    obs_dim = jenv.env.obs_size()[0]
    params = flax.core.unfreeze(
        actor_j.init(jax.random.PRNGKey(0), jnp.zeros(obs_dim)))
    # push the pad towards the box (action 0 drives the gripper's x), so the
    # tactile field switches on within the H steps
    params["params"]["Dense_0"]["bias"] = jnp.asarray([2.0, 0.0, 0.0])
    keys = jax.random.split(jax.random.PRNGKey(1), B)

    def policy_apply(p, obs):
        return actor_j.apply(p, obs, deterministic=True, method=actor_j.act)

    r_j, d_j, info_j, obs_j = jenv.batched_rollout_fn(
        policy_apply, H, with_obs=True)(params, keys)
    (box_y, goal), steps = _jax_draws(jenv, keys, H)

    env = torch_tpl.make("tactile_flatten", device="cpu", dtype=torch.float64)
    assert env.max_iter == 8
    draws = iter(steps)

    def injected(what, nb):
        assert nb == B
        if what == "reset":
            return torch.tensor(box_y), torch.tensor(goal)
        keep_zero, sampled = next(draws)
        return torch.tensor(keep_zero), torch.tensor(sampled)

    env._draw = injected
    actor_t = torch_nets.DiagGaussianActor(obs_dim, 3, CFG).double()
    actor_t.load_state_dict(convert.actor_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    r_t, d_t, info_t, obs_t = env.batched_rollout_fn(actor_t.act, H,
                                                     with_obs=True)(B)

    def close(got, want, name):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, name
        # the rollout keeps the autograd graph to the actor (BPTT)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.max(np.abs(want))),
                                   err_msg=name)

    close(obs_t, obs_j, "obs")
    assert float(np.max(np.abs(np.asarray(obs_j)[:, :, 3:]))) > 0, \
        "the tactile field never switched on"
    close(r_t, r_j, "reward")
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert sorted(info_t) == sorted(info_j)
    for k in info_j:
        close(info_t[k], info_j[k], k)
    # K1's CPU route (the plain twin) ran; the kernel never launched
    op = env.pair_wrenches
    assert op.launches == 0
    assert (op.twin_recomputes, op.twin_vjps) == (H, H * 7)


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_tpl.make("tactile_flatten")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_tpl.TactilePushLanes("no_tactile")
    env = torch_tpl.make("no_tactile", device="cpu")
    assert env.model.device.type == "cpu"
    assert env.model.dtype == torch.float32
