"""GD over any env (``algorithms/gd.py``) and its CLI
(``examples/train_tactile_push_gd.py``), float64 on the CPU.

- the rollout env: ``TactilePush-v1`` takes its lane env, and
  ``lane_rollouts: false`` the env itself; a lane env handed in is its own;
- one epoch of GD on the pendulum (no lane env: E single instances one
  after another) against the JAX package's ``GD`` on its ``PendulumEnv``,
  the same actor weights (``convert.py``) and the same reset draws (JAX's
  epoch keys, handed to the port through ``env._draw``): loss, episode
  rewards, the gradient (JAX's first Adam moment over (1 - b1), no
  clipping), its norm and the updated parameters to 1e-9 of scale, with
  remat on and off (JAX's GD is built once, without remat: remat changes
  none of its numbers);
- ``evaluate`` plays single-instance episodes;
- the CLI with ``--device cpu``: one epoch on a cut copy of
  ``gd_tactile.yaml`` (2 episodes) with the registry's episode length
  patched to 2, then ``--play`` of the saved model.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tactilesimulation_tpu.algorithms.gd import GD as JaxGD
from tactilesimulation_tpu.envs import pendulum as jax_pendulum
from tactilesimulation_tpu_torch import convert, envs
from tactilesimulation_tpu_torch.algorithms.gd import GD
from tactilesimulation_tpu_torch.envs import pendulum, tactile_push_lanes
from tactilesimulation_tpu_torch.examples import train_tactile_push_gd

torch.set_num_threads(1)

F64 = torch.float64
CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "TactilePushExp", "cfg", "gd_tactile.yaml")
E, H = 2, 3
PEND_CFG = {"config": {"num_epochs": 4, "num_episodes": E, "lr": 0.05,
                       "betas": [0.7, 0.95], "truncate_grads": False},
            "network": {"actor_mlp": {"layer_sizes": [8],
                                      "activation": "elu"}}}


def _gd_cfg(**config):
    with open(CFG_PATH) as fp:
        cfg = yaml.safe_load(fp)["params"]
    cfg["config"].update(config)
    return cfg


def test_rollout_env_routing():
    env = envs.make("TactilePush-v1", device="cpu", dtype=F64)
    assert isinstance(GD(env, _gd_cfg()).rollout_env,
                      tactile_push_lanes.TactilePushLanes)
    single = GD(env, _gd_cfg(lane_rollouts=False))
    assert single.rollout_env is env and single.remat
    lane = tactile_push_lanes.make("no_tactile", device="cpu")
    assert GD(lane, _gd_cfg(remat=False)).rollout_env is lane


@pytest.fixture(scope="module")
def jax_epoch():
    """JAX's GD on the pendulum, one epoch: (epoch keys' reset draws,
    initial params, loss, episode rewards, gradient, gradient norm,
    updated params)."""
    env = jax_pendulum.make()
    env.max_episode_steps = H
    cfg = dict(PEND_CFG, config=dict(PEND_CFG["config"], remat=False))
    gd_j = JaxGD(env, cfg, seed=1)
    # flax initialises the actor's parameters in float32: in float64, as
    # the port's
    gd_j.params = jax.tree.map(lambda x: x.astype(jnp.float64), gd_j.params)
    gd_j.opt_state = gd_j.optimizer.init(gd_j.params)
    p0 = jax.tree.map(np.asarray, gd_j.params)
    key, *ekeys = jax.random.split(gd_j._train_key, E + 1)
    draws = []
    for k in ekeys:
        kq, kw, _ = jax.random.split(k, 3)
        draws.append((np.asarray(jax.random.uniform(
            kq, (1,), minval=-jnp.pi, maxval=jnp.pi, dtype=jnp.float64)),
            np.asarray(jax.random.uniform(kw, (1,), minval=-1.0, maxval=1.0,
                                          dtype=jnp.float64))))
    params, opt_state, loss, aux, gnorm, _ = gd_j._update(
        gd_j.params, gd_j.opt_state, jnp.stack(ekeys), None)
    b1 = PEND_CFG["config"]["betas"][0]
    adam = opt_state
    while not hasattr(adam, "mu"):        # optax chains nest tuples
        adam = next(x for x in adam if hasattr(x, "mu")
                    or isinstance(x, tuple))
    grad = jax.tree.map(lambda m: np.asarray(m) / (1.0 - b1), adam.mu)
    return dict(draws=draws, p0=p0, loss=float(loss),
                rewards=np.asarray(aux[0]), grad=grad, gnorm=float(gnorm),
                params=jax.tree.map(np.asarray, params))


def _state_dict(tree):
    return convert.actor_params_from_numpy(tree)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_pendulum_epoch_matches_jax(jax_epoch, remat):
    env = pendulum.make(device="cpu", dtype=F64)
    env.max_episode_steps = H
    assert env.lane_env() is None
    gd = GD(env, dict(PEND_CFG, config=dict(PEND_CFG["config"],
                                            remat=remat)), seed=1)
    assert gd.rollout_env is env and gd.remat == remat
    gd.actor.load_state_dict(_state_dict(jax_epoch["p0"]))
    draws = iter(jax_epoch["draws"])
    env._draw = lambda what, b: tuple(torch.tensor(x) for x in next(draws))
    loss, ep_rewards, _, gnorm = gd.update()
    scale = lambda w: 1e-9 * max(float(np.max(np.abs(w))), 1e-300)
    assert abs(float(loss) - jax_epoch["loss"]) <= scale(jax_epoch["loss"])
    np.testing.assert_allclose(ep_rewards.numpy(), jax_epoch["rewards"],
                               rtol=0, atol=scale(jax_epoch["rewards"]))
    assert abs(float(gnorm) - jax_epoch["gnorm"]) <= scale(jax_epoch["gnorm"])
    want_g = _state_dict(jax_epoch["grad"])
    names = [k for k, _ in gd.actor.named_parameters()]
    for name, m in zip(names, gd.optimizer.mu):
        g = m / (1.0 - gd.betas[0])
        w = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=scale(w),
                                   err_msg=name)
    want_p = _state_dict(jax_epoch["params"])
    for name, p in gd.actor.named_parameters():
        w = want_p[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=scale(w), err_msg=name)


def test_evaluate_plays_single_instances():
    env = envs.make("TactilePush-v1", device="cpu", dtype=F64)
    env.max_episode_steps = 1
    gd = GD(env, _gd_cfg())
    stepped = []
    step = env.step
    env.step = lambda *a, **k: stepped.append(1) or step(*a, **k)
    lane_step = gd.rollout_env.step
    gd.rollout_env.step = lambda *a, **k: pytest.fail("the lane env ran")
    assert np.isfinite(gd.evaluate(num_games=1))
    assert len(stepped) == 1
    gd.rollout_env.step = lane_step


def test_cli_trains_and_plays(tmp_path, monkeypatch):
    factory, _ = envs._REGISTRY["TactilePush-v1"]
    monkeypatch.setitem(envs._REGISTRY, "TactilePush-v1", (factory, 2))
    with open(CFG_PATH) as fp:
        cfg = yaml.safe_load(fp)
    cfg["params"]["config"].update(num_epochs=1, num_episodes=2)
    cut = tmp_path / "gd_cut.yaml"
    cut.write_text(yaml.safe_dump(cfg))
    logdir = tmp_path / "run"
    common = ["--cfg", str(cut), "--device", "cpu"]
    r = train_tactile_push_gd.main(common + ["--no-time-stamp", "--logdir",
                                             str(logdir)])
    assert np.isfinite(r)
    assert (logdir / "logs.txt").read_text().startswith("epoch 0:")
    model = logdir / "models" / "final_policy.pt"
    blob = torch.load(model, weights_only=True)
    assert all(v.dtype == F64 for v in blob["params"].values())
    r = train_tactile_push_gd.main(common + ["--play", "--checkpoint",
                                             str(model)])
    assert np.isfinite(r)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_tactile_push_gd.main(["--cfg", str(cut)])
