"""The port's PPO (``algorithms/ppo.py``) and actor-critic nets against the
JAX package, float64 on the CPU.

- ``ActorCritic`` with MLP and with CNN (``tactile_map``'s (image, state)
  tuple) modules, flax parameters carried over by ``convert``: value,
  mode, log-prob and entropy to 1e-12;
- the exploration noise: the port draws it independently for each env;
  the JAX rollout's ``vmap(act, in_axes=(0, None))`` hands every env one
  key, so every env gets the same noise;
- the ``rms_tree_*`` helpers against JAX's to 1e-12; ``compute_gae``
  against a transcription of the JAX rollout's GAE (dones and time-limit
  bads mixed) to 1e-12; ``ppo_loss`` and its gradient against
  ``jax.value_and_grad`` of a transcription of the JAX loss on the flax
  ``ActorCritic`` to 1e-10; clip + Adam (eps 1e-5) + linear decay against
  the ``optax`` chain over 3 steps to 1e-12;
- the vector env's auto-reset and masks; a small PPO run on the pendulum
  (finite loss, ``play_once`` finite); ``train(stop_update=1)`` + a
  checkpoint + ``resume`` bit-equal to an uninterrupted 2-update run
  (parameters, optimizer, normalisers, env states and every generator); a
  tuple-observation update with CNN modules; the CLI on the CPU, one tiny
  update on TactilePush.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tactilesimulation_tpu.algorithms import ppo as jax_ppo
from tactilesimulation_tpu.models import nets as jax_nets
from tactilesimulation_tpu.utils.running_mean_std import \
    RunningMeanStd as JaxRMS
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.algorithms import gd, ppo
from tactilesimulation_tpu_torch.envs import pendulum
from tactilesimulation_tpu_torch.examples import train_tactile_push_ppo
from tactilesimulation_tpu_torch.models import nets
from tactilesimulation_tpu_torch.utils.running_mean_std import RunningMeanStd
from tactilesimulation_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

F64 = torch.float64
MLP_CFG = {"actor_mlp": {"layer_sizes": [64, 64], "activation": "elu",
                         "layernorm": False},
           "actor_logstd_init": 0,
           "critic_mlp": {"layer_sizes": [64, 64], "activation": "elu",
                          "layernorm": False}}
CNN_CFG = {"actor_cnn": {"layer_sizes": [8, 4], "kernel_sizes": [3, 2],
                         "stride_sizes": [1, 2], "hidden_size": 16,
                         "activation": "elu"},
           "actor_logstd_init": 0.0,
           "critic_cnn": {"layer_sizes": [6], "kernel_sizes": [2],
                          "stride_sizes": [1], "hidden_size": 8,
                          "activation": "tanh"}}
CASES = {
    "mlp": (MLP_CFG, "DiagGaussianActor", "MLPCritic", (393,)),
    "cnn": (CNN_CFG, "CNNActor", "CNNCritic", ((3, 13, 10), (3,))),
}


def _is_tuple_shape(shape):
    return isinstance(shape[0], tuple)


def _obs(shape, rng, n):
    if _is_tuple_shape(shape):
        return tuple(rng.randn(n, *s) for s in shape)
    return rng.randn(n, *shape)


def _pair(case, seed=0):
    """(flax module, its params (randomised), the port's module with them)."""
    cfg, actor_cls, critic_cls, shape = CASES[case]
    ac_j = jax_nets.ActorCritic(3, cfg, actor_cls, critic_cls)
    dummy = jax.tree.map(lambda o: jnp.zeros(o.shape[1:]),
                         _obs(shape, np.random.RandomState(0), 1))
    params = ac_j.init(jax.random.PRNGKey(seed), dummy)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.randn(*np.shape(a))), params)
    ac_t = nets.ActorCritic(shape, 3, cfg, actor_cls, critic_cls).double()
    ac_t.load_state_dict(convert.actor_critic_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    return ac_j, params, ac_t


def _t(x):
    return tuple(torch.tensor(o) for o in x) if isinstance(x, tuple) \
        else torch.tensor(x)


def _j(x):
    return tuple(jnp.asarray(o) for o in x) if isinstance(x, tuple) \
        else jnp.asarray(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_actor_critic_matches_flax(case):
    ac_j, params, ac_t = _pair(case)
    rng = np.random.RandomState(1)
    obs = _obs(CASES[case][3], rng, 5)
    acts = rng.randn(5, 3)
    v_j, mode_j, lp_mode_j = ac_j.apply(params, _j(obs), None, True,
                                        method=ac_j.act)
    v2_j, lp_j, ent_j = ac_j.apply(params, _j(obs), jnp.asarray(acts),
                                   method=ac_j.evaluate_actions)
    with torch.no_grad():
        v_t, mode_t, lp_mode_t = ac_t.act(_t(obs), deterministic=True)
        v2_t, lp_t, ent_t = ac_t.evaluate_actions(_t(obs), torch.tensor(acts))
        gv_t = ac_t.get_value(_t(obs))
    for got, want in ((v_t, v_j), (mode_t, mode_j), (lp_mode_t, lp_mode_j),
                      (v2_t, v2_j), (lp_t, lp_j), (ent_t, ent_j),
                      (gv_t, v_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


def test_exploration_noise_is_independent_across_envs():
    """N envs on the same observation: the port's actions differ (one
    noise vector per env, from the generator); JAX's rollout gives all N
    the same noise (``ppo.py:177-179``)."""
    ac_j, params, ac_t = _pair("mlp")
    N = 4
    obs = np.repeat(np.random.RandomState(2).randn(1, 393), N, axis=0)
    _, acts_j, _ = jax.vmap(
        lambda o, k: ac_j.apply(params, o, k, method=ac_j.act),
        in_axes=(0, None))(jnp.asarray(obs), jax.random.PRNGKey(0))
    acts_j = np.asarray(acts_j)
    assert np.all(acts_j == acts_j[0]), "JAX's envs share one noise vector"

    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        _, acts_t, logp = ac_t.act(torch.tensor(obs), gen)
        mean = ac_t.act(torch.tensor(obs), deterministic=True)[1]
    std = torch.exp(ac_t.actor.logstd)
    noise = torch.randn((N, 3), generator=torch.Generator().manual_seed(3),
                        dtype=F64)
    torch.testing.assert_close(acts_t, mean + std * noise, rtol=1e-14,
                               atol=1e-14)
    assert len({tuple(a) for a in acts_t.numpy().round(12)}) == N
    assert logp.shape == (N, 1)


def test_rms_tree_helpers_match_jax():
    rng = np.random.RandomState(0)
    dummy = (np.zeros((2, 3, 4)), np.zeros((5,)))
    rms_t = ppo.rms_tree_create(_t(dummy), F64)
    rms_j = jax_ppo.rms_tree_create(_j(dummy), jnp.float64)
    for n in (16, 3):
        batch = (rng.randn(n, 2, 3, 4) * 2.0 + 1.0, rng.randn(n, 5) - 3.0)
        rms_t = ppo.rms_tree_update(rms_t, _t(batch))
        rms_j = jax_ppo.rms_tree_update(rms_j, _j(batch))
    for a, b in zip(rms_t, rms_j):
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(a, name).numpy(),
                                       np.asarray(getattr(b, name)),
                                       rtol=1e-12, atol=1e-12)
    obs = (rng.randn(2, 3, 4) * 30, rng.randn(5))
    for a, b in zip(ppo.rms_tree_normalize(rms_t, _t(obs), 10.0),
                    jax_ppo.rms_tree_normalize(rms_j, _j(obs), 10.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    # one filter for a plain vector obs
    single = ppo.rms_tree_create(torch.zeros(7, dtype=F64), F64)
    assert isinstance(single, RunningMeanStd) and single.mean.shape == (7,)


def _gae_transcribed(values, rewards, dones, bads, last_value, gamma, lam):
    """The JAX rollout's compute_gae (algorithms/ppo.py:206-226)."""
    masks = 1.0 - dones.astype(values.dtype)
    bad = bads.astype(values.dtype)

    def body(carry, xs):
        gae = carry
        v, r, mask, b, v_next = xs
        delta = r + gamma * v_next * (mask + b * (1 - mask)) - v
        gae = delta + gamma * lam * (mask + b * (1 - mask)) * gae
        return gae, gae

    v_nexts = jnp.concatenate([values[1:], last_value[None]], axis=0)
    _, advs = jax.lax.scan(body, jnp.zeros_like(last_value),
                           (values, rewards, masks, bad, v_nexts),
                           reverse=True)
    return advs + values, advs


def test_compute_gae_matches_jax():
    rng = np.random.RandomState(0)
    T, N = 9, 3
    values, rewards = rng.randn(T, N), rng.randn(T, N)
    dones = rng.rand(T, N) < 0.3
    bads = dones & (rng.rand(T, N) < 0.5)
    assert bads.any() and (dones & ~bads).any()
    last = rng.randn(N)
    ret_t, adv_t = ppo.compute_gae(
        torch.tensor(values), torch.tensor(rewards), torch.tensor(dones),
        torch.tensor(bads), torch.tensor(last), 0.99, 0.95)
    ret_j, adv_j = _gae_transcribed(
        jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(dones),
        jnp.asarray(bads), jnp.asarray(last), 0.99, 0.95)
    for got, want in ((ret_t, ret_j), (adv_t, adv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


def test_ppo_loss_and_gradient_match_jax():
    """The JAX loss (algorithms/ppo.py:228-245) transcribed on the flax
    ActorCritic, ``jax.value_and_grad`` against the port's autograd."""
    ac_j, params, ac_t = _pair("mlp")
    clip, vcoef, ecoef = 0.2, 0.5, 0.01
    rng = np.random.RandomState(4)
    B = 12
    obs = rng.randn(B, 393)
    actions = rng.randn(B, 3)
    with torch.no_grad():
        v0, lp0, _ = ac_t.evaluate_actions(torch.tensor(obs),
                                           torch.tensor(actions))
    # old log-probs and values off the current ones, so some ratios and
    # value moves are clipped and some are not
    old_logp = lp0[:, 0].numpy() + 0.3 * rng.randn(B)
    old_values = v0[:, 0].numpy() + 0.3 * rng.randn(B)
    returns, advs = rng.randn(B), rng.randn(B)

    def loss_j(p):
        value, logp, entropy = jax.vmap(
            lambda o, a: ac_j.apply(p, o, a, method=ac_j.evaluate_actions))(
                jnp.asarray(obs), jnp.asarray(actions))
        value, logp = value[:, 0], logp[:, 0]
        entropy = entropy.mean()
        ratio = jnp.exp(logp - old_logp)
        surr1 = ratio * advs
        surr2 = jnp.clip(ratio, 1 - clip, 1 + clip) * advs
        action_loss = -jnp.minimum(surr1, surr2).mean()
        v_clipped = old_values + jnp.clip(value - old_values, -clip, clip)
        v_loss = 0.5 * jnp.maximum((value - returns) ** 2,
                                   (v_clipped - returns) ** 2).mean()
        loss = action_loss + vcoef * v_loss - ecoef * entropy
        return loss, (action_loss, v_loss, entropy)

    (lj, aux_j), gj = jax.value_and_grad(loss_j, has_aux=True)(params)
    ratio = np.exp(lp0[:, 0].numpy() - old_logp)
    assert ((ratio < 1 - clip) | (ratio > 1 + clip)).any()
    assert ((ratio > 1 - clip) & (ratio < 1 + clip)).any()

    lt, aux_t = ppo.ppo_loss(ac_t, torch.tensor(obs), torch.tensor(actions),
                             torch.tensor(old_logp), torch.tensor(old_values),
                             torch.tensor(returns), torch.tensor(advs), clip,
                             vcoef, ecoef)
    for got, want in zip((lt,) + tuple(aux_t), (lj,) + tuple(aux_j)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-10, atol=1e-12)
    names = [n for n, _ in ac_t.named_parameters()]
    grads = torch.autograd.grad(lt, list(ac_t.parameters()))
    want = convert.actor_critic_params_from_numpy(
        jax.tree.map(np.asarray, flax.core.unfreeze(gj)))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-10,
                                   atol=1e-10 * scale, err_msg=name)


def test_optimizer_chain_matches_optax():
    """PPO's chain: clip_by_global_norm(max_grad_norm), Adam with eps 1e-5
    and the linear decay to 0 over the run's optimizer steps."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (3,)]
    p0 = [rng.randn(*s) for s in shapes]
    grads = [[scale * rng.randn(*s) for s in shapes]
             for scale in (0.05, 5.0, 0.1)]        # the 2nd is clipped
    lr, steps = 3e-4, 4
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adam(optax.linear_schedule(lr, 0.0, steps),
                                eps=1e-5))
    pj = [jnp.asarray(p) for p in p0]
    state = tx.init(pj)
    pt = [torch.tensor(p) for p in p0]
    opt = gd.Adam(pt, gd.linear_schedule(lr, 0.0, steps), eps=1e-5,
                  max_norm=0.5)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step([torch.tensor(x) for x in g])
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-14)
    # no decay when the run has no update
    assert gd.linear_schedule(lr, 0.0, 0)(5) == lr


class _StubEnv:
    """A deterministic two-coordinate env (no physics, actions ignored):
    its state is its observation; an episode is done once x[0] passes 3
    (from the second reset's start, at the third step), and the time limit
    cuts the others."""
    max_episode_steps = 3
    ndof_u = 1

    def __init__(self):
        self.generator = torch.Generator()
        self.device, self.dtype = torch.device("cpu"), F64
        self.resets = 0

    def reset(self):
        self.resets += 1
        x = torch.tensor([0.9 + 0.1 * (self.resets % 3),
                          -0.3 * self.resets], dtype=F64)
        return x, x

    def step(self, x, action, noise=None):
        x = 1.3 * x + 0.2
        return x, x, 0.5 * x.sum() - 1.0, x[0] > 3.0, {}


def test_rollout_normalisation_matches_jax():
    """The rollout's VecNormalize order (``ppo.py:176-196``), replayed with
    the JAX package's RunningMeanStd: each step normalises its obs with the
    statistics from before the step's update, the return statistics take
    the return before it is zeroed on ``done``, the training reward is
    the raw one over their std, clipped."""
    N, T, gamma, clip = 2, 7, 0.99, 10.0
    cfg = {**PEND_CFG, "config": {**PEND_CFG["config"], "num_processes": N,
                                  "num_steps": T, "num_env_steps": N * T}}
    algo = ppo.PPO(_StubEnv(), cfg, seed=0)
    vec0 = algo.vec_env.reset()
    _, norm, outs = algo.rollout(vec0, algo.norm)
    nobs, _, _, _, r_train, dones, bads, raw = outs
    assert dones.any() and bads.any() and (dones & ~bads).any()

    stub = _StubEnv()
    stub.resets = 1             # the trainer's probe of the obs shapes
    replay = ppo.VecEnv(stub, N)
    vec = replay.reset()
    obs_rms = JaxRMS.create((2,), jnp.float64)
    ret_rms = JaxRMS.create((), jnp.float64)
    returns = np.zeros(N)
    for t in range(T):
        obs = jnp.asarray(vec.obs.numpy())
        want = jnp.clip(obs_rms.normalize(obs), -clip, clip)
        vec, r, d, b = replay.step(vec, torch.zeros((N, 1), dtype=F64))
        returns = returns * gamma + r.numpy()
        ret_rms = ret_rms.update(jnp.asarray(returns))
        want_r = jnp.clip(r.numpy() / jnp.sqrt(ret_rms.var + 1e-8), -clip,
                          clip)
        returns = np.where(d.numpy(), 0.0, returns)
        obs_rms = obs_rms.update(obs)
        np.testing.assert_allclose(nobs[t].numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r_train[t].numpy(), np.asarray(want_r),
                                   rtol=1e-12, atol=1e-12)
        assert torch.equal(dones[t], d) and torch.equal(bads[t], b)
        assert torch.equal(raw[t], r)
    np.testing.assert_allclose(norm.returns.numpy(), returns, rtol=1e-12,
                               atol=1e-12)
    for got, want in ((norm.obs_rms, obs_rms), (norm.ret_rms, ret_rms)):
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-12, atol=1e-12)


def test_update_normalises_advantages_as_jax(monkeypatch):
    """The minibatches get GAE's advantages over the whole batch, less
    their mean, over jnp's (population) std + 1e-5 (``ppo.py:256``)."""
    N, T = 2, 5
    cfg = {**PEND_CFG, "config": {**PEND_CFG["config"], "num_processes": N,
                                  "num_steps": T, "num_env_steps": N * T,
                                  "num_mini_batch": 1, "ppo_epoch": 1}}
    algo = ppo.PPO(_StubEnv(), cfg, seed=0)
    vec, norm, outs = algo.rollout(algo.vec_env.reset(), algo.norm)
    seen = []
    loss = ppo.ppo_loss

    def spy(ac, obs, actions, old_logp, old_values, returns, advs, *a):
        seen.append(advs.detach().clone())
        return loss(ac, obs, actions, old_logp, old_values, returns, advs,
                    *a)

    monkeypatch.setattr(ppo, "ppo_loss", spy)
    with torch.no_grad():
        last = algo.ac.get_value(algo._norm_obs(norm.obs_rms, vec.obs))[:, 0]
    _, advs = ppo.compute_gae(outs[3], outs[4], outs[5], outs[6], last,
                              algo.gamma, algo.gae_lambda)
    algo.update(vec, norm, outs)
    a = jnp.asarray(advs.numpy().reshape(-1))
    want = np.sort(np.asarray((a - a.mean()) / (a.std() + 1e-5)))
    assert len(seen) == 1
    np.testing.assert_allclose(np.sort(seen[0].numpy()), want, rtol=1e-12,
                               atol=1e-12)


PEND_CFG = {
    "network": {"actor": "DiagGaussianActor",
                "actor_mlp": {"layer_sizes": [16], "activation": "elu"},
                "actor_logstd_init": 0.0,
                "critic": "MLPCritic",
                "critic_mlp": {"layer_sizes": [16], "activation": "elu"}},
    "config": {"num_env_steps": 2 * 4 * 2, "num_steps": 4,
               "num_processes": 2, "lr": 3e-4, "ppo_epoch": 2,
               "num_mini_batch": 2, "save_interval": 1},
}


def _pendulum(max_steps=3):
    env = pendulum.make(device="cpu", dtype=F64)
    env.max_episode_steps = max_steps
    return env


def test_vec_env_auto_resets_and_masks():
    env = _pendulum(max_steps=2)
    resets = []
    draw = env._draw
    env._draw = lambda what, B: resets.append(draw(what, B)) or resets[-1]
    vec_env = ppo.VecEnv(env, 2)
    vec = vec_env.reset()
    assert vec.obs.shape == (2, 3) and vec.env_states.sim.q.shape == (2, 1)
    acts = torch.zeros((2, 1), dtype=F64)
    with torch.no_grad():
        vec, r, done, bad = vec_env.step(vec, acts)
        assert r.shape == (2,) and not done.any() and not bad.any()
        assert vec.t.tolist() == [1, 1] and len(resets) == 2
        vec, r, done, bad = vec_env.step(vec, acts)
    # both hit the time limit: ended, bootstrapped (bad), and reset to
    # t = 0 with the new episode's first observation
    assert done.all() and bad.all() and vec.t.tolist() == [0, 0]
    assert int(vec.env_states.t.max()) == 0 and len(resets) == 4
    for i, (q, w) in enumerate(resets[2:]):
        want = torch.cat([torch.cos(q), torch.sin(q), w])
        assert torch.equal(vec.obs[i], want)
        assert torch.equal(vec.env_states.sim.q[i], q)


def test_ppo_runs_on_the_pendulum():
    cfg = {**PEND_CFG, "config": {**PEND_CFG["config"], "num_steps": 8,
                                  "num_env_steps": 2 * 8 * 2}}
    algo = ppo.PPO(_pendulum(max_steps=5), cfg, seed=0)
    assert algo.num_updates == 2
    mean_r = algo.train()
    assert np.isfinite(mean_r) and mean_r < 0
    last = algo.last_update
    assert last["rollout_s"] > 0 and last["update_s"] > 0
    assert last["raw_rewards"].shape == (8, 2)
    assert 0 < last["env_s"] < last["rollout_s"]
    assert last["vec"].obs.shape == (2, 3)
    assert torch.isfinite(last["metrics"]).all()
    assert all(torch.isfinite(p).all() for p in algo.ac.parameters())
    assert int(algo.optimizer.count) == 2 * 2 * 2
    r, length, info = algo.play_once()
    assert np.isfinite(r) and length == 5 and "angle_err" in info


def test_train_checkpoint_resume_is_exact(tmp_path):
    straight = ppo.PPO(_pendulum(), PEND_CFG, logdir=str(tmp_path / "a"),
                       seed=0)
    straight.train()

    first = ppo.PPO(_pendulum(), PEND_CFG, logdir=str(tmp_path / "b"),
                    seed=0)
    first.train(stop_update=1)
    resumed = ppo.PPO(_pendulum(), PEND_CFG, logdir=str(tmp_path / "c"),
                      seed=123)
    resumed.resume(str(tmp_path / "b" / "checkpoint.pt"))
    assert resumed._resume_blob["update"] == 1
    resumed.train()

    sa, sb = straight.ac.state_dict(), resumed.ac.state_dict()
    moved = False
    for (name, a), c in zip(sa.items(), first.ac.state_dict().values()):
        torch.testing.assert_close(sb[name], a, rtol=0, atol=0)
        moved |= not torch.equal(a, c)
    assert moved, "the second update left the parameters where they were"
    oa, ob = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert oa["count"] == ob["count"] == 2 * 2 * 2
    for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"]):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    for x, y in zip(tree_leaves(straight.norm), tree_leaves(resumed.norm)):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    ta, tb = straight._train_state, resumed._train_state
    for x, y in zip(ta["vec"], tb["vec"]):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    for k in ("env", "act", "perm"):
        assert torch.equal(ta["generators"][k], tb["generators"][k]), k
    assert (tmp_path / "c" / "models" / "final_policy.pt").exists()
    # a saved policy loads back
    fresh = ppo.PPO(_pendulum(), PEND_CFG, seed=7)
    fresh.load(str(tmp_path / "a" / "models" / "final_policy.pt"))
    for name, a in sa.items():
        assert torch.equal(fresh.ac.state_dict()[name], a), name


class _TupleObsEnv:
    """The pendulum with its obs re-emitted as an (image, state) tuple:
    the tactile_map observation layout."""

    def __init__(self, env):
        self.env = env
        self.max_episode_steps = env.max_episode_steps
        self.ndof_u = env.ndof_u
        self.generator = env.generator
        self.device, self.dtype = env.device, env.dtype

    def _wrap(self, obs):
        return obs.reshape(1, 1, -1), obs

    def reset(self):
        state, obs = self.env.reset()
        return state, self._wrap(obs)

    def step(self, state, action, noise=None):
        state, obs, r, d, info = self.env.step(state, action)
        return state, self._wrap(obs), r, d, info


def test_tuple_obs_update():
    cnn = {"layer_sizes": [4], "kernel_sizes": [1], "stride_sizes": [1],
           "hidden_size": 8, "activation": "elu"}
    cfg = {"network": {"actor": "CNNActor", "actor_cnn": cnn,
                       "actor_logstd_init": 0.0, "critic": "CNNCritic",
                       "critic_cnn": cnn},
           "config": {**PEND_CFG["config"], "num_env_steps": 8}}
    algo = ppo.PPO(_TupleObsEnv(_pendulum()), cfg, seed=0)
    assert isinstance(algo.norm.obs_rms, tuple)
    assert algo.norm.obs_rms[0].mean.shape == (1, 1, 3)
    assert np.isfinite(algo.train())
    r, _, _ = algo.play_once()
    assert np.isfinite(r)


def test_cli_one_update_on_tactile_push(tmp_path):
    logdir = tmp_path / "run"
    with open(train_tactile_push_ppo.CFG) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(num_processes=2, num_steps=2,
                                   num_env_steps=4, num_mini_batch=2,
                                   ppo_epoch=1)
    cut = tmp_path / "ppo_tactile_cut.yaml"
    with open(cut, "w") as f:
        yaml.safe_dump(cfg, f)
    argv = ["--cfg", str(cut), "--device", "cpu", "--logdir", str(logdir),
            "--no-time-stamp"]
    out = train_tactile_push_ppo.main(argv)
    assert np.isfinite(out)
    assert os.path.exists(logdir / "cfg.yaml")
    blob = torch.load(logdir / "checkpoint.pt", weights_only=True)
    assert blob["update"] == 1
    assert all(torch.isfinite(t).all() for t in blob["params"].values())
    assert (logdir / "models" / "final_policy.pt").exists()
