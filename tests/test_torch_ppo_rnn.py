"""The port's recurrent PPO (``algorithms/ppo_rnn.py``), its GRU cell and
recurrent actor-critic against the JAX package, float64 on the CPU, on
stub envs (no insertion scene is built here).

- ``GRUCell`` against flax's ``nn.GRUCell`` and ``ActorCriticRNN`` (CNN and
  MLP features) against the flax module, parameters carried over by
  ``convert.actor_critic_rnn_params_from_numpy``: value, mode, log-prob,
  entropy and the new hidden state, across masks of 0 and 1, to 1e-12; the
  port's cell has flax's parameter set (no hidden bias on r and z);
- ``compute_gae`` against the JAX trainer's own GAE (its closure) to 1e-12;
- the rollout's bookkeeping against the JAX trainer's own rollout on a
  stub whose dynamics ignore the action: observations normalised with the
  statistics from before the step, the masks (the first from the state
  before the rollout), values, training rewards, done, bad (time limit),
  success, the hidden states and the normalisers, to 1e-12;
- ``minibatch_loss`` (each env's T steps replayed through the GRU) and its
  gradient against ``jax.value_and_grad`` of the JAX trainer's own
  ``mb_loss`` on a stored rollout, to 1e-10;
- minibatches of whole envs with their rollout-start hidden states, and
  the population-std advantage normalisation;
- the exploration noise: the port draws it for each env; the JAX rollout
  hands all N envs one key, so they act alike on one observation;
- ``play`` on a stub env: the 3 x 3 count, success and improve matrices and
  steps-to-success equal to the JAX trainer's ``play`` on the same stub;
- the lane-env branch (``vec_step_autoreset``) against ``VecEnv`` over
  single instances, bit-equal; ``train`` + checkpoint + ``resume``
  bit-equal to an uninterrupted run on both branches; the learning-rate
  schedule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import struct as fstruct

from tactilesimulation_tpu.algorithms import ppo as jax_ppo
from tactilesimulation_tpu.algorithms.ppo_rnn import PPORNN as JaxPPORNN
from tactilesimulation_tpu.models import nets as jax_nets
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.algorithms import ppo, ppo_rnn
from tactilesimulation_tpu_torch.models import nets
from tactilesimulation_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

F64 = torch.float64
CNN_FEATURES = {"kernel_sizes": [5, 3], "layer_sizes": [4, 3],
                "stride_sizes": [1, 1], "hidden_size": 8,
                "activation": "elu"}
HEADS = {"actor_mlp": {"layer_sizes": [8, 8], "activation": "elu"},
         "critic_mlp": {"layer_sizes": [8, 8], "activation": "elu"},
         "actor_logstd_init": -0.5}
NETS = {
    "cnn": ({"feature_cnn": CNN_FEATURES, "rnn_hidden_size": 6,
             "rnn_hidden_layers": 3, **HEADS}, (4, 13, 10)),
    "mlp": ({"feature_mlp": {"layer_sizes": [8], "activation": "elu"},
             "rnn_hidden_size": 6, "rnn_hidden_layers": 2, **HEADS}, (4,)),
}
STUB_NET = {"feature_mlp": {"layer_sizes": [8], "activation": "elu"},
            "rnn_hidden_size": 8, "rnn_hidden_layers": 2, **HEADS}
# stub dynamics: (start pose, factor per step, max_episode_steps); "align"
# succeeds on its first step, "drift" never does and is cut by the limit
STUBS = {"align": ((-0.004, 0.004, 0.1), 0.5, 6),
         "drift": ((-0.04, 0.04, 0.1), 0.7, 4)}


def _randomised(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.randn(*np.shape(a))), params)


def _pair(case, seed=0):
    """(flax ActorCriticRNN, its randomised params, the port's module with
    them)."""
    cfg, shape = NETS[case]
    ac_j = jax_nets.ActorCriticRNN(3, cfg)
    H = cfg["rnn_hidden_size"] * cfg["rnn_hidden_layers"]
    params = _randomised(ac_j.init(jax.random.PRNGKey(seed),
                                   jnp.zeros(shape), jnp.zeros(H),
                                   jnp.ones(())), seed)
    ac_t = nets.ActorCriticRNN(shape, 3, cfg).double()
    ac_t.load_state_dict(convert.actor_critic_rnn_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    return ac_j, params, ac_t


def test_gru_cell_matches_flax():
    cell_j = fnn.GRUCell(5)
    rng = np.random.RandomState(1)
    x, h = rng.randn(3, 4), rng.randn(3, 5)
    params = _randomised(cell_j.init(jax.random.PRNGKey(0), jnp.zeros((3, 5)),
                                     jnp.zeros((3, 4))), 1)
    want, _ = cell_j.apply(params, jnp.asarray(h), jnp.asarray(x))
    cell_t = nets.GRUCell(4, 5).double()
    p = jax.tree.map(np.asarray, params["params"])
    state = {}
    for name in ("ir", "iz", "in", "hr", "hz", "hn"):
        dst = "in_" if name == "in" else name
        state[f"{dst}.weight"] = torch.tensor(p[name]["kernel"].T)
        if "bias" in p[name]:
            state[f"{dst}.bias"] = torch.tensor(p[name]["bias"])
    cell_t.load_state_dict(state)           # strict: flax's parameter set
    assert cell_t.hr.bias is None and cell_t.hz.bias is None
    assert cell_t.hn.bias is not None
    got = cell_t(torch.tensor(h), torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", sorted(NETS))
def test_actor_critic_rnn_matches_flax(case):
    ac_j, params, ac_t = _pair(case)
    cfg, shape = NETS[case]
    N, H = 3, ac_t.hidden_size
    rng = np.random.RandomState(4)
    obs, hxs = rng.randn(N, *shape), rng.randn(N, H)
    masks = np.array([1.0, 0.0, 1.0])
    acts = rng.randn(N, 3)
    to_t = lambda *xs: [torch.tensor(x) for x in xs]

    ev_j = jax.vmap(lambda o, h, m, a: ac_j.apply(
        params, o, h, m, a, method=ac_j.evaluate_actions))(
            *map(jnp.asarray, (obs, hxs, masks, acts)))
    mode_j = jax.vmap(lambda o, h, m: ac_j.apply(
        params, o, h, m, None, True, method=ac_j.act))(
            *map(jnp.asarray, (obs, hxs, masks)))
    with torch.no_grad():
        ev_t = ac_t.evaluate_actions(*to_t(obs, hxs, masks, acts))
        mode_t = ac_t.act(*to_t(obs, hxs, masks), deterministic=True)
        value_t = ac_t.get_value(*to_t(obs, hxs, masks))
    for got, want in zip(list(ev_t) + list(mode_t) + [value_t],
                         list(ev_j) + list(mode_j) + [ev_j[0]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    # a mask of 0 resets the hidden state: env 1 acts as from zeros (to
    # round-off: a batch of 1 and of 3 take other matrix-product paths)
    with torch.no_grad():
        zero = ac_t.act(*to_t(obs[1:2], np.zeros((1, H)), np.ones(1)),
                        deterministic=True)
    torch.testing.assert_close(zero[3][0], mode_t[3][1], rtol=0, atol=1e-14)
    assert nets.ActorCriticMLPRNN is nets.ActorCriticRNN


# ---------------------------------------------------------------------------
# stub envs, JAX and port, with the same dynamics
# ---------------------------------------------------------------------------

@fstruct.dataclass
class _JState:
    pose: jax.Array
    t: jax.Array


class _JaxStub:
    """The pose shrinks by ``factor`` a step whatever the action; success
    inside the centre cell."""
    ndof_u = 2

    def __init__(self, kind):
        self.start, self.factor, self.max_episode_steps = STUBS[kind]

    def obs_size(self):
        return (4,)

    def _obs(self, pose, t):
        return jnp.concatenate([pose * 100.0, 0.1 * t[None]])

    def reset(self, key):
        pose = jnp.asarray(self.start)
        t = jnp.zeros((), jnp.int32)
        return _JState(pose=pose, t=t), self._obs(pose, t.astype(pose.dtype))

    def step(self, state, action):
        pose = state.pose * self.factor
        t = state.t + 1
        success = (jnp.abs(pose[0]) < 0.00225) & (jnp.abs(pose[1]) < 0.00225)
        reward = -jnp.sum(pose[:2] ** 2) * 1e4 + 0.1 * t.astype(pose.dtype)
        info = {"success": success, "improve": jnp.ones((), bool),
                "prev_object_pose": state.pose}
        return (_JState(pose=pose, t=t), self._obs(pose, t.astype(pose.dtype)),
                reward, success, info)


@dataclasses.dataclass(frozen=True)
class _State:
    pose: torch.Tensor
    t: torch.Tensor


class _Stub:
    """The port's twin of ``_JaxStub`` (a functional env on the CPU)."""
    ndof_u = 2

    def __init__(self, kind):
        self.start, self.factor, self.max_episode_steps = STUBS[kind]
        self.device, self.dtype = torch.device("cpu"), F64
        self.generator = torch.Generator()

    def obs_size(self):
        return (4,)

    def _obs(self, pose, t):
        return torch.cat([pose * 100.0, 0.1 * t[None].to(pose.dtype)])

    def reset(self):
        pose = torch.tensor(self.start, dtype=F64)
        t = torch.zeros((), dtype=torch.int32)
        return _State(pose=pose, t=t), self._obs(pose, t)

    def step(self, state, action, noise=None):
        pose = state.pose * self.factor
        t = state.t + 1
        success = (torch.abs(pose[0]) < 0.00225) & (torch.abs(pose[1])
                                                     < 0.00225)
        reward = -torch.sum(pose[:2] ** 2) * 1e4 + 0.1 * t.to(F64)
        info = {"success": success, "improve": torch.ones((), dtype=bool),
                "prev_object_pose": state.pose}
        return _State(pose=pose, t=t), self._obs(pose, t), reward, success, \
            info


class _LaneStub:
    """A vec env with the lane env's contract over ``_Stub``: every lane
    steps and every lane's reset is computed, the ended lanes take it."""

    def __init__(self, kind):
        self.env = _Stub(kind)
        self.device, self.dtype = self.env.device, self.env.dtype
        self.ndof_u = self.env.ndof_u
        self.generator = self.env.generator

    @property
    def max_episode_steps(self):
        return self.env.max_episode_steps

    def obs_size(self):
        return self.env.obs_size()

    def vec_reset(self, B):
        states, obs = zip(*(self.env.reset() for _ in range(B)))
        return torch.stack([s.pose for s in states], dim=-1), torch.stack(obs)

    def vec_step_autoreset(self, st, obs, t, action):
        B = st.shape[-1]
        outs = [self.env.step(_State(pose=st[:, i], t=t[i]), action[i])
                for i in range(B)]
        pose = torch.stack([o[0].pose for o in outs], dim=-1)
        nobs = torch.stack([o[1] for o in outs])
        reward = torch.stack([o[2] for o in outs])
        success = torch.stack([o[3] for o in outs])
        rstate, robs = self.vec_reset(B)
        t = t + 1
        truncated = t >= self.max_episode_steps
        done = success | truncated
        t = torch.where(done, torch.zeros_like(t), t)
        # the stub's obs carry t: rebuild the stepped side's from it
        return (torch.where(done, rstate, pose),
                torch.where(done[:, None], robs, nobs), t, reward, done,
                truncated & ~success, success)


STUB_CFG = {"config": {"num_processes": 4, "num_steps": 6,
                       "num_env_steps": 48, "num_mini_batch": 2,
                       "ppo_epoch": 2, "use_linear_lr_decay": False},
            "network": STUB_NET}


def _algo(kind="drift", lanes=False, cfg=STUB_CFG, seed=0, logdir=None):
    env = _LaneStub(kind) if lanes else _Stub(kind)
    return ppo_rnn.PPORNN(env, cfg, logdir=logdir, seed=seed)


def _jax_algo(kind, algo_t):
    """The JAX trainer on the JAX stub with the port's parameters."""
    algo = JaxPPORNN(_JaxStub(kind), STUB_CFG, seed=0)
    params = jax.tree.map(np.asarray, algo.params)
    sd = {k: v.numpy() for k, v in algo_t.ac.state_dict().items()}
    for name, value in sd.items():
        _set_from_port(params["params"], name, value)
    got = convert.actor_critic_rnn_params_from_numpy(params)
    assert sorted(got) == sorted(sd)
    for name in sd:
        assert np.array_equal(got[name].numpy(), sd[name]), name
    algo.params = jax.tree.map(jnp.asarray, params)
    return algo


def _set_from_port(p, name, value):
    """Write the port's parameter ``name`` into the flax tree ``p``."""
    parts = name.split(".")
    if parts[0] == "cells":
        leaf = p[f"gru{parts[1]}"]["in" if parts[2] == "in_" else parts[2]]
        leaf["kernel" if parts[3] == "weight" else "bias"] = (
            value.T if parts[3] == "weight" else value)
        return
    if parts[0] == "feature_net":
        node = p["feature_net"]
        if parts[1] == "layers":
            node = node[f"Dense_{parts[2]}"]
        elif parts[1] == "convs":
            node = node[f"Conv_{parts[2]}"]
            node["kernel" if parts[3] == "weight" else "bias"] = (
                value.transpose(2, 3, 1, 0) if parts[3] == "weight"
                else value)
            return
        else:
            node = node["Dense_0"]
    else:
        top = p[parts[0]]
        if parts[1] == "logstd":
            top["logstd"] = value
            return
        if parts[1] == "mlp":
            node = top["MLP_0"][f"Dense_{parts[3]}"]
        else:                                   # mean / value
            node = top["Dense_0"]
    node["kernel" if parts[-1] == "weight" else "bias"] = (
        value.T if parts[-1] == "weight" else value)


def _closures(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def test_compute_gae_matches_jax():
    algo_t = _algo()
    cl = _closures(_jax_algo("drift", algo_t)._update.__wrapped__)
    rng = np.random.RandomState(5)
    T, N = 7, 4
    values, rewards, last = rng.randn(T, N), rng.randn(T, N), rng.randn(N)
    dones = rng.rand(T, N) < 0.3
    bads = dones & (rng.rand(T, N) < 0.5)
    ret_j, adv_j = cl["compute_gae"](*map(jnp.asarray, (values, rewards,
                                                         dones, bads, last)))
    ret_t, adv_t = ppo.compute_gae(*map(torch.tensor, (values, rewards, dones,
                                                        bads, last)),
                                   algo_t.gamma, algo_t.gae_lambda)
    for got, want in ((ret_t, ret_j), (adv_t, adv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("kind", sorted(STUBS))
def test_rollout_bookkeeping_matches_jax(kind):
    algo_t = _algo(kind)
    algo_j = _jax_algo(kind, algo_t)
    cl = _closures(algo_j._update.__wrapped__)
    N, H = algo_t.num_processes, algo_t.hidden_size
    rng = np.random.RandomState(6)
    hxs, masks = rng.randn(N, H), np.array([1.0, 0.0, 1.0, 0.0])
    states, obs = algo_j._vec_reset(jax.random.PRNGKey(0))
    vec_j = jax_ppo.VecEnvState(env_states=states, obs=obs,
                                t=jnp.zeros(N, jnp.int32),
                                key=jax.random.PRNGKey(1))
    norm_j = algo_j.norm
    out_j = jax.jit(cl["rollout"])(algo_j.params, vec_j, jnp.asarray(hxs),
                                   jnp.asarray(masks), norm_j)
    vec_t, hxs_t, masks_t, norm_t, outs_t = algo_t.rollout(
        algo_t.vec_reset(), torch.tensor(hxs), torch.tensor(masks),
        algo_t.norm)
    _, hxs_j, masks_j, norm_j, outs_j = out_j
    # nobs, masks, value, r_train, done, bad, reward, success (the
    # actions and log-probs take each side's own noise; the stub ignores
    # the action)
    for k in (0, 1, 4, 5, 6, 7, 8, 9):
        np.testing.assert_allclose(outs_t[k].double().numpy(),
                                   np.asarray(outs_j[k], np.float64),
                                   rtol=1e-12, atol=1e-12, err_msg=str(k))
    if kind == "drift":
        assert outs_t[7].any(), "no episode was cut by the time limit"
    else:
        assert outs_t[9].any() and not outs_t[7].any()
    for got, want in ((hxs_t, hxs_j), (masks_t, masks_j),
                      (norm_t.returns, norm_j.returns),
                      (norm_t.obs_rms.mean, norm_j.obs_rms.mean),
                      (norm_t.obs_rms.var, norm_j.obs_rms.var),
                      (norm_t.ret_rms.var, norm_j.ret_rms.var),
                      (norm_t.ret_rms.count, norm_j.ret_rms.count)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


def _stored_rollout(T, E, H, shape, seed=7):
    rng = np.random.RandomState(seed)
    masks = (rng.rand(T, E) > 0.3).astype(np.float64)
    return (rng.randn(T, E, *shape), masks, rng.randn(T, E, 3),
            rng.randn(T, E) - 2.0, rng.randn(T, E), rng.randn(T, E),
            rng.randn(T, E), rng.randn(E, H))


@pytest.mark.parametrize("case", sorted(NETS))
def test_minibatch_loss_and_gradient_match_jax(case):
    """The replayed sequence loss and its gradient against the JAX
    trainer's ``mb_loss`` (``sequence_loss`` vmapped over the envs)."""
    ac_j, params, ac_t = _pair(case, seed=2)
    cfg, shape = NETS[case]
    coefs = {"clip_param": 0.2, "value_loss_coef": 0.5, "entropy_coef": 0.01}
    algo_j = JaxPPORNN(_JaxStub("drift"),
                       {**STUB_CFG, "config": {**STUB_CFG["config"],
                                               **coefs}}, seed=0)
    algo_j.ac = ac_j                        # the trainer's closures take it
    algo_j._build()
    mb_loss = _closures(algo_j._update.__wrapped__)["mb_loss"]
    T, E = 5, 2
    batch = _stored_rollout(T, E, ac_t.hidden_size, shape)
    (loss_j, aux_j), g_j = jax.value_and_grad(mb_loss, has_aux=True)(
        params, tuple(map(jnp.asarray, batch)))
    loss_t, aux_t = ppo_rnn.minibatch_loss(
        ac_t, tuple(map(torch.tensor, batch)), *coefs.values())
    for got, want in zip((loss_t,) + tuple(aux_t), (loss_j,) + tuple(aux_j)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-10)
    assert abs(float(aux_t[2].detach())) > 0
    grads = torch.autograd.grad(loss_t, list(ac_t.parameters()))
    want = convert.actor_critic_rnn_params_from_numpy(
        jax.tree.map(np.asarray, g_j))
    names = [n for n, _ in ac_t.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_minibatches_are_whole_envs(monkeypatch):
    algo = _algo()
    N, T = algo.num_processes, algo.num_steps
    vec = algo.vec_reset()
    h0 = torch.randn(N, algo.hidden_size, dtype=F64,
                     generator=torch.Generator().manual_seed(0))
    m0 = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=F64)
    vec, hxs, masks, norm, outs = algo.rollout(vec, h0, m0, algo.norm)
    with torch.no_grad():
        last = algo.ac.get_value(algo._norm_obs(norm.obs_rms, vec.obs), hxs,
                                 masks)[:, 0]
    returns, advs = ppo.compute_gae(outs[4], outs[5], outs[6], outs[7], last,
                                    algo.gamma, algo.gae_lambda)
    advs_n = (advs - advs.mean()) / (advs.std(unbiased=False) + 1e-5)
    seen = []
    real = ppo_rnn.minibatch_loss

    def spy(ac, batch, *a):
        seen.append(batch)
        return real(ac, batch, *a)
    monkeypatch.setattr(ppo_rnn, "minibatch_loss", spy)
    gen_state = algo.perm_generator.get_state()
    algo.update(vec, hxs, masks, norm, h0, m0, outs)
    algo.perm_generator.set_state(gen_state)
    E = N // algo.num_mini_batch
    assert len(seen) == algo.ppo_epoch * algo.num_mini_batch
    for epoch in range(algo.ppo_epoch):
        perm = torch.randperm(N, generator=algo.perm_generator)
        # JAX: idxs = perm.reshape(num_mini_batch, envs_per_mb)
        for j, idx in enumerate(perm.reshape(algo.num_mini_batch, E)):
            batch = seen[epoch * algo.num_mini_batch + j]
            assert batch[0].shape == (T, E, 4)
            torch.testing.assert_close(batch[7], h0[idx], rtol=0, atol=0)
            torch.testing.assert_close(batch[1][0], m0[idx], rtol=0, atol=0)
            torch.testing.assert_close(batch[1][1:], outs[1][1:, idx],
                                       rtol=0, atol=0)
            torch.testing.assert_close(batch[6], advs_n[:, idx], rtol=0,
                                       atol=0)
            torch.testing.assert_close(batch[5], returns[:, idx], rtol=0,
                                       atol=0)
    with pytest.raises(ValueError, match="whole envs"):
        cfg = {**STUB_CFG, "config": {**STUB_CFG["config"],
                                      "num_mini_batch": 3}}
        _algo(cfg=cfg)


def test_exploration_noise_is_independent_across_envs():
    """N envs on one observation and hidden state: the port's actions
    differ (a noise vector per env); the JAX rollout's
    ``vmap(act, in_axes=(0, 0, 0, None))`` gives all N the same."""
    ac_j, params, ac_t = _pair("mlp")
    N, H = 4, ac_t.hidden_size
    obs = np.repeat(np.random.RandomState(2).randn(1, 4), N, axis=0)
    hxs, masks = np.zeros((N, H)), np.ones(N)
    _, acts_j, _, _ = jax.vmap(
        lambda o, h, m, k: ac_j.apply(params, o, h, m, k, method=ac_j.act),
        in_axes=(0, 0, 0, None))(jnp.asarray(obs), jnp.asarray(hxs),
                                 jnp.asarray(masks), jax.random.PRNGKey(0))
    acts_j = np.asarray(acts_j)
    assert np.all(acts_j == acts_j[0]), "JAX's envs share one noise vector"
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        _, acts_t, logp, _ = ac_t.act(*map(torch.tensor, (obs, hxs, masks)),
                                      gen)
        mean = ac_t.act(*map(torch.tensor, (obs, hxs, masks)),
                        deterministic=True)[1]
    noise = torch.randn((N, 3), generator=torch.Generator().manual_seed(3),
                        dtype=F64)
    torch.testing.assert_close(acts_t, mean + torch.exp(
        ac_t.actor.logstd) * noise, rtol=1e-14, atol=1e-14)
    assert len({tuple(a) for a in acts_t.numpy().round(12)}) == N
    assert logp.shape == (N, 1)


def test_play_matrices_match_jax(tmp_path):
    algo_t = _algo("align")
    plot = tmp_path / "eval.png"
    out_t = algo_t.play(num_games=3, plot_path=str(plot))
    out_j = _jax_algo("align", algo_t).play(num_games=3)
    for k in ("class_cnt", "class_success_cnt", "class_improve_cnt"):
        assert np.array_equal(out_t[k], out_j[k]), k
    for k in ("success_rate", "improve_rate", "steps_to_success_mean",
              "steps_to_success_median", "steps_to_success"):
        assert out_t[k] == out_j[k], k
    # every episode starts at (-4, 4) mm: class [0, 2], success at step 1
    assert out_t["class_cnt"][0][2] == 3
    assert out_t["class_success_cnt"][0][2] == 3
    assert out_t["success_rate"] == 1.0 and plot.exists()
    total, success, improve, length, extra = algo_t.play_once(seed=5)
    assert success and length == 1 and extra["first_success_step"] == 1
    assert np.isclose(extra["angles"][0], np.rad2deg(0.1))


def test_lane_branch_matches_vec_env():
    """The same run through ``vec_step_autoreset`` (one call for the batch)
    and through ``VecEnv``'s single instances: the same numbers."""
    runs = []
    for lanes in (False, True):
        algo = _algo("drift", lanes=lanes)
        assert algo.fused_vec == lanes
        sr = algo.train(stop_update=1)
        runs.append((algo, sr))
    (a, sr_a), (b, sr_b) = runs
    assert sr_a == sr_b
    for x, y in zip(a.ac.state_dict().values(), b.ac.state_dict().values()):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    for x, y in zip(tree_leaves(a.norm), tree_leaves(b.norm)):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    torch.testing.assert_close(b.last_update["raw_rewards"],
                               a.last_update["raw_rewards"], rtol=0, atol=0)


@pytest.mark.parametrize("lanes", [False, True])
def test_train_checkpoint_resume_is_exact(tmp_path, lanes):
    straight = _algo(lanes=lanes, logdir=str(tmp_path / "a"))
    straight.train()
    first = _algo(lanes=lanes, logdir=str(tmp_path / "b"))
    first.train(stop_update=1)
    resumed = _algo(lanes=lanes, logdir=str(tmp_path / "c"), seed=123)
    resumed.resume(str(tmp_path / "b" / "checkpoint.pt"))
    assert resumed._resume_blob["update"] == 1
    resumed.train()
    moved = False
    for (name, a), c in zip(straight.ac.state_dict().items(),
                            first.ac.state_dict().values()):
        torch.testing.assert_close(resumed.ac.state_dict()[name], a, rtol=0,
                                   atol=0)
        moved |= not torch.equal(a, c)
    assert moved, "the second update left the parameters where they were"
    oa, ob = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert oa["count"] == ob["count"] == 2 * 2 * 2
    for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"]):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    ta, tb = straight._train_state, resumed._train_state
    for x, y in zip(ta["carry"] + ta["norm"], tb["carry"] + tb["norm"]):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    for k in ("env", "act", "perm"):
        assert torch.equal(ta["generators"][k], tb["generators"][k]), k
    for k in ("episode_rewards", "successes"):
        assert torch.allclose(ta[k], tb[k], rtol=0, atol=0, equal_nan=True), k
    assert (tmp_path / "c" / "models" / "final_policy.pt").exists()
    fresh = _algo(lanes=lanes, seed=7)
    fresh.load(str(tmp_path / "a" / "models" / "final_policy.pt"))
    for name, a in straight.ac.state_dict().items():
        assert torch.equal(fresh.ac.state_dict()[name], a), name


def test_learning_rate_schedule():
    """``use_linear_lr_decay`` (the protocol's yaml sets it) decays to 0
    over num_updates x ppo_epoch x num_mini_batch optimizer steps; without
    it the rate is constant, as the JAX trainer's always is."""
    cfg = {**STUB_CFG, "config": {**STUB_CFG["config"],
                                  "use_linear_lr_decay": True}}
    algo = _algo(cfg=cfg)
    total = algo.num_updates * algo.ppo_epoch * algo.num_mini_batch
    assert total == 2 * 2 * 2
    assert algo.optimizer.lr(0) == pytest.approx(3e-4)
    assert algo.optimizer.lr(total // 2) == pytest.approx(1.5e-4)
    assert algo.optimizer.lr(total) == 0.0
    const = _algo()
    assert const.optimizer.lr(0) == const.optimizer.lr(total) == 3e-4
