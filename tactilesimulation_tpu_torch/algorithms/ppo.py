"""PPO: the model-free trainer over a vector of single-instance envs.

Port of ``tactilesimulation_tpu/algorithms/ppo.py`` (reference
algorithms/ppo.py + pytorch-a2c-ppo-acktr-gail):

- clipped surrogate + clipped value loss + entropy, minibatched epochs,
  global-norm gradient clipping, Adam (eps 1e-5) with linear lr decay over
  ``num_updates * ppo_epoch * num_mini_batch`` optimizer steps;
- GAE with proper time limits: an episode cut by the time limit bootstraps
  from the value function (bad mask ``truncated & ~done``);
- observation and return running normalisation with clipping
  (VecNormalize): each step normalises with the statistics from before
  its own update, and the return accumulator is zeroed on ``done`` after
  the return statistics take it;
- auto-reset vector env (SubprocVecEnv semantics), or the env's own
  batched ``vec_reset``/``vec_step_autoreset`` where it has them;
- interval checkpoints with the full training state, ``resume``,
  ``save``/``load`` and ``play_once``.

Deviations from the JAX package:
- ``VecEnv`` steps its N instances one after another (the reference's
  SubprocVecEnv steps them in N processes; JAX vmaps them); its states,
  observations, rewards and masks are batch-first tensors;
- exploration noise is drawn independently for each env; the JAX rollout
  hands all N envs one key (``ppo.py:177-179``), so they share one noise
  vector at each step;
- draws come from three ``torch.Generator``s, the env's (resets and
  disturbances), the policy's and the minibatch permutation's, all seeded
  from ``seed`` and all in the checkpoint; a reset is drawn only for the
  envs that end;
- no TensorBoard writer (``logs.txt`` and the console).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models import nets
from ..utils import checkpoint
from ..utils import logging as log
from ..utils.running_mean_std import RunningMeanStd
from ..utils.tree import (stack_rows, tree_index, tree_leaves, tree_map,
                          tree_stack, tree_unflatten)
from .gd import Adam, _grads, linear_schedule


@dataclasses.dataclass(frozen=True)
class VecEnvState:
    env_states: Any          # EnvState with (N, ...) leaves
    obs: Any                 # (N, obs...) tree
    t: torch.Tensor          # (N,) per-env step counts, on the host


@dataclasses.dataclass(frozen=True)
class NormState:
    obs_rms: Any             # tree of RunningMeanStd matching the obs tree
    ret_rms: RunningMeanStd
    returns: torch.Tensor    # (N,) discounted return accumulator


def _obs_map(fn, tree, *rest):
    """``fn`` over an observation tree (a tensor or a tuple of them) or a
    tree of the same shape (its RunningMeanStd filters)."""
    if isinstance(tree, tuple):
        return tuple(_obs_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def rms_tree_create(dummy_obs, dtype, device=None):
    """One RunningMeanStd per obs leaf, so tuple observations such as
    TactilePush ``tactile_map``'s (image, state) pair normalise leaf by
    leaf."""
    return _obs_map(lambda o: RunningMeanStd.create(
        tuple(o.shape), dtype, o.device if device is None else device),
        dummy_obs)


def rms_tree_update(rms_tree, batch):
    return _obs_map(lambda r, b: r.update(b), rms_tree, batch)


def rms_tree_normalize(rms_tree, obs, clip):
    return _obs_map(lambda r, o: torch.clamp(r.normalize(o), -clip, clip),
                    rms_tree, obs)


def compute_gae(values, rewards, dones, bads, last_value, gamma, gae_lambda):
    """(T, N) tensors -> (returns, advantages); an episode cut by the time
    limit (``bads``) bootstraps from the next value as if it went on."""
    masks = 1.0 - dones.to(values.dtype)          # mask AFTER step t
    bad = bads.to(values.dtype)
    v_nexts = torch.cat([values[1:], last_value[None]])
    gae = torch.zeros_like(last_value)
    advs = []
    for t in reversed(range(values.shape[0])):
        keep = masks[t] + bad[t] * (1 - masks[t])
        delta = rewards[t] + gamma * v_nexts[t] * keep - values[t]
        gae = delta + gamma * gae_lambda * keep * gae
        advs.append(gae)
    advs = torch.stack(advs[::-1])
    return advs + values, advs


def ppo_loss(ac, obs, actions, old_logp, old_values, returns, advs,
             clip_param, value_loss_coef, entropy_coef):
    """(loss, (action loss, value loss, entropy)) of one minibatch."""
    value, logp, entropy = ac.evaluate_actions(obs, actions)
    value, logp = value[:, 0], logp[:, 0]
    ratio = torch.exp(logp - old_logp)
    surr1 = ratio * advs
    surr2 = torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * advs
    action_loss = -torch.minimum(surr1, surr2).mean()
    v_clipped = old_values + torch.clamp(value - old_values, -clip_param,
                                         clip_param)
    v_loss = 0.5 * torch.maximum((value - returns) ** 2,
                                 (v_clipped - returns) ** 2).mean()
    loss = action_loss + value_loss_coef * v_loss - entropy_coef * entropy
    return loss, (action_loss, v_loss, entropy)


class VecEnv:
    """N instances of a ``FunctionalEnv`` stepped one after another, with
    SubprocVecEnv auto-reset: an env that is done or reaches
    ``max_episode_steps`` is reset, and its step returns the new episode's
    first observation."""

    def __init__(self, env, num_envs: int):
        self.env = env
        self.num_envs = num_envs

    def reset(self) -> VecEnvState:
        states, obs = zip(*(self.env.reset() for _ in range(self.num_envs)))
        return VecEnvState(env_states=tree_stack(states),
                           obs=tree_stack(obs),
                           t=torch.zeros(self.num_envs, dtype=torch.int64))

    def step(self, vec: VecEnvState, actions):
        """-> (vec', reward (N,), done (N,), bad (N,)): ``done`` marks an
        episode's end (done or truncated), ``bad`` one cut by the time
        limit alone."""
        return self.step_success(vec, actions)[:4]

    def step_success(self, vec: VecEnvState, actions):
        """``step``'s outputs and success (N,): each step's
        ``info["success"]`` (False where the env reports none)."""
        env = self.env
        outs = [env.step(tree_index(vec.env_states, i), actions[i])
                for i in range(self.num_envs)]
        states, obs, rewards, dones, infos = (list(x) for x in zip(*outs))
        success = torch.stack([torch.as_tensor(i.get("success", False),
                                               device=rewards[0].device)
                               for i in infos])
        t = vec.t + 1
        done = torch.stack(dones).cpu()
        truncated = t >= env.max_episode_steps
        ended = done | truncated
        for i in torch.nonzero(ended).flatten().tolist():
            states[i], obs[i] = env.reset()
        t = torch.where(ended, torch.zeros_like(t), t)
        dev = rewards[0].device
        return (VecEnvState(env_states=tree_stack(states),
                            obs=tree_stack(obs), t=t),
                torch.stack(rewards), ended.to(dev),
                (truncated & ~done).to(dev), success)


class PPO:
    """PPO over a vector env. ``PPORNN`` (``ppo_rnn.py``) is this trainer
    with a recurrent policy: it overrides the net, the rollout, the update
    and ``play_once``, and the figures that select the best model; the
    config, the generators, the optimizer, the normalisers, the train loop,
    the checkpoints and ``resume`` are these."""

    # the config defaults that differ between the trainers
    DEFAULTS = {"num_steps": 1024, "num_env_steps": 2_000_000,
                "num_mini_batch": 32}
    # an interval model's name tag, from the score; episodes the score
    # needs before it selects the best model
    SCORE_TAG = "reward{:.1f}"
    MIN_EPISODES = 1

    def __init__(self, env, cfg: Dict[str, Any], logdir: Optional[str] = None,
                 seed: int = 0):
        """env: a ``FunctionalEnv``, or a vec env with ``vec_reset`` and
        ``vec_step_autoreset`` (``.env`` its single instance); cfg: the
        YAML ``params`` dict (``config``, ``network`` and optionally
        ``general`` sections)."""
        self.env = env
        self.cfg = cfg
        config = {**self.DEFAULTS, **cfg.get("config", {})}
        network = cfg.get("network", {})
        self.logdir = logdir
        self.seed = seed
        self.device, self.dtype = env.device, env.dtype

        self.num_processes = config.get("num_processes", 8)
        self.num_steps = config["num_steps"]
        self.num_env_steps = config["num_env_steps"]
        self.lr = config.get("lr", 3e-4)
        self.clip_param = config.get("clip_param", 0.2)
        self.ppo_epoch = config.get("ppo_epoch", 10)
        self.num_mini_batch = config["num_mini_batch"]
        self.value_loss_coef = config.get("value_loss_coef", 0.5)
        self.entropy_coef = config.get("entropy_coef", 0.0)
        self.max_grad_norm = config.get("max_grad_norm", 0.5)
        self.gamma = config.get("gamma", 0.99)
        self.gae_lambda = config.get("gae_lambda", 0.95)
        self.use_linear_lr_decay = config.get("use_linear_lr_decay", True)
        self.norm_obs = config.get("norm_obs", True)
        self.norm_reward = config.get("norm_reward", True)
        self.clip_obs = config.get("clip_obs", 10.0)
        self.clip_reward = config.get("clip_reward", 10.0)
        # each interval also writes a full-state checkpoint, so a crashed
        # run resumes exactly
        self.save_interval = cfg.get("general", {}).get(
            "save_interval", config.get("save_interval", 50))

        self.num_updates = self.num_env_steps // (
            self.num_steps * self.num_processes)
        self._resume_blob = None
        # the env's own batched step where it has one (the JAX package's
        # ``fused_vec`` branch), else its single instances one by one
        self.fused_vec = hasattr(env, "vec_step_autoreset")
        self.vec_env = None if self.fused_vec else VecEnv(env,
                                                          self.num_processes)

        dummy_obs = self._dummy_obs()
        obs_shape = _obs_map(lambda o: tuple(o.shape), dummy_obs)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.ac = self._make_net(obs_shape, network)
        self.ac.to(self.device, self.dtype)
        s_env, s_act, s_perm = (int(s) for s in np.random.SeedSequence(
            seed).generate_state(3))
        env.generator.manual_seed(s_env)
        self.act_generator = torch.Generator(device=self.device)
        self.act_generator.manual_seed(s_act)
        self.perm_generator = torch.Generator(device=self.device)
        self.perm_generator.manual_seed(s_perm)

        lr = (linear_schedule(self.lr, 0.0, self.num_updates * self.ppo_epoch
                              * self.num_mini_batch)
              if self.use_linear_lr_decay else self.lr)
        self.optimizer = Adam(self.ac.parameters(), lr, eps=1e-5,
                              max_norm=self.max_grad_norm)
        self.norm = NormState(
            obs_rms=rms_tree_create(dummy_obs, self.dtype, self.device),
            ret_rms=RunningMeanStd.create((), self.dtype, self.device),
            returns=torch.zeros(self.num_processes, dtype=self.dtype,
                                device=self.device))
        self.last_update = {}
        self.rollout_split = {}

    def _dummy_obs(self):
        """The obs tree (a vector, or a tuple such as tactile_map's (image,
        state)) from one reset, with the env's generator put back."""
        saved = self.env.generator.get_state()
        with torch.no_grad():
            dummy_obs = self.env.reset()[1]
        self.env.generator.set_state(saved)
        return dummy_obs

    def _make_net(self, obs_shape, network):
        return nets.ActorCritic(obs_shape, self.env.ndof_u, network,
                                network.get("actor", "DiagGaussianActor"),
                                network.get("critic", "MLPCritic"))

    # -- the vector env ----------------------------------------------------
    def vec_reset(self) -> VecEnvState:
        if not self.fused_vec:
            return self.vec_env.reset()
        states, obs = self.env.vec_reset(self.num_processes)
        return VecEnvState(env_states=states, obs=obs,
                           t=torch.zeros(self.num_processes,
                                         dtype=torch.int64,
                                         device=self.device))

    def vec_step(self, vec: VecEnvState, action):
        """-> (vec', reward, done, bad, success), each (N,)."""
        if not self.fused_vec:
            return self.vec_env.step_success(vec, action)
        st, obs, t, reward, done, bad, success = self.env.vec_step_autoreset(
            vec.env_states, vec.obs, vec.t, action)
        return VecEnvState(env_states=st, obs=obs, t=t), reward, done, bad, \
            success

    def _norm_obs(self, rms, obs):
        if not self.norm_obs:
            return obs
        return rms_tree_normalize(rms, obs, self.clip_obs)

    def _norm_step(self, norm: NormState, obs, reward, done):
        """VecNormalize's bookkeeping of one vector step taken from ``obs``
        -> (norm', training reward): the return statistics take the
        discounted return, the reward is scaled by them and clipped, the
        return accumulator is zeroed on ``done`` after that, and the obs
        statistics take ``obs``."""
        returns = norm.returns * self.gamma + reward
        ret_rms = norm.ret_rms.update(returns)
        if self.norm_reward:
            r_train = torch.clamp(reward / torch.sqrt(ret_rms.var + 1e-8),
                                  -self.clip_reward, self.clip_reward)
        else:
            r_train = reward
        returns = torch.where(done, torch.zeros_like(returns), returns)
        return NormState(obs_rms=rms_tree_update(norm.obs_rms, obs),
                         ret_rms=ret_rms, returns=returns), r_train

    # -- rollout and update --------------------------------------------------
    @torch.no_grad()
    def rollout(self, vec: VecEnvState, norm: NormState):
        """``num_steps`` vector steps -> (vec, norm, (obs seen normalised,
        actions, log-probs, values, training rewards, dones, bads, raw
        rewards), each (T, N, ...)). ``rollout_split`` gets the host
        seconds of the obs normalisation, the policy's act and the env
        steps (the vector env's step ends with a sync)."""
        steps = []
        split = {"norm_s": 0.0, "act_s": 0.0, "env_s": 0.0}
        for _ in range(self.num_steps):
            t0 = time.perf_counter()
            nobs = self._norm_obs(norm.obs_rms, vec.obs)
            t1 = time.perf_counter()
            value, action, logp = self.ac.act(nobs, self.act_generator)
            t2 = time.perf_counter()
            next_vec, reward, done, bad, _ = self.vec_step(vec, action)
            t3 = time.perf_counter()
            split["norm_s"] += t1 - t0
            split["act_s"] += t2 - t1
            split["env_s"] += t3 - t2
            norm, r_train = self._norm_step(norm, vec.obs, reward, done)
            steps.append((nobs, action, logp[:, 0], value[:, 0], r_train,
                          done, bad, reward))
            vec = next_vec
        self.rollout_split = split
        return vec, norm, stack_rows(steps)

    def update(self, vec: VecEnvState, norm: NormState, outs):
        """GAE and ``ppo_epoch`` epochs of ``num_mini_batch`` minibatches
        on one rollout -> the mean (loss, action loss, value loss,
        entropy)."""
        obs, actions, logps, values, rewards, dones, bads, _ = outs
        T, N = values.shape
        with torch.no_grad():
            last_value = self.ac.get_value(
                self._norm_obs(norm.obs_rms, vec.obs))[:, 0]
            returns, advs = compute_gae(values, rewards, dones, bads,
                                        last_value, self.gamma,
                                        self.gae_lambda)
            advs_n = (advs - advs.mean()) / (advs.std(unbiased=False) + 1e-5)
        flat = tree_map(lambda x: x.reshape((T * N,) + x.shape[2:]),
                        (obs, actions, logps, values, returns, advs_n))
        B = T * N
        mb = B // self.num_mini_batch
        params = list(self.ac.parameters())
        metrics = []
        for _ in range(self.ppo_epoch):
            perm = torch.randperm(B, generator=self.perm_generator,
                                  device=self.device)
            for idx in perm[:self.num_mini_batch * mb].reshape(
                    self.num_mini_batch, mb):
                batch = tree_map(lambda x: x[idx], flat)
                loss, aux = ppo_loss(self.ac, *batch, self.clip_param,
                                     self.value_loss_coef, self.entropy_coef)
                self.optimizer.step(_grads(loss, params))
                metrics.append(torch.stack([loss.detach()]
                                           + [a.detach() for a in aux]))
        return torch.stack(metrics).mean(dim=0).cpu()

    def _begin(self):
        """The rollout's carry at the start of a run: the vector state."""
        return self.vec_reset()

    def update_iteration(self, vec: VecEnvState, norm: NormState):
        """One rollout and its update -> (vec, norm, metrics, raw rewards
        (T, N), dones (T, N), successes (None: PPO keeps none));
        ``last_update`` keeps the seconds of each part (the rollout's split
        too), the metrics, the raw rewards and the vector env's state."""
        t0 = time.perf_counter()
        vec, norm, outs = self.rollout(vec, norm)
        t1 = time.perf_counter()
        metrics = self.update(vec, norm, outs)
        self.last_update = {"rollout_s": t1 - t0,
                            "update_s": time.perf_counter() - t1,
                            **self.rollout_split, "metrics": metrics,
                            "raw_rewards": outs[7], "vec": vec}
        return vec, norm, metrics, outs[7], outs[5], None

    # -- the score that selects the best model -------------------------------
    def _score(self, episode_rewards, successes):
        """The figure that selects the best model and that ``train``
        returns: the mean episode reward."""
        return float(np.mean(episode_rewards))

    def _score_text(self, episode_rewards, successes):
        return (f"mean/median reward {float(np.mean(episode_rewards)):.1f}/"
                f"{float(np.median(episode_rewards)):.1f}")

    # ------------------------------------------------------------------
    def train(self, stop_update: Optional[int] = None):
        """Run updates [resumed update, num_updates); ``stop_update``
        stops early. A full-state checkpoint is written every
        ``save_interval`` updates and when the loop exits. Returns the
        score (``_score``) of the last (up to 100) episodes, 0 without
        one."""
        end_update = (self.num_updates if stop_update is None
                      else min(stop_update, self.num_updates))
        textlog = (log.TextLog(os.path.join(self.logdir, "logs.txt"),
                               append=self._resume_blob is not None)
                   if self.logdir else None)
        if self._resume_blob is not None:
            blob, self._resume_blob = self._resume_blob, None
            carry, update0 = blob["carry"], blob["update"]
            episode_rewards = deque(blob["episode_rewards"], maxlen=100)
            successes = deque(blob["successes"], maxlen=100)
            ep_acc, best = blob["ep_acc"], blob["best"]
            elapsed0 = blob["elapsed"]
        else:
            carry, update0 = self._begin(), 0
            episode_rewards = deque(maxlen=100)
            successes = deque(maxlen=100)
            ep_acc, best, elapsed0 = np.zeros(self.num_processes), -np.inf, 0.0
        norm = self.norm

        t_start = time.time()
        per_update = self.num_steps * self.num_processes
        for update in range(update0, end_update):
            carry, norm, metrics, raw_r, dones, succ = self.update_iteration(
                carry, norm)
            raw_r = raw_r.double().cpu().numpy()     # (T, N)
            dones_np = dones.cpu().numpy()
            succ_np = None if succ is None else succ.cpu().numpy()
            for t in range(raw_r.shape[0]):
                ep_acc += raw_r[t]
                for i in np.nonzero(dones_np[t])[0]:
                    episode_rewards.append(float(ep_acc[i]))
                    if succ_np is not None:
                        successes.append(float(succ_np[t, i]))
                    ep_acc[i] = 0.0
            total_steps = (update + 1) * per_update
            if len(episode_rewards) > 0:
                score = self._score(episode_rewards, successes)
                fps = int((total_steps - update0 * per_update)
                          / (time.time() - t_start))
                loss, aloss, vloss, ent = (float(m) for m in metrics)
                msg = (f"Updates {update}, num timesteps {total_steps}, "
                       f"FPS {fps} | "
                       f"{self._score_text(episode_rewards, successes)} "
                       f"| value_loss {vloss:.4f} action_loss {aloss:.4f} "
                       f"entropy {ent:.2f}")
                print(msg, flush=True)
                if textlog:
                    textlog.append(msg)
                if (self.logdir and score > best
                        and len(episode_rewards) >= self.MIN_EPISODES):
                    best = score
                    self.norm = norm
                    self.save()
            hit_interval = (update % self.save_interval == 0
                            or update == end_update - 1)
            if self.logdir and hit_interval:
                if len(episode_rewards) > 0:
                    self.norm = norm
                    self.save(f"model_iter{update}_"
                              + self.SCORE_TAG.format(score))
                self._stash(carry, norm, update + 1, episode_rewards,
                            successes, ep_acc, best,
                            elapsed0 + time.time() - t_start)
                self.save_checkpoint()
        self.norm = norm
        self._stash(carry, norm, end_update, episode_rewards, successes,
                    ep_acc, best, elapsed0 + time.time() - t_start)
        if self.logdir:
            self.save_checkpoint()
            if end_update >= self.num_updates:
                self.save("final_policy")
        return (self._score(episode_rewards, successes) if episode_rewards
                else 0.0)

    # -- full-state checkpoint / resume --------------------------------
    def _generators(self):
        return {"env": self.env.generator, "act": self.act_generator,
                "perm": self.perm_generator}

    def _stash(self, carry, norm, update, episode_rewards, successes, ep_acc,
               best, elapsed):
        def window(vals):
            w = np.full(100, np.nan)
            vals = list(vals)
            if vals:
                w[:len(vals)] = vals
            return torch.as_tensor(w)

        self._train_state = {
            "carry": [x.clone() for x in tree_leaves(carry)],
            "norm": [x.clone() for x in tree_leaves(norm)],
            "generators": {k: g.get_state()
                           for k, g in self._generators().items()},
            "update": int(update),
            "episode_rewards": window(episode_rewards),
            "successes": window(successes),
            "ep_acc": torch.as_tensor(np.array(ep_acc, np.float64)),
            "best": float(best), "elapsed": float(elapsed)}

    def save_checkpoint(self, name: str = "checkpoint"):
        checkpoint.save_state(
            os.path.join(self.logdir, f"{name}.pt"),
            {"params": self.ac.state_dict(),
             "opt_state": self.optimizer.state_dict(), **self._train_state})

    def resume(self, path):
        """Restore parameters, optimizer state, the rollout's carry (the
        vector env's states, mid-episode ones included), the normalisers,
        the update counter and every generator: a following ``train()``
        continues exactly where the checkpointed run stopped. The carry's
        layout, and each leaf's device, come from one ``_begin``, whose
        draws the restored generators then replace."""
        blob = checkpoint.restore_state(path, map_location="cpu")
        self.ac.load_state_dict(blob["params"])
        self.optimizer.load_state_dict(blob["opt_state"])
        self.norm = tree_unflatten(self.norm, [x.to(self.device)
                                               for x in blob["norm"]])
        like = self._begin()
        carry = tree_unflatten(like, [x.to(y.device) for x, y in zip(
            blob["carry"], tree_leaves(like))])
        for k, g in self._generators().items():
            g.set_state(blob["generators"][k])
        clean = lambda w: [float(x) for x in w.numpy()[~np.isnan(w.numpy())]]
        self._resume_blob = {
            "carry": carry, "update": int(blob["update"]),
            "episode_rewards": clean(blob["episode_rewards"]),
            "successes": clean(blob["successes"]),
            "ep_acc": blob["ep_acc"].numpy().copy(),
            "best": float(blob["best"]), "elapsed": float(blob["elapsed"])}

    # ------------------------------------------------------------------
    def save(self, filename=None):
        os.makedirs(os.path.join(self.logdir, "models"), exist_ok=True)
        path = os.path.join(self.logdir, "models",
                            f"{filename or 'best_model'}.pt")
        torch.save({"params": self.ac.state_dict(),
                    "obs_rms": tree_leaves(self.norm.obs_rms)}, path)

    def load(self, path):
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.ac.load_state_dict(blob["params"])
        if blob.get("obs_rms") is not None:
            self.norm = dataclasses.replace(self.norm, obs_rms=tree_unflatten(
                self.norm.obs_rms, blob["obs_rms"]))

    @torch.no_grad()
    def play_once(self, seed: Optional[int] = None, deterministic=True):
        """One episode with the policy (its mode unless ``deterministic`` is
        False), the env's draws seeded from ``seed`` (default seed + 1);
        the training generators are left as they were. Returns (total
        reward, steps, last info)."""
        seed = self.seed + 1 if seed is None else seed
        gen = self.env.generator
        saved = gen.get_state()
        gen.manual_seed(seed)
        act_gen = torch.Generator(device=self.device)
        act_gen.manual_seed(seed)
        try:
            state, obs = self.env.reset()
            total, t, done = 0.0, 0, False
            info = {}
            while not done and t < self.env.max_episode_steps:
                nobs = self._norm_obs(self.norm.obs_rms, obs)
                action = self.ac.act(nobs, act_gen, deterministic)[1]
                state, obs, reward, done, info = self.env.step(state, action)
                total += float(reward)
                t += 1
                done = bool(done)
        finally:
            gen.set_state(saved)
        return total, t, {k: v.cpu().numpy() for k, v in info.items()}
