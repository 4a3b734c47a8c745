"""Recurrent PPO: a features -> GRU actor-critic trained over a vector env.

Port of ``tactilesimulation_tpu/algorithms/ppo_rnn.py`` (reference
algorithms/ppo_rnn.py and the recurrent minibatch generator of
storage.py:145-202). It is ``ppo.py`` with a policy that carries a hidden
state:

- the rollout records each step's observation (normalised with the
  statistics from before the step), the mask the step was taken with
  (0 where an episode begins; the first from the state before the
  rollout), actions, log-probs, values, rewards, ``done``, ``bad`` and
  ``success``;
- GAE with the time-limit bootstrap (``ppo.compute_gae``);
- an update replays each env's whole T-step sequence through the GRU from
  the hidden state the rollout began with (``sequence_loss``);
  minibatches are whole envs (N % num_mini_batch == 0);
- clip by global norm, Adam (eps 1e-5), the learning rate decaying
  linearly to 0 over the run's optimizer steps when
  ``use_linear_lr_decay``;
- the success rate (the last 100 episodes) selects the best model;
  ``play``/``play_once`` bin each step by the misalignment the policy had
  to correct into the 3 x 3 count, success and improve matrices.

The vector env is the env's own ``vec_reset``/``vec_step_autoreset`` when
it has them (``envs.tactile_insertion_lanes``: one batched execution per
vector step, the JAX package's ``fused_vec`` branch), else ``ppo.VecEnv``
over single instances.

Deviations from the JAX package:
- exploration noise is drawn for each env; the JAX rollout hands all N
  envs one key (``ppo_rnn.py:130-133``), so they share one noise vector;
- the draws come from three ``torch.Generator``s (the env's, the policy's
  and the minibatch permutation's), seeded from ``seed``, all in the
  checkpoint;
- the learning rate decays as ``use_linear_lr_decay`` says (the reference
  protocol's yaml sets it); the JAX trainer keeps it constant whatever the
  config says;
- no TensorBoard writer (``logs.txt`` and the console).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models import nets
from ..utils import logging as log
from ..utils.tree import stack_rows
from .gd import _grads
from .ppo import PPO, NormState, VecEnvState, compute_gae


def sequence_loss(ac, obs, masks, actions, old_logp, old_values, returns,
                  advs, h0, clip_param):
    """Replay E envs' T-step sequences through the recurrent policy from
    their hidden states h0 (E, H): obs (T, E, ...), the rest (T, E) ->
    per env (action loss, value loss, entropy), each (E,)."""
    h, values, logps, ents = h0, [], [], []
    for t in range(obs.shape[0]):
        value, logp, ent, h = ac.evaluate_actions(obs[t], h, masks[t],
                                                  actions[t])
        values.append(value[:, 0])
        logps.append(logp[:, 0])
        ents.append(ent)
    values, logps, ents = (torch.stack(x) for x in (values, logps, ents))
    ratio = torch.exp(logps - old_logp)
    surr1 = ratio * advs
    surr2 = torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * advs
    action_loss = -torch.minimum(surr1, surr2).mean(dim=0)
    v_clipped = old_values + torch.clamp(values - old_values, -clip_param,
                                         clip_param)
    v_loss = 0.5 * torch.maximum((values - returns) ** 2,
                                 (v_clipped - returns) ** 2).mean(dim=0)
    return action_loss, v_loss, ents.mean(dim=0)


def minibatch_loss(ac, batch, clip_param, value_loss_coef, entropy_coef):
    """(loss, (action loss, value loss, entropy)) of one minibatch of whole
    envs: ``batch`` = (obs, masks, actions, old log-probs, old values,
    returns, advantages), each (T, E, ...), and h0 (E, H)."""
    a_l, v_l, ent = sequence_loss(ac, *batch, clip_param)
    a_l, v_l, ent = a_l.mean(), v_l.mean(), ent.mean()
    return a_l + value_loss_coef * v_l - entropy_coef * ent, (a_l, v_l, ent)


def misalignment_class(pose):
    """(row, col) of a pose's x and y in the 3 x 3 grid split at
    +-2.25 mm."""
    c = lambda x: 0 if x < -0.00225 else (1 if x < 0.00225 else 2)
    return c(pose[0]), c(pose[1])


class PPORNN(PPO):
    """``ppo.PPO`` with a recurrent policy: the rollout's carry is (vector
    state, hidden states (N, H), masks (N,)), and the success rate selects
    the best model."""

    DEFAULTS = {"num_steps": 512, "num_env_steps": 5_000_000,
                "num_mini_batch": 8}
    SCORE_TAG = "sr{:.2f}"
    MIN_EPISODES = 10

    def __init__(self, env, cfg: Dict[str, Any], logdir: Optional[str] = None,
                 seed: int = 0):
        super().__init__(env, cfg, logdir, seed)
        if self.num_processes % self.num_mini_batch:
            raise ValueError("recurrent minibatches split whole envs: "
                             "num_processes % num_mini_batch must be 0")
        self.hidden_size = self.ac.hidden_size

    def _dummy_obs(self):
        return torch.zeros(tuple(self.env.obs_size()), dtype=self.dtype,
                           device=self.device)

    def _make_net(self, obs_shape, network):
        return nets.ActorCriticRNN(obs_shape, self.env.ndof_u, network)

    # -- rollout and update --------------------------------------------------
    @torch.no_grad()
    def rollout(self, vec: VecEnvState, hxs, masks, norm: NormState):
        """``num_steps`` vector steps from hidden states hxs (N, H) and
        masks (N,) -> (vec, hxs, masks, norm, (obs seen normalised, masks,
        actions, log-probs, values, training rewards, dones, bads, raw
        rewards, successes), each (T, N, ...)). ``rollout_split`` gets the
        host seconds of the obs normalisation, the policy's act and the env
        steps (each vector step ends with a sync)."""
        steps = []
        split = {"norm_s": 0.0, "act_s": 0.0, "env_s": 0.0}
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda *_: None)
        for _ in range(self.num_steps):
            t0 = time.perf_counter()
            nobs = self._norm_obs(norm.obs_rms, vec.obs)
            t1 = time.perf_counter()
            value, action, logp, new_hxs = self.ac.act(
                nobs, hxs, masks, self.act_generator)
            t2 = time.perf_counter()
            next_vec, reward, done, bad, success = self.vec_step(vec, action)
            sync(self.device)
            t3 = time.perf_counter()
            split["norm_s"] += t1 - t0
            split["act_s"] += t2 - t1
            split["env_s"] += t3 - t2
            norm, r_train = self._norm_step(norm, vec.obs, reward, done)
            steps.append((nobs, masks, action, logp[:, 0], value[:, 0],
                          r_train, done, bad, reward, success))
            masks = 1.0 - done.to(hxs.dtype)
            hxs, vec = new_hxs, next_vec
        self.rollout_split = split
        return vec, hxs, masks, norm, stack_rows(steps)

    def update(self, vec: VecEnvState, hxs, masks, norm: NormState, h0, m0,
               outs):
        """GAE and ``ppo_epoch`` epochs of ``num_mini_batch`` minibatches of
        whole envs on one rollout that began from hidden states h0 and
        masks m0 -> the mean (loss, action loss, value loss, entropy)."""
        obs, mask_seq, actions, logps, values, rewards, dones, bads = outs[:8]
        N = values.shape[1]
        with torch.no_grad():
            mask_seq = torch.cat([m0[None], mask_seq[1:]])
            last_value = self.ac.get_value(
                self._norm_obs(norm.obs_rms, vec.obs), hxs, masks)[:, 0]
            returns, advs = compute_gae(values, rewards, dones, bads,
                                        last_value, self.gamma,
                                        self.gae_lambda)
            advs_n = (advs - advs.mean()) / (advs.std(unbiased=False) + 1e-5)
        seqs = (obs, mask_seq, actions, logps, values, returns, advs_n)
        params = list(self.ac.parameters())
        metrics = []
        for _ in range(self.ppo_epoch):
            perm = torch.randperm(N, generator=self.perm_generator,
                                  device=self.device)
            for idx in perm.reshape(self.num_mini_batch, -1):
                batch = tuple(x[:, idx] for x in seqs) + (h0[idx],)
                loss, aux = minibatch_loss(self.ac, batch, self.clip_param,
                                           self.value_loss_coef,
                                           self.entropy_coef)
                self.optimizer.step(_grads(loss, params))
                metrics.append(torch.stack([loss.detach()]
                                           + [a.detach() for a in aux]))
        return torch.stack(metrics).mean(dim=0).cpu()

    def _begin(self):
        """(vector state, zero hidden states, masks 0: every env begins an
        episode)."""
        N = self.num_processes
        return (self.vec_reset(),
                self.ac.initial_hidden(N, self.dtype, self.device),
                torch.zeros(N, dtype=self.dtype, device=self.device))

    def update_iteration(self, carry, norm: NormState):
        """One rollout and its update from ``carry`` = (vec, hxs, masks) ->
        (carry, norm, metrics, raw rewards (T, N), dones (T, N), successes
        (T, N)); ``last_update`` as ``PPO.update_iteration``'s."""
        t0 = time.perf_counter()
        vec, h0, m0 = carry
        vec, hxs, masks, norm, outs = self.rollout(vec, h0, m0, norm)
        t1 = time.perf_counter()
        metrics = self.update(vec, hxs, masks, norm, h0, m0, outs)
        self.last_update = {"rollout_s": t1 - t0,
                            "update_s": time.perf_counter() - t1,
                            **self.rollout_split, "metrics": metrics,
                            "raw_rewards": outs[8], "vec": vec}
        return (vec, hxs, masks), norm, metrics, outs[8], outs[6], outs[9]

    def _score(self, episode_rewards, successes):
        """The success rate (the model is selected from 10 episodes on)."""
        return float(np.mean(successes))

    def _score_text(self, episode_rewards, successes):
        return (f"reward {float(np.mean(episode_rewards)):.1f} | success "
                f"{float(np.mean(successes)):.3f}")

    # -- evaluation ----------------------------------------------------------
    @torch.no_grad()
    def play_once(self, seed: Optional[int] = None, stochastic=False):
        """One episode of the single-instance env (``env.env`` for a lane
        env) with the policy, its draws seeded from ``seed`` (default
        seed + 1); the training generators are left as they were. Returns
        (total reward, success, improve count, episode length, extra):
        extra holds the 3 x 3 ``class_cnt``, ``class_success_cnt`` and
        ``class_improve_cnt`` of each step's pre-step misalignment, the
        misalignment points and angles (degrees), and
        ``first_success_step`` (1-based, -1 for never)."""
        env = getattr(self.env, "env", self.env)
        seed = self.seed + 1 if seed is None else seed
        gen = env.generator
        saved = gen.get_state()
        gen.manual_seed(seed)
        act_gen = torch.Generator(device=self.device)
        act_gen.manual_seed(seed)
        class_cnt = np.zeros((3, 3), int)
        class_improve = np.zeros((3, 3), int)
        class_success = np.zeros((3, 3), int)
        points, angles = [], []
        total, improve_cnt, length, success, first = 0.0, 0, 0, False, -1
        try:
            state, obs = env.reset()
            hxs = self.ac.initial_hidden(1, self.dtype, self.device)
            ones = torch.ones(1, dtype=self.dtype, device=self.device)
            for _ in range(env.max_episode_steps):
                nobs = self._norm_obs(self.norm.obs_rms, obs[None])
                _, action, _, hxs = self.ac.act(nobs, hxs, ones, act_gen,
                                                deterministic=not stochastic)
                state, obs, reward, done, info = env.step(state, action[0])
                total += float(reward)
                length += 1
                pose = info["prev_object_pose"].double().cpu().numpy()
                c1, c2 = misalignment_class(pose)
                class_cnt[c1][c2] += 1
                points.append(pose[0:2])
                angles.append(float(np.rad2deg(pose[2])))
                if bool(info["success"]):
                    success = True
                    if first < 0:
                        first = length
                    class_success[c1][c2] += 1
                if bool(info["improve"]):
                    improve_cnt += 1
                    class_improve[c1][c2] += 1
                if bool(done):
                    break
        finally:
            gen.set_state(saved)
        extra = {"class_cnt": class_cnt, "class_improve_cnt": class_improve,
                 "class_success_cnt": class_success, "points": points,
                 "angles": angles, "first_success_step": first}
        return total, success, improve_cnt, length, extra

    def play(self, num_games=10, stochastic=False, seed=None,
             plot_path=None):
        """``play_once`` over ``num_games`` episodes (seeds seed, seed + 1,
        ..., default self.seed + 1): prints the summary and the per-class
        rates, optionally saves the misalignment scatter and angle
        histogram to ``plot_path``, and returns the aggregates."""
        seed = self.seed + 1 if seed is None else seed
        agg = {"class_cnt": np.zeros((3, 3), int),
               "class_improve_cnt": np.zeros((3, 3), int),
               "class_success_cnt": np.zeros((3, 3), int)}
        points, angles, steps_to_success = [], [], []
        success_cnt, improve_cnt, total_reward = 0, 0, 0.0
        for g in range(num_games):
            reward, success, imp, _, extra = self.play_once(seed + g,
                                                            stochastic)
            total_reward += reward
            improve_cnt += imp
            if success:
                success_cnt += 1
                steps_to_success.append(extra["first_success_step"])
            for name in agg:
                agg[name] += extra[name]
            points += extra["points"]
            angles += extra["angles"]

        n_steps = max(int(agg["class_cnt"].sum()), 1)
        # steps to the first success discriminates where episode success
        # saturates (a random walk succeeds within 15 tries)
        sts_mean = (float(np.mean(steps_to_success)) if steps_to_success
                    else float("nan"))
        sts_med = (float(np.median(steps_to_success)) if steps_to_success
                   else float("nan"))
        log.print_info(
            f"[Summary] Avg reward = {total_reward / num_games:.3f}, "
            f"Success rate = {success_cnt / num_games * 100.:.2f}%, "
            f"Steps-to-success mean = {sts_mean:.2f} / median = "
            f"{sts_med:.1f}, "
            f"Improve rate = {improve_cnt / n_steps * 100.:.2f}%")
        for c1 in range(3):
            for c2 in range(3):
                cnt = agg["class_cnt"][c1][c2]
                sr = agg["class_success_cnt"][c1][c2] / max(cnt, 1) * 100.
                ir = agg["class_improve_cnt"][c1][c2] / max(cnt, 1) * 100.
                log.print_info(
                    f"Class [{c1}, {c2}], total cnt = {cnt}, success rate = "
                    f"{sr:.3f}%, improve rate = {ir:.3f}%")
        if plot_path:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            pts = np.asarray(points) * 1000.0
            fig, ax = plt.subplots(1, 2, figsize=(10, 4))
            for v in (-10.0, -2.25, 2.25, 10.0):
                ax[0].plot([v, v], [-10., 10.], c="black")
                ax[0].plot([-10., 10.], [v, v], c="black")
            if len(pts):
                ax[0].scatter(pts[:, 0], pts[:, 1])
            ax[0].set_title("misalignment distribution")
            ax[1].hist(angles, bins=20, edgecolor="black", facecolor="blue",
                       alpha=0.7)
            ax[1].set_title("angle distribution")
            os.makedirs(os.path.dirname(plot_path) or ".", exist_ok=True)
            fig.savefig(plot_path)
            plt.close(fig)
        return {"success_rate": success_cnt / num_games,
                "improve_rate": improve_cnt / n_steps,
                "steps_to_success_mean": sts_mean,
                "steps_to_success_median": sts_med,
                "steps_to_success": steps_to_success,
                "avg_reward": total_reward / num_games, **agg}
