"""GD: analytic-gradient (BPTT) policy optimisation.

Port of ``tactilesimulation_tpu/algorithms/gd.py``. One epoch is ONE batched
differentiable rollout of ``num_episodes`` episodes over the horizon, the
loss -mean(episode reward), its gradient w.r.t. the actor's parameters,
global-norm clipping and Adam with a linear learning-rate schedule to 1e-5
(the reference protocol, e.g.
``examples/TactilePushExp/cfg/gd_tactile.yaml``).

The rollout env, by the JAX package's rule: the env's lane-major twin
(``env.lane_env()``, e.g. ``TactilePushLanes``, which on the card runs
K2/K3 per env step) when ``config.lane_rollouts`` (default true) is set
and the env has one; otherwise the env's own ``batched_rollout_fn`` (E
single instances one after another, e.g. the pendulum). A lane env handed
in directly is its own rollout env. ``config.remat`` (default true)
recomputes each env step in the backward (``batched_rollout_fn``'s
``remat``). ``evaluate`` and ``test_gradient`` play single-instance
episodes on the env (``rollout_fn``), or lane episodes at B = 1 when GD
was handed a lane env.

Observability, as in the JAX package: ``logs.txt``, TensorBoard scalars
(``utils.logging.SummaryWriter`` in ``<logdir>/log``: ``rewards/step``,
``rewards/iter``, ``loss/iter``, ``grad_norm/iter`` and the phase timer's
``profile/update_mean_s``), and with ``config.profile_epochs = [lo, hi)`` a
``torch.profiler`` trace of those epochs in ``<logdir>/profile``
(``utils.profiling.trace``).

Deviations from the JAX package:
- episodes draw their reset and disturbance noise from the rollout env's
  ``torch.Generator`` (seeded from ``seed``), whose state the checkpoint
  carries; ``evaluate`` from the env's generator seeded to ``seed + 1``;
  the JAX package splits PRNG keys;
- no data-parallel episode sharding (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.nets import DiagGaussianActor
from ..utils import checkpoint
from ..utils import logging as log
from ..utils import profiling
from ..utils.running_mean_std import RunningMeanStd


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """``optax.linear_schedule``: init to end over ``transition_steps``
    updates, then constant (init throughout when ``transition_steps`` <=
    0). Evaluated in float32, as optax evaluates it on its int32 step
    count."""
    f32 = np.float32
    if transition_steps <= 0:      # optax: a constant schedule
        return lambda count: init_value

    def lr(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = f32(1) - f32(c) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))
    return lr


def _grads(loss, params):
    """d loss / d params, zeros for a parameter the loss does not read (the
    deterministic policy never reads its log-std)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


class Adam:
    """``optax.chain([clip_by_global_norm(max_norm)], adam(lr, b1, b2))``
    on a list of parameters, updated in place; its state (step count, first
    and second moments) is a plain dict for checkpoints."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8,
                 max_norm: Optional[float] = None):
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda count, v=lr: v)
        self.b1, self.b2, self.eps, self.max_norm = b1, b2, eps, max_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        if self.max_norm is not None:
            g_norm = global_norm(grads)
            if not bool(g_norm < self.max_norm):
                grads = [g / g_norm * self.max_norm for g in grads]
        count_inc = self.count + 1
        step = -self.lr(self.count)
        c1 = 1.0 - self.b1 ** count_inc
        c2 = 1.0 - self.b2 ** count_inc
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * g * g + self.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(step * update)
        self.count = count_inc

    def state_dict(self):
        return {"count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, d):
        self.count = int(d["count"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(d["mu"]) + list(d["nu"])):
                dst.copy_(src)


class GD:
    def __init__(self, env, cfg: Dict[str, Any], logdir: Optional[str] = None,
                 seed: int = 0):
        """env: a ``FunctionalEnv`` or a lane env (``TactilePushLanes``);
        cfg: the YAML ``params`` dict (``config`` and ``network``
        sections)."""
        self.env = env
        self.cfg = cfg
        config = cfg.get("config", {})
        network = cfg.get("network", {})
        self.seed = seed
        self.num_epochs = config.get("num_epochs", 300)
        self.num_episodes = config.get("num_episodes", 16)
        self.horizon = getattr(env, "max_episode_steps", 100)
        self.lr = config.get("lr", 3e-4)
        self.lr_schedule = config.get("lr_schedule", "linear")
        self.truncate_grads = config.get("truncate_grads", False)
        self.grad_norm = config.get("grad_norm", 1.0)
        self.betas = tuple(config.get("betas", (0.9, 0.999)))
        self.use_obs_rms = config.get("obs_rms", False)
        self.remat = config.get("remat", True)
        self.logdir = logdir
        # config.profile_epochs = [lo, hi): a profiler trace of those epochs
        # in <logdir>/profile
        self.profile_epochs = tuple(config.get("profile_epochs", ()))
        self.timer = profiling.PhaseTimer()
        self.scalar_backend = None    # the last train()'s writer backend
        lane = (env.lane_env() if config.get("lane_rollouts", True)
                and hasattr(env, "lane_env") else None)
        self.rollout_env = lane if lane is not None else env

        actor_name = network.get("actor", "DiagGaussianActor")
        assert actor_name == "DiagGaussianActor", (
            "GD drives flat-obs actors; use observation_type with vector obs")
        obs_dim = env.obs_size()[0]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.actor = DiagGaussianActor(obs_dim, env.ndof_u, network)
        self.actor.to(env.device, env.dtype)
        self.obs_rms = (RunningMeanStd.create((obs_dim,), env.dtype,
                                              env.device)
                        if self.use_obs_rms else None)
        lr = (linear_schedule(self.lr, 1e-5, self.num_epochs)
              if self.lr_schedule == "linear" else self.lr)
        self.optimizer = Adam(self.actor.parameters(), lr, self.betas[0],
                              self.betas[1],
                              max_norm=(self.grad_norm if self.truncate_grads
                                        else None))
        # resumable training state: the episodes' noise comes from the env's
        # generator, so its state is part of a checkpoint
        self._epoch = 0
        self._best = -np.inf
        self.rollout_env.generator.manual_seed(seed)

    # ------------------------------------------------------------------
    def policy(self, obs):
        if self.obs_rms is not None:
            obs = self.obs_rms.normalize(obs)
        return self.actor.act(obs, deterministic=True)

    def epoch_loss(self):
        """(loss, episode rewards (E,), infos, obs seen (E, H, obs) or
        None): one differentiable rollout of the epoch's episodes."""
        run = self.rollout_env.batched_rollout_fn(
            self.policy, self.horizon, remat=self.remat,
            with_obs=self.use_obs_rms)
        outs = run(self.num_episodes)
        rewards, infos = outs[0], outs[2]
        episode_reward = torch.sum(rewards, dim=-1)
        loss = -torch.mean(episode_reward)
        obs_seen = outs[3].detach() if self.use_obs_rms else None
        return loss, episode_reward, infos, obs_seen

    def update(self):
        """One epoch: rollout, gradient, clip + Adam, and the bulk obs-RMS
        update with the observations the policy saw (every episode
        normalises with the pre-epoch statistics, as in the JAX package).
        Returns (loss, episode rewards, infos, pre-clip gradient norm)."""
        params = list(self.actor.parameters())
        loss, ep_rewards, infos, obs_seen = self.epoch_loss()
        grads = _grads(loss, params)
        gnorm = global_norm(grads)
        self.optimizer.step(grads)
        if self.use_obs_rms:
            self.obs_rms = self.obs_rms.update(
                obs_seen.reshape(-1, obs_seen.shape[-1]))
        return loss.detach(), ep_rewards.detach(), infos, gnorm

    def train(self, stop_epoch: Optional[int] = None):
        """Run epochs [resumed epoch, num_epochs); ``stop_epoch`` stops
        early. Returns the mean episode reward of the last (up to 200)
        episodes."""
        end_epoch = (self.num_epochs if stop_epoch is None
                     else min(stop_epoch, self.num_epochs))
        textlog = (log.TextLog(os.path.join(self.logdir, "logs.txt"),
                               append=self._epoch > 0)
                   if self.logdir else None)
        writer = (log.SummaryWriter(os.path.join(self.logdir, "log"))
                  if self.logdir else None)
        self.scalar_backend = writer.backend if writer else None
        episode_rewards = deque(maxlen=200)
        best = self._best
        t_start = time.time()
        steps = 0
        if self.logdir and self._epoch == 0:
            self.save("init_policy")
        profile = None
        try:
            for epoch in range(self._epoch, end_epoch):
                if self.profile_epochs and self.logdir:
                    if epoch == self.profile_epochs[0]:
                        profile = profiling.trace(
                            os.path.join(self.logdir, "profile"))
                        profile.__enter__()
                    elif epoch == self.profile_epochs[1] and profile:
                        profile.__exit__(None, None, None)
                        profile = None
                t0 = time.time()
                with self.timer.phase("update") as box:
                    loss, ep_rewards, _, gnorm = self.update()
                    box["sync"] = (loss, gnorm)
                episode_rewards.extend(ep_rewards.cpu().numpy().tolist())
                steps += self.num_episodes * self.horizon
                total_steps = (epoch + 1) * self.num_episodes * self.horizon
                mean_r = float(np.mean(episode_rewards))
                fps = steps / (time.time() - t_start)
                msg = (f"epoch {epoch}: num steps = {total_steps}, "
                       f"FPS = {fps:.1f}, mean(reward) = {mean_r:.6f}, "
                       f"loss = {float(loss):.6f}, grad_norm = "
                       f"{float(gnorm):.3f}, seconds = "
                       f"{time.time() - t0:.2f}")
                if mean_r > best:
                    log.print_ok(msg)
                    best = mean_r
                    if self.logdir:
                        self.save()
                else:
                    print(msg, flush=True)
                if textlog:
                    textlog.append(msg)
                if writer:
                    writer.add_scalar("rewards/step", mean_r, total_steps)
                    writer.add_scalar("rewards/iter", mean_r, epoch)
                    writer.add_scalar("loss/iter", float(loss), epoch)
                    writer.add_scalar("grad_norm/iter", float(gnorm), epoch)
                    self.timer.log_to(writer, epoch)
                    writer.flush()
                self._best, self._epoch = best, epoch + 1
                if self.logdir:
                    self.save_checkpoint()
                    if epoch % 50 == 0:
                        self.save(f"policy_iter{epoch}_reward{mean_r:.2f}")
        finally:
            if profile:
                profile.__exit__(None, None, None)
            if writer:
                writer.close()
        if self.logdir:
            self.save("final_policy")
        return float(np.mean(episode_rewards)) if episode_rewards else \
            float("nan")

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _episode_noise(self, seed: int, env=None):
        """Run with the generator of ``env`` (the rollout env when None)
        seeded to ``seed``, then put its training state back."""
        gen = (self.rollout_env if env is None else env).generator
        saved = gen.get_state()
        gen.manual_seed(seed)
        try:
            yield
        finally:
            gen.set_state(saved)

    def _episode_rewards(self, horizon):
        """The rewards of one episode on the env: a single instance
        (``rollout_fn``, no remat), or one lane when the env is a lane
        env."""
        if hasattr(self.env, "rollout_fn"):
            return self.env.rollout_fn(self.policy, horizon,
                                       remat=False)()[0]
        return self.env.batched_rollout_fn(self.policy, horizon)(1)[0]

    def evaluate(self, num_games=1):
        """Mean total reward of ``num_games`` deterministic episodes on the
        env, with noise from its generator seeded to ``seed + 1``."""
        total = 0.0
        with torch.no_grad(), self._episode_noise(self.seed + 1, self.env):
            for _ in range(num_games):
                total += float(torch.sum(self._episode_rewards(
                    self.horizon)))
        return total / num_games

    def save(self, filename=None):
        os.makedirs(os.path.join(self.logdir, "models"), exist_ok=True)
        path = os.path.join(self.logdir, "models",
                            f"{filename or 'best_model'}.pt")
        torch.save({"params": self.actor.state_dict(),
                    "obs_rms": (self.obs_rms.state_dict()
                                if self.obs_rms else None)}, path)

    def load(self, path):
        blob = torch.load(path, map_location=self.env.device,
                          weights_only=True)
        self.actor.load_state_dict(blob["params"])
        if blob.get("obs_rms") is not None:
            self.obs_rms = RunningMeanStd.from_state_dict(blob["obs_rms"])

    # -- full-state checkpoint / resume ---------------------------------
    def save_checkpoint(self, name: str = "checkpoint"):
        checkpoint.save_state(
            os.path.join(self.logdir, f"{name}.pt"),
            {"params": self.actor.state_dict(),
             "opt_state": self.optimizer.state_dict(),
             "obs_rms": self.obs_rms.state_dict() if self.obs_rms else None,
             "epoch": self._epoch, "best": self._best,
             "generator": self.rollout_env.generator.get_state()})

    def resume(self, path):
        """Restore parameters, optimizer state, obs statistics, epoch, best
        reward and the rollout env's generator: a following ``train()`` continues
        exactly where the checkpointed run stopped."""
        blob = checkpoint.restore_state(path, map_location="cpu")
        self.actor.load_state_dict(blob["params"])
        self.optimizer.load_state_dict(blob["opt_state"])
        if blob.get("obs_rms") is not None:
            self.obs_rms = RunningMeanStd.from_state_dict(
                {k: v.to(self.env.device) for k, v in
                 blob["obs_rms"].items()})
        self._epoch = int(blob["epoch"])
        self._best = float(blob["best"])
        self.rollout_env.generator.set_state(blob["generator"])

    # ------------------------------------------------------------------
    def test_gradient(self, num_params=20, seed=123,
                      eps_list=(1e-2, 1e-3, 1e-4)):
        """FD check of the policy-parameter gradient through the whole BPTT
        path of one episode on the env (``evaluate``'s), H = min(horizon,
        20), with fixed episode noise. Returns per eps (abs_err, rel_err,
        cosine) over ``num_params`` random coordinates."""
        horizon = min(self.horizon, 20)
        params = list(self.actor.parameters())

        def total_reward():
            with self._episode_noise(seed, self.env):
                return torch.sum(self._episode_rewards(horizon))

        grads = _grads(total_reward(), params)
        flat_g = torch.cat([g.reshape(-1) for g in grads])
        flat_p = torch.nn.utils.parameters_to_vector(params).detach()
        idx = np.random.RandomState(0).randint(0, flat_p.numel(), num_params)
        results = []
        try:
            with torch.no_grad():
                base = float(total_reward())
                for eps in eps_list:
                    fd = np.zeros(num_params)
                    for k, i in enumerate(idx):
                        pp = flat_p.clone()
                        pp[i] += eps
                        torch.nn.utils.vector_to_parameters(pp, params)
                        fd[k] = (float(total_reward()) - base) / eps
                    an = flat_g[torch.as_tensor(idx)].cpu().numpy()
                    abs_err = float(np.linalg.norm(fd - an))
                    rel_err = abs_err / max(1e-7, min(np.linalg.norm(fd),
                                                      np.linalg.norm(an)))
                    cos = float(np.dot(fd, an) / max(
                        1e-12, np.linalg.norm(fd) * np.linalg.norm(an)))
                    results.append((abs_err, rel_err, cos))
        finally:
            with torch.no_grad():
                torch.nn.utils.vector_to_parameters(flat_p, params)
        return results
