"""The port's GD trainer (``algorithms/gd.py``) on the CPU.

- global-norm clipping, Adam and the linear schedule against ``optax`` on
  fixed gradients, over 3 updates, to 1e-12 (f64);
- ``RunningMeanStd`` against the JAX package's, to 1e-12;
- the BPTT gradient w.r.t. the actor's parameters against central finite
  differences of the port's own rollout (B = 2, H = 2, f64, fixed episode
  noise) to 1e-5 relative: the chord stops at about 1e-7 of its first
  residual, and the at-solution adjoint is the derivative of the exact
  solution (tests/test_torch_adjoint.py). In two env steps from reset the
  pad does not reach the box, so the only contact is the box on the ground;
- ``train(stop_epoch=1)``, a checkpoint, a fresh trainer that resumes it
  and trains one more epoch: parameters, optimizer state, best reward and
  the env's generator equal those of two straight epochs.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import torch
import yaml

from tactilesimulation_tpu.utils.running_mean_std import \
    RunningMeanStd as JaxRMS
from tactilesimulation_tpu_torch.algorithms import gd
from tactilesimulation_tpu_torch.envs import tactile_push_lanes
from tactilesimulation_tpu_torch.utils.running_mean_std import RunningMeanStd

torch.set_num_threads(1)

CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "TactilePushExp", "cfg", "gd_tactile.yaml")


def _cfg(**config):
    with open(CFG_PATH) as fp:
        cfg = yaml.safe_load(fp)["params"]
    cfg["config"].update(config)
    return cfg


def test_adam_clip_schedule_match_optax():
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (3,)]
    p0 = [rng.randn(*s) for s in shapes]
    grads = [[scale * rng.randn(*s) for s in shapes]
             for scale in (0.1, 5.0, 0.3)]          # the 2nd is clipped
    lr, num_epochs, betas = 5e-3, 4, (0.7, 0.95)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(optax.linear_schedule(lr, 1e-5, num_epochs),
                                b1=betas[0], b2=betas[1]))
    pj = [jnp.asarray(p) for p in p0]
    state = tx.init(pj)
    pt = [torch.tensor(p) for p in p0]
    opt = gd.Adam(pt, gd.linear_schedule(lr, 1e-5, num_epochs), *betas,
                  max_norm=1.0)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step([torch.tensor(x) for x in g])
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-14)
    assert opt.count == 3
    np.testing.assert_allclose(
        float(gd.global_norm([torch.tensor(x) for x in grads[1]])),
        float(optax.global_norm([jnp.asarray(x) for x in grads[1]])),
        rtol=1e-14)


def test_running_mean_std_matches_jax():
    rng = np.random.RandomState(1)
    a = RunningMeanStd.create((5,), torch.float64)
    b = JaxRMS.create((5,), jnp.float64)
    for n in (7, 3):
        batch = rng.randn(n, 5) * 2.0 + 1.0
        a = a.update(torch.tensor(batch))
        b = b.update(jnp.asarray(batch))
    for name in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   np.asarray(getattr(b, name)), rtol=1e-12)
    x = rng.randn(4, 5)
    for un in (False, True):
        np.testing.assert_allclose(
            a.normalize(torch.tensor(x), un).numpy(),
            np.asarray(b.normalize(jnp.asarray(x), un)), rtol=1e-12)


def test_bptt_gradient_matches_fd():
    env = tactile_push_lanes.make("tactile_flatten", device="cpu",
                                  dtype=torch.float64)
    env.max_episode_steps = 2
    trainer = gd.GD(env, _cfg(num_episodes=2), seed=3)
    params = list(trainer.actor.parameters())

    def loss():
        with trainer._episode_noise(11):
            return trainer.epoch_loss()[0]

    grads = gd._grads(loss(), params)
    flat_p = torch.nn.utils.parameters_to_vector(params).detach().clone()
    flat_g = torch.cat([g.reshape(-1) for g in grads])
    assert float(flat_g.abs().max()) > 0
    rng = np.random.RandomState(2)
    eps = 1e-6
    with torch.no_grad():
        for _ in range(2):
            d = torch.tensor(rng.randn(flat_p.numel()))
            d = d / d.norm()
            torch.nn.utils.vector_to_parameters(flat_p + eps * d, params)
            lp = float(loss())
            torch.nn.utils.vector_to_parameters(flat_p - eps * d, params)
            lm = float(loss())
            fd = (lp - lm) / (2 * eps)
            an = float(flat_g @ d)
            assert abs(fd - an) <= 1e-5 * max(abs(fd), abs(an)), (fd, an)
        torch.nn.utils.vector_to_parameters(flat_p, params)


def test_train_checkpoint_resume_is_exact(tmp_path):
    cfg = _cfg(num_episodes=2, num_epochs=5, obs_rms=True)

    def trainer(logdir):
        env = tactile_push_lanes.make("tactile_flatten", device="cpu",
                                      max_iter=2)
        env.max_episode_steps = 2
        return gd.GD(env, cfg, logdir=str(logdir), seed=0)

    straight = trainer(tmp_path / "a")
    straight.train(stop_epoch=2)

    first = trainer(tmp_path / "b")
    r1 = first.train(stop_epoch=1)
    assert np.isfinite(r1)
    assert (tmp_path / "b" / "logs.txt").read_text().startswith("epoch 0:")
    resumed = trainer(tmp_path / "c")
    resumed.resume(str(tmp_path / "b" / "checkpoint.pt"))
    assert resumed._epoch == 1
    resumed.train(stop_epoch=2)

    moved = False
    for (name, a), b, c in zip(straight.actor.state_dict().items(),
                               resumed.actor.state_dict().values(),
                               trainer(tmp_path / "d").actor.parameters()):
        assert torch.equal(a, b), name
        moved |= not torch.equal(a, c)
    assert moved, "training left the parameters where they started"
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 2
    assert all(torch.equal(x, y) for x, y in zip(sa["mu"] + sa["nu"],
                                                 sb["mu"] + sb["nu"]))
    assert torch.equal(straight.obs_rms.mean, resumed.obs_rms.mean)
    assert straight._best == resumed._best
    assert torch.equal(straight.env.generator.get_state(),
                       resumed.env.generator.get_state())
