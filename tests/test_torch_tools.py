"""The port's tools around the simulator and the trainers against the JAX
package's, on the CPU.

- ``utils/renderer``: ``render_frame`` of the port and of JAX at the same
  TactilePush q give the same pixels, bit for bit (the same matplotlib
  calls on FK that agrees to round-off, far below a pixel);
  ``render_trajectory`` writes N numbered PNGs or a GIF of N frames;
  ``Simulation.replay`` with ``viewer_options.record`` (frames) and
  without (the last frame); ``GymEnv.render`` ``once`` (the episode's own
  model, ``_model_for``) and ``record``.
- ``utils/profiling``: ``PhaseTimer.report`` and ``log_to`` as JAX's;
  ``trace`` writes a Chrome trace that names an ``annotate`` region;
  ``device_memory_stats("cpu") == {}``; GD's ``profile_epochs`` writes a
  trace into ``<logdir>/profile``.
- ``utils/math`` against JAX's on numpy inputs (scale, unscale, remap,
  grad_norm, flatten_params and fill_params in parameter order);
  ``random_quaternions``: shape, dtype, unit norm, seeded by its generator.
- ``utils/logging.SummaryWriter`` on both backends (TensorBoard, and the
  JSONL file forced by ``monkeypatch``), read back by ``read_scalars``.
- GD (pendulum, 2 epochs), PPO (pendulum, 1 update) and PPO-RNN (a stub
  env, 1 update) write exactly the JAX trainers' tags (read from their
  sources), at the JAX trainers' steps.
"""

import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tactilesimulation_tpu.algorithms as jax_algorithms
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.utils import math as jax_math
from tactilesimulation_tpu.utils import profiling as jax_profiling
from tactilesimulation_tpu.utils import renderer as jax_renderer
from tactilesimulation_tpu_torch.algorithms import gd, ppo
from tactilesimulation_tpu_torch.envs import pendulum
from tactilesimulation_tpu_torch.envs.gym_wrapper import GymEnv
from tactilesimulation_tpu_torch.model import task_scenes
from tactilesimulation_tpu_torch.sim.simulation import Simulation
from tactilesimulation_tpu_torch.utils import logging as log
from tactilesimulation_tpu_torch.utils import math as tmath
from tactilesimulation_tpu_torch.utils import profiling, renderer
from test_torch_ppo import PEND_CFG
from test_torch_ppo_rnn import _algo as ppo_rnn_algo

torch.set_num_threads(1)

F64 = torch.float64
PUSH_Q = np.array([0.3, 0.01, -0.02, -0.01, 0.0, 0.04, -0.2])


def pixels(fig):
    fig.canvas.draw()
    px = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    import matplotlib.pyplot as plt
    plt.close(fig)
    return px


def test_render_frame_matches_jax():
    sj, mj = jax_scenes.tactile_push()
    st, mt = task_scenes.tactile_push()
    cam = (np.array([0.5, -0.6, 0.4]), np.array([0.05, 0.0, 0.02]))
    for camera in (None, cam):
        want = pixels(jax_renderer.render_frame(sj, mj, jnp.asarray(PUSH_Q),
                                                lim=0.15, camera=camera))
        got = renderer.frame_pixels(renderer.render_frame(
            st, mt, PUSH_Q, lim=0.15, camera=camera))
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.array_equal(got, want)
        assert (got != 255).any()


def test_render_trajectory_writes_frames_and_gif(tmp_path):
    st, mt = task_scenes.rolling_ball(8)
    qs = np.stack([mt.q_init.numpy() + 0.01 * k for k in range(3)])
    assert renderer.render_trajectory(st, mt, qs, str(tmp_path / "f")) == 3
    assert sorted(os.listdir(tmp_path / "f")) == ["0.png", "1.png", "2.png"]
    gif = str(tmp_path / "g" / "out.gif")
    assert renderer.render_trajectory(st, mt, qs, gif, loop=True) == 3
    with Image.open(gif) as im:
        assert im.n_frames == 3


def test_simulation_replay(tmp_path):
    sim = Simulation(task_scenes.rolling_ball(8), device="cpu")
    assert sim.replay() == 0                 # nothing recorded yet
    sim.reset()
    sim.set_u([0.0, 0.0, 0.2])
    sim.forward(2)
    assert sim.replay() == 1
    assert sim.last_render.ndim == 3 and sim.last_render.dtype == np.uint8
    sim.viewer_options.record = True
    sim.viewer_options.record_folder = str(tmp_path / "frames")
    assert sim.replay() == 3
    assert len(os.listdir(tmp_path / "frames")) == 3
    sim.viewer_options.record_folder = str(tmp_path / "replay.gif")
    sim.viewer_options.speed, sim.viewer_options.loop = 2.0, True
    assert sim.replay() == 3 and os.path.exists(tmp_path / "replay.gif")


def test_gym_render(tmp_path):
    env = pendulum.make(device="cpu", dtype=F64)
    # start hanging at rest: the bob in the frame's view
    env._draw = lambda what, B: (torch.zeros(B, dtype=F64),) * 2
    gym = GymEnv(env, seed=1)
    gym.reset()
    gym.step(np.array([0.5]))
    frame = gym.render("once")
    assert frame.ndim == 3 and frame.shape[-1] == 3
    assert (frame != 255).any()
    assert np.array_equal(gym.render("loop"), frame)
    # an env with per-episode models is drawn with the episode's
    env._model_for = lambda ex: dataclasses.replace(
        env.model, body_size=env.model.body_size * 3)
    assert not np.array_equal(gym.render("once"), frame)
    del env._model_for
    assert gym.render("record", str(tmp_path / "ep.gif")) == 2
    assert os.path.exists(tmp_path / "ep.gif")


def test_phase_timer_matches_jax():
    timers = (profiling.PhaseTimer(), jax_profiling.PhaseTimer())
    syncs = (torch.ones(3), jnp.ones(3))
    for timer, sync in zip(timers, syncs):
        for _ in range(2):
            with timer.phase("rollout", sync=sync):
                pass
        with timer.phase("update") as box:
            box["sync"] = sync
    got, want = (t.report() for t in timers)
    assert sorted(got) == sorted(want) == ["rollout", "update"]
    for k in got:
        assert sorted(got[k]) == sorted(want[k])
        assert got[k]["calls"] == want[k]["calls"]
        assert got[k]["mean_s"] == got[k]["total_s"] / got[k]["calls"]

    class Writer:
        def __init__(self):
            self.rows = []

        def add_scalar(self, tag, value, step):
            self.rows.append((tag, step))
    logged = []
    for t in timers:
        w = Writer()
        t.log_to(w, 4)
        logged.append(sorted(w.rows))
    assert logged[0] == logged[1] == [("profile/rollout_mean_s", 4),
                                      ("profile/update_mean_s", 4)]
    timers[0].reset()
    assert timers[0].report() == {}


def test_trace_names_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("xml_scene_region"):
            torch.ones(64).cumsum(0)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as fp:
        names = {e.get("name") for e in json.load(fp)["traceEvents"]}
    assert "xml_scene_region" in names


def test_device_memory_stats_on_cpu():
    assert profiling.device_memory_stats("cpu") == {}
    assert profiling.device_memory_stats(torch.device("cpu")) == {}


def test_math_matches_jax():
    rng = np.random.RandomState(0)
    x, lo, hi = rng.uniform(-1, 1, 7), -rng.rand(7) - 0.5, rng.rand(7) + 0.5
    for name, args in (("scale", (x, lo, hi)), ("unscale", (x, lo, hi)),
                       ("remap", (x, lo, hi, 2 * lo, 3 * hi))):
        got = getattr(tmath, name)(*(torch.as_tensor(a) for a in args))
        want = getattr(jax_math, name)(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15, atol=1e-15)

    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ELU(),
                              torch.nn.Linear(4, 2)).double()
    net(torch.as_tensor(rng.randn(5, 3))).square().sum().backward()
    params = [p.detach().numpy() for p in net.parameters()]
    grads = [p.grad.numpy() for p in net.parameters()]
    np.testing.assert_allclose(
        float(tmath.grad_norm(net)),
        float(jax_math.grad_norm([jnp.asarray(g) for g in grads])),
        rtol=1e-14)
    flat = tmath.flatten_params(net)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jax_math.flatten_params(
            [jnp.asarray(p) for p in params])))
    new = torch.as_tensor(rng.randn(flat.numel()))
    tmath.fill_params(net, new)
    want = jax_math.fill_params([jnp.asarray(p) for p in params],
                                jnp.asarray(new.numpy()))
    for p, w in zip(net.parameters(), want):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_random_quaternions(dtype):
    q = tmath.random_quaternions(
        500, generator=torch.Generator().manual_seed(4), dtype=dtype)
    assert q.shape == (500, 4) and q.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    assert float((q.norm(dim=-1) - 1).abs().max()) < tol
    again = tmath.random_quaternions(
        500, generator=torch.Generator().manual_seed(4), dtype=dtype)
    assert torch.equal(q, again)
    assert float(q[:, 0].abs().mean()) > 0.3    # spread, not a constant


@pytest.mark.parametrize("backend", ["tensorboard", "jsonl"])
def test_summary_writer(backend, tmp_path, monkeypatch):
    if backend == "jsonl":
        monkeypatch.setattr(log, "_tensorboard_writer", lambda: None)
    w = log.SummaryWriter(str(tmp_path))
    assert w.backend == backend
    rows = [("a/b", 1.25, 0), ("a/b", 0.1, 3), ("c", -2.0, 1)]
    for tag, value, step in rows:
        w.add_scalar(tag, value, step)
    w.flush()
    w.close()
    files = os.listdir(tmp_path)
    assert (files == ["scalars.jsonl"]) == (backend == "jsonl")
    cast = float if backend == "jsonl" else (lambda v: float(np.float32(v)))
    want = {}
    for tag, value, step in rows:
        want.setdefault(tag, []).append((step, cast(value)))
    assert log.read_scalars(str(tmp_path)) == want


def jax_tags(module):
    """The tags the JAX trainer writes: its add_scalar literals and its
    phase timer's phases."""
    path = os.path.join(os.path.dirname(jax_algorithms.__file__),
                        f"{module}.py")
    with open(path) as fp:
        src = fp.read()
    tags = set(re.findall(r'add_scalar\("([^"]+)"', src))
    tags |= {f"profile/{p}_mean_s"
             for p in re.findall(r'timer\.phase\("([^"]+)"', src)}
    return tags


def test_gd_writes_jax_tags_and_profile(tmp_path):
    env = pendulum.make(device="cpu", dtype=F64)
    env.max_episode_steps = 3
    cfg = {"config": {"num_epochs": 2, "num_episodes": 2, "lr": 1e-2,
                      "profile_epochs": [1, 2]},
           "network": {"actor_mlp": {"layer_sizes": [8],
                                     "activation": "elu"}}}
    trainer = gd.GD(env, cfg, logdir=str(tmp_path), seed=0)
    trainer.train()
    scalars = log.read_scalars(str(tmp_path / "log"))
    assert set(scalars) == jax_tags("gd") and len(jax_tags("gd")) == 5
    assert [s for s, _ in scalars["rewards/step"]] == [6, 12]
    assert all([s for s, _ in scalars[t]] == [0, 1]
               for t in scalars if t != "rewards/step")
    assert trainer.scalar_backend in ("tensorboard", "jsonl")
    traces = os.listdir(tmp_path / "profile")
    assert len(traces) == 1 and traces[0].endswith(".json")


def test_ppo_writes_jax_tags(tmp_path):
    env = pendulum.make(device="cpu", dtype=F64)
    env.max_episode_steps = 3
    algo = ppo.PPO(env, PEND_CFG, logdir=str(tmp_path), seed=0)
    algo.train(stop_update=1)
    scalars = log.read_scalars(str(tmp_path / "log"))
    assert set(scalars) == jax_tags("ppo") and len(scalars) == 4
    assert all([s for s, _ in v] == [8] for v in scalars.values())


def test_ppo_rnn_writes_jax_tags(tmp_path):
    algo = ppo_rnn_algo("drift", logdir=str(tmp_path))
    algo.train(stop_update=1)
    scalars = log.read_scalars(str(tmp_path / "log"))
    assert set(scalars) == jax_tags("ppo_rnn") and len(scalars) == 2
    assert all([s for s, _ in v] == [24] for v in scalars.values())
    assert scalars["success_rate/step"][0][1] == 0.0
