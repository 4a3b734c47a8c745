"""The port's DClaw cap-rotation env against the JAX package, float64 on
the CPU.

JAX's draws come from its keys, split as its env splits them, and go to the
port through ``_draw``.

- ``reset`` with JAX's draws (key 25: a cap of radius 0.056 that all
  three fingertips touch at the start pose): the pose, the episode's Model
  leaves and the observation within 1e-12 of scale;
- ``_flow_images`` on a field whose rows share pixels: each pixel holds
  the sum of its rows (JAX's ``.at[].add``);
- the three control modes, 2 steps each, with the substeps replaced on
  both sides by one that sets the fingers to the motors' target: JAX's
  step code around its dynamics (target, observation, reward, flags; the
  dynamics themselves and the action gradient are held to JAX in
  ``tests/test_torch_dclaw_steps.py``);
- two resets with other radii: each episode's read (the read's route) equal
  to ``dynamics.tactile_field`` on its own Model, each with its own plan;
- ``make_tactile`` against the JAX package's script on a small OBJ, and the
  random-action entry point on the CPU.
"""

import runpy
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.envs import dclaw_rotate as jdc
from tactilesimulation_tpu_torch.envs import dclaw_rotate as tdc
from tactilesimulation_tpu_torch.examples import dclaw_env, make_tactile
from tactilesimulation_tpu_torch.model import assets
from tactilesimulation_tpu_torch.ops import tactile_query
from tactilesimulation_tpu_torch.sim import dynamics

torch.set_num_threads(1)

F64 = torch.float64
KEY = 25
# the second reaches past the clip on one joint of each finger
ACTIONS = (np.array([0.4, -0.3, 0.8, 0.1, 0.5, -0.6, 0.2, -0.2, 0.9]),
           np.array([1.6, -0.5, 0.3, -1.3, 0.2, 0.7, 0.0, 1.2, -0.4]))


def scale_err(got, want):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def reset_draws(key):
    """JAX's reset draws from ``key`` as the port's "reset" dict (B = 1)."""
    kq, kd, kr, kxy, _ = jax.random.split(key, 5)
    f64 = jnp.float64
    d = {"noise": jax.random.normal(kq, (9,), f64),
         "damping": jax.random.uniform(kd, minval=0.01, maxval=0.7,
                                       dtype=f64),
         "radius": jax.random.uniform(kr, minval=0.02, maxval=0.08,
                                      dtype=f64),
         "dxy": jax.random.uniform(kxy, (2,), minval=-0.02, maxval=0.02,
                                   dtype=f64)}
    return {k: torch.tensor(np.asarray(v))[None] for k, v in d.items()}


def port_env(observation_type="tactile", **kw):
    """The port's env with JAX's reset draws from KEY."""
    env = tdc.make(observation_type, device="cpu", dtype=F64, **kw)
    draws = reset_draws(jax.random.PRNGKey(KEY))
    env._draw = lambda what, B: draws
    return env


def test_reset_matches_jax():
    env_j = jdc.make("tactile")
    state_j, obs_j = jax.jit(env_j.reset)(jax.random.PRNGKey(KEY))
    env = port_env()
    with torch.no_grad():
        state, obs = env.reset()
    assert scale_err(state.sim.q, state_j.sim.q) <= 1e-12
    for k in ("dof_damping", "body_size", "joint_pos", "ee_pos"):
        assert scale_err(getattr(state.extras, k),
                         getattr(state_j.extras, k)) <= 1e-12, k
    assert obs.shape == env.obs_size() == env_j.obs_size()
    assert scale_err(obs, obs_j) <= 1e-12
    imgs = state.extras.tactile_imgs
    assert scale_err(imgs, state_j.extras.tactile_imgs) <= 1e-12
    # every fingertip touches the cap at the start pose
    assert bool((imgs.abs().sum(dim=(1, 2, 3)) > 0).all())


def test_flow_images_add_shared_pixels(monkeypatch):
    env_j = jdc.make("tactile")
    env = tdc.make(device="cpu", dtype=F64)
    n = env.struct.ndof_tactile // 3
    pix = env._img_pix.numpy()
    assert len(np.unique(pix)) < n, "no two rows share a pixel"
    field = np.random.RandomState(3).randn(n, 3)
    monkeypatch.setattr(jdc, "dynamics", types.SimpleNamespace(
        tactile_field=lambda *args: jnp.asarray(field)))
    q = jnp.zeros(env.struct.ndof_q)
    want = np.asarray(env_j._flow_images(env_j.model, q, q))
    got = env._images(torch.tensor(field))
    assert got.shape == want.shape == (3, tdc.ROWS, tdc.COLS, 3)
    assert scale_err(got, want) <= 1e-14


def _set_target_j(model, s, target):
    return s.replace(q=s.q.at[:9].set(target))


def _set_target(model, s, target):
    return s.replace(q=torch.cat([target, s.q[9:]]))


@pytest.mark.parametrize("mode,obs_type", [
    ("relative", "tactile"), ("absolute", "tactile_flatten"),
    ("torque", "no_tactile")])
def test_control_modes_match_jax(mode, obs_type):
    kw = dict(torque_control=mode == "torque",
              relative_control=mode == "relative")
    env_j = jdc.make(obs_type, **kw)
    env_j._step_sim = _set_target_j
    step_j = jax.jit(env_j.step)
    state_j, _ = jax.jit(env_j.reset)(jax.random.PRNGKey(KEY))
    env = port_env(obs_type, **kw)
    env._step_sim = _set_target
    with torch.no_grad():
        state, _ = env.reset()
        for u in ACTIONS:
            state_j, obs_j, r_j, d_j, info_j = step_j(state_j,
                                                      jnp.asarray(u))
            state, obs, r, d, info = env.step(state, torch.tensor(u))
            assert scale_err(state.sim.q, state_j.sim.q) <= 1e-12
            assert scale_err(obs, obs_j) <= 1e-12
            assert abs(float(r) - float(r_j)) <= 1e-12 * max(
                abs(float(r_j)), 1.0)
            assert bool(d) == bool(d_j)
            assert bool(info["success"]) == bool(info_j["success"])


def test_each_reset_reads_its_own_cap():
    """Two episodes with other cap radii and joints: each observation's read
    (the read's route, here its plain version) equals
    ``dynamics.tactile_field`` on that episode's Model, through a plan made
    for it."""
    env = tdc.make(device="cpu", dtype=F64)
    plans = []
    for key in (1, 3):             # radii 0.078 and 0.031
        draws = reset_draws(jax.random.PRNGKey(key))
        env._draw = lambda what, B, d=draws: d
        with torch.no_grad():
            state, obs = env.reset()
        model = env._model_for(state.extras)
        assert float(model.body_size[env._cap_body, 0]) == \
            float(draws["radius"][0])
        q = state.sim.q
        want = dynamics.tactile_field(env.struct, model, q,
                                      torch.zeros_like(q))
        assert scale_err(state.extras.tactile_imgs, env._images(want)) \
            <= 1e-12
        plans.append(tactile_query.read_plan(env.struct, model))
    assert plans[0] is not plans[1]
    assert not torch.equal(plans[0].floats, plans[1].floats)


@pytest.mark.parametrize("flat", [False, True])
def test_make_tactile_matches_jax_script(tmp_path, monkeypatch, flat):
    obj = tmp_path / "tip.obj"
    obj.write_text(
        "v 0.0 0.08 0.0\nv 0.01 0.08 0.0\nv 0.01 0.085 0.01\n"
        "v 0.0 0.075 0.012\nv 0.0 0.0 0.0\nv 0.005 0.09 0.004\n"
        "f 1 2 3\nf 1 3 4\nf 2 6 3\nf 1 5 2\n")
    extra = ["--flat-normal"] if flat else []
    want_path, got_path = tmp_path / "jax.txt", tmp_path / "port.txt"
    monkeypatch.setattr(sys, "argv", ["make_tactile.py", str(obj),
                                      str(want_path)] + extra)
    runpy.run_path("examples/DClawExp/make_tactile.py", run_name="__main__")
    make_tactile.main([str(obj), str(got_path)] + extra)
    want = assets.load_tactile_spec(str(want_path))
    got = assets.load_tactile_spec(str(got_path))
    assert got["pos"].shape == (5, 3)
    for k in ("pos", "image_pos", "normal", "axis0", "axis1"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-15)
    with pytest.raises(SystemExit):
        make_tactile.main([str(obj), str(got_path), "--min-y", "1.0"])


def test_entry_point_runs_on_the_cpu(capsys):
    rewards = dclaw_env.main(["--device", "cpu", "--steps", "1"])
    assert len(rewards) == 1 and np.isfinite(rewards[0])
    assert "step 0: reward=" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dclaw_env.main(["--steps", "1"])
