"""The port's StableGrasp env against the JAX package, float64 on the CPU.

Both sides start from the same settled pose: the JAX env here takes the
port's shipped ``q_init`` (``tests/test_torch_stable_grasp_settle.py``
holds that file to the JAX env's own settle), so no 500-substep settle runs
in this file. JAX's draws come from its keys, split as its env splits them,
and go to the port through ``_draw``.

- the density transform (``densities``) against JAX's
  ``_sample_densities`` on keys that take both sides of the torque balance
  and COM blocks from 1 to 9, within 1e-12 of scale;
- ``reset`` and one ``step`` on a shortened schedule (``SHORT``: 20
  substeps, the capture at the first substep of the lift, where the pads
  hold the bar) against JAX's, whose script (``_grasp``: one scan) is
  jitted once for both: the final pose, the captured field (rows in
  contact), the observation in both types, the episode's masses, reward,
  success and grasp position within 1e-9 of scale;
- the read's route: the read kernel's query under ``no_grad``, once per
  script and with the read plan of the bundled Model (the episode's Model
  edits only masses), ``dynamics.tactile_field`` under grad;
- the start-pose cache for a model that ships no pose;
- the random-action entry point on the CPU, on the shortened schedule.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.envs import stable_grasp as jsg
from tactilesimulation_tpu_torch.envs import stable_grasp as tsg
from tactilesimulation_tpu_torch.envs import start_pose
from tactilesimulation_tpu_torch.examples import stable_grasp_env
from tactilesimulation_tpu_torch.model import task_scenes
from tactilesimulation_tpu_torch.ops import tactile_query
from tactilesimulation_tpu_torch.sim import dynamics

torch.set_num_threads(1)

F64 = torch.float64
SHORT = [2, 12, 2, 1, 1, 1, 1]
CAPTURE = 15
KEY = 3
ACTION = 0.5
# com_y of these keys: both sides of mid_left_ratio 0.5, num_left 1 to 9
DENSITY_KEYS = (0, 1, 2, 3, 5, 8, 13, 21)


def scale_err(got, want):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def shipped_q(dtype=F64):
    _, model = task_scenes.stable_grasp()
    with open(tsg.Q_INIT_FILE) as fp:
        entry = json.load(fp)[start_pose.model_key(model.to("cpu", dtype))]
    return np.array(entry["q_init"])


def density_draws(key):
    """JAX's ``_sample_densities`` draws from ``key`` as the port's "reset"
    dict (B = 1)."""
    k = jax.random.split(key, 5)
    f64 = jnp.float64
    u = lambda k, lo, hi, shape=(): jax.random.uniform(
        k, shape, minval=lo, maxval=hi, dtype=f64)
    com_y = u(k[0], 1.0, jsg.NUM_BLOCKS - 1.0)
    num_left = jnp.floor(com_y)
    num_right = jsg.NUM_BLOCKS - 1 - num_left
    d = {"com_y": com_y, "mid": u(k[1], 600.0, 700.0),
         "right": u(k[2], 600.0 * num_right, 700.0 * num_right),
         "left": u(k[3], 600.0 * num_left, 700.0 * num_left),
         "ratios": jax.random.uniform(k[4], (jsg.NUM_BLOCKS,), dtype=f64)}
    return {k: torch.tensor(np.asarray(v))[None] for k, v in d.items()}


def _dtype_only():
    """The JAX env as ``_sample_densities`` sees it (its model's dtype)."""
    import types
    return types.SimpleNamespace(model=types.SimpleNamespace(
        q_init=jnp.zeros(1, jnp.float64)))


@pytest.mark.parametrize("key", DENSITY_KEYS)
def test_densities_match_jax(key):
    key = jax.random.PRNGKey(key)
    want = np.asarray(jsg.StableGraspEnv._sample_densities(_dtype_only(),
                                                           key))
    got = tsg.densities(density_draws(key))[0]
    assert got.shape == (tsg.NUM_BLOCKS,)
    assert scale_err(got, want) <= 1e-12
    assert 3000.0 - 1e-9 <= float(got.sum()) <= 7000.0 + 1e-9


def test_density_draws_cover_both_balances():
    ratios = [float(density_draws(jax.random.PRNGKey(k))["com_y"][0]) % 1.0
              for k in DENSITY_KEYS]
    assert min(ratios) < 0.5 < max(ratios)


@pytest.fixture(scope="module")
def short_run():
    """JAX's and the port's reset and one step on SHORT, with the captured
    fields of both scripts."""
    q = jnp.asarray(shipped_q())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsg.StableGraspEnv, "_generate_initial_state",
                   lambda self: (q, jnp.zeros_like(q)))
        env_j = jsg.make("tactile_map")
        env = tsg.make(device="cpu", dtype=F64)
        for mod in (jsg, tsg):
            mp.setattr(mod, "STAGE_STEPS", SHORT)
            mp.setattr(mod, "CAPTURE_FRAME", CAPTURE)
        grasp = jax.jit(env_j._grasp)
        mp.setattr(env_j, "_grasp", grasp)
        key = jax.random.PRNGKey(KEY)
        state_j, obs_j = env_j.reset(key)
        out_j = env_j.step(state_j, jnp.asarray([ACTION]))
        model_j = env_j._model_for(state_j.extras)
        caps_j = [grasp(model_j, env_j.q_init_ref,
                        state_j.extras.grasp_position)[1],
                  grasp(model_j, state_j.extras.current_q,
                        out_j[0].extras.grasp_position)[1]]

        draws = density_draws(jax.random.split(key)[0])
        env._draw = lambda what, B: draws
        with torch.no_grad():
            state, obs = env.reset()
            out = env.step(state, torch.tensor([ACTION], dtype=F64))
    return dict(env_j=env_j, env=env, state_j=state_j, obs_j=obs_j,
                out_j=out_j, caps_j=caps_j, state=state, obs=obs, out=out)


def test_reset_matches_jax(short_run):
    r = short_run
    ex, ex_j = r["state"].extras, r["state_j"].extras
    assert scale_err(ex.body_mass, ex_j.body_mass) <= 1e-12
    assert scale_err(ex.body_inertia, ex_j.body_inertia) <= 1e-12
    assert scale_err(ex.current_q, ex_j.current_q) <= 1e-9
    assert scale_err(ex.cap_field, r["caps_j"][0]) <= 1e-9
    assert r["obs"].shape == (4, tsg.TACTILE_ROWS, tsg.TACTILE_COLS)
    assert scale_err(r["obs"], r["obs_j"]) <= 1e-9
    assert int((ex.cap_field.abs().sum(dim=1) > 0).sum()) > 0


def test_step_matches_jax(short_run):
    r = short_run
    state, obs, reward, done, info = r["out"]
    state_j, obs_j, reward_j, done_j, info_j = r["out_j"]
    ex, ex_j = state.extras, state_j.extras
    assert float(ex.grasp_position) == pytest.approx(
        float(ex_j.grasp_position), abs=1e-15)
    assert float(ex.grasp_position) == pytest.approx(ACTION * 0.05)
    assert scale_err(ex.current_q, ex_j.current_q) <= 1e-9
    assert scale_err(ex.cap_field, r["caps_j"][1]) <= 1e-9
    assert int((ex.cap_field.abs().sum(dim=1) > 0).sum()) > 0
    assert scale_err(obs, obs_j) <= 1e-9
    assert abs(float(reward) - float(reward_j)) <= 1e-9 * max(
        abs(float(reward_j)), 1.0)
    assert bool(done) == bool(done_j) == bool(info["success"]) == \
        bool(info_j["success"])
    assert int(state.t) == 1


@pytest.mark.parametrize("obs_type", tsg.OBS_TYPES)
def test_observation_types_match_jax(short_run, obs_type):
    r = short_run
    env, env_j = copy.copy(r["env"]), copy.copy(r["env_j"])
    env.observation_type = env_j.observation_type = obs_type
    for cap, cap_j in ((r["state"].extras.cap_field, r["caps_j"][0]),
                       (r["out"][0].extras.cap_field, r["caps_j"][1])):
        got = env._obs_from_tactile(cap)
        want = env_j._obs_from_tactile(cap_j)
        assert got.shape == want.shape == env.obs_size() == env_j.obs_size()
        assert scale_err(got, want) <= 1e-9


def test_read_route(monkeypatch):
    """No grad: the read kernel's query, once per script, on the read plan
    of the bundled Model; under grad: the differentiable field."""
    calls = []
    query = tactile_query.tactile_field

    def counted(struct, model, q, v):
        calls.append(model)
        return query(struct, model, q, v)

    monkeypatch.setattr(tactile_query, "tactile_field", counted)
    monkeypatch.setattr(tsg, "STAGE_STEPS", [1, 1, 1, 0, 0, 0, 0])
    monkeypatch.setattr(tsg, "CAPTURE_FRAME", 1)
    env = tsg.make(device="cpu", dtype=F64)
    with torch.no_grad():
        state, obs = env.reset()
    assert len(calls) == 1 and not obs.requires_grad
    model = calls[0]
    assert model is not env.model
    assert not torch.equal(model.body_mass, env.model.body_mass)
    assert tactile_query.read_plan(env.struct, model) is \
        tactile_query.read_plan(env.struct, env.model)
    q = state.extras.cap_q.clone().requires_grad_()
    field = env._field(model, q, torch.zeros_like(q))
    assert len(calls) == 1 and field.requires_grad
    want = dynamics.tactile_field(env.struct, model, q.detach(),
                                  torch.zeros_like(q))
    assert scale_err(field, want) == 0.0


def test_start_pose_cache(tmp_path, monkeypatch):
    """A model that ships no pose settles once and reads the cache after."""
    monkeypatch.setattr(start_pose, "CACHE_DIR", str(tmp_path))
    struct, model = task_scenes.stable_grasp()
    model = model.to("cpu", F64)
    model = dataclasses.replace(model, q_init=model.q_init + 1e-3)
    settled = []

    def settle(struct, model, step_sim=None):
        settled.append(1)
        return model.q_init + 1.0

    monkeypatch.setattr(tsg, "settle", settle)
    first = tsg.initial_pose(struct, model)
    again = tsg.initial_pose(struct, model)
    assert len(settled) == 1 and torch.equal(first, again)
    assert len(list(tmp_path.glob("stable_grasp_qinit_*.npy"))) == 1
    # the bundled model's pose ships: no settle
    _, bundled = task_scenes.stable_grasp()
    shipped = tsg.initial_pose(struct, bundled.to("cpu", F64))
    assert len(settled) == 1
    assert scale_err(shipped, shipped_q()) == 0.0


def test_entry_point_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(tsg, "STAGE_STEPS", [1, 1, 1, 0, 0, 0, 0])
    monkeypatch.setattr(tsg, "CAPTURE_FRAME", 1)
    rewards = stable_grasp_env.main(["--device", "cpu", "--steps", "1"])
    assert len(rewards) == 1 and np.isfinite(rewards[0])
    assert "step 0: reward=" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stable_grasp_env.main(["--steps", "1"])
