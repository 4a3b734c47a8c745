"""The port's TactileInsertion start pose and single-instance script against
the JAX package, float64 on the CPU.

- ``settle`` on a cut schedule, ramps of (5, 5, 5) substeps and a hold of
  15, against JAX's ``integrators.build_step`` driven through the same
  stages (one jitted scan of 15 steps serves both parts): q within 1e-9 of
  scale;
- the shipped start poses (``envs/data/insertion_q_init.json``): the
  float64 model's against the JAX env's own ``q_init_ref`` (its
  1,000-substep settle, or its disk cache) within 1e-8 of scale; the
  float32 model's within 1e-5 of scale of it (float32 settles parted from
  float64 by 2.8e-6 of scale when the file was made);
- ``reset`` of the single-instance env (the protocol's options) with JAX's
  draws: the 45-substep script on the single-instance core, the field read
  at the capture substeps by the read's plain version on the CPU, and the
  observation, against JAX's jitted step and ``dynamics.tactile_field``
  driven through the same controls (JAX's scan over the script, whose
  compile takes tens of minutes cold, is not used): the final q within
  1e-10 of scale, the observation (a difference of two fields, rescaled)
  within 1e-8, the start pose and grasp force within 1e-12;
- the whole settle of the port against the shipped file (marked ``slow``:
  about 10 minutes on one CPU core).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.envs import tactile_insertion as jti
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import dynamics as jax_dynamics
from tactilesimulation_tpu.sim import integrators as jax_integrators
from tactilesimulation_tpu_torch.envs import start_pose
from tactilesimulation_tpu_torch.envs import tactile_insertion as tti
from tactilesimulation_tpu_torch.model import task_scenes

torch.set_num_threads(1)

F64 = torch.float64
PROTOCOL = dict(observation_type="tactile_map", allow_translation=True,
                allow_rotation=True, num_obs_frames=1,
                domain_randomization=True)
CUT = ((5, 5, 5), 15)


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def shipped():
    """{dtype name: q_init} of the bundled scene's models."""
    _, model = task_scenes.tactile_insertion()
    with open(tti.Q_INIT_FILE) as fp:
        entries = json.load(fp)
    out = {}
    for dtype in (torch.float64, torch.float32):
        entry = entries[start_pose.model_key(model.to("cpu", dtype))]
        out[entry["dtype"]] = np.array(entry["q_init"])
    return out


@pytest.fixture(scope="module")
def jax_run():
    """run(model, state, us (L, 6)) -> (last state, (q, qdot) after each
    control): the JAX single-instance step in one jitted scan (L = 15
    throughout, one compile)."""
    struct, _ = jax_scenes.tactile_insertion()
    step = jax_integrators.build_step(struct)

    def body(model, s, u):
        s = step(model, s, u)
        return s, (s.q, s.qdot)

    return jax.jit(lambda model, state, us: jax.lax.scan(
        lambda s, u: body(model, s, u), state, us))


def jax_settle(run, struct, model, stages, hold):
    """``TactileInsertionEnv._generate_initial_pose_uncached`` with other
    stage lengths, each part through ``run`` in pieces of 15 controls."""
    q = np.asarray(model.q_init).copy()
    grasp_height = 0.2
    q[2] = grasp_height
    q[4] = q[5] = -0.03
    state = jax_integrators.initial_state(struct, model).replace(
        q=jnp.asarray(q), q_prev=jnp.asarray(q))
    stage_q = [np.array([q[0], q[1], q[2], q[3], 0.0, 0.0]),
               np.array([0.0, 0.0, grasp_height, 0.0, 0.0, 0.0]),
               np.array([0.0, 0.0, grasp_height, 0.0, 1.0, 1.0]),
               np.array([0.0, 0.0, grasp_height, 0.0, 1.0, 1.0])]
    us = []
    for stage, n in enumerate(stages):
        frac = (np.arange(1, n + 1) / n)[:, None]
        us.append(stage_q[stage][None]
                  + frac * (stage_q[stage + 1] - stage_q[stage])[None])
    us = np.concatenate(us)
    assert len(us) == 15 and hold == 15
    state, _ = run(model, state, jnp.asarray(us))
    q1 = np.asarray(state.q).copy()
    q1[2] += 0.026 + 0.003
    q1[8] += 0.026 + 0.003
    state = jax_integrators.initial_state(struct, model).replace(
        q=jnp.asarray(q1), q_prev=jnp.asarray(q1))
    u_hold = np.asarray(q1[:6]).copy()
    u_hold[4:6] = 1.0
    state, _ = run(model, state, jnp.asarray(np.tile(u_hold, (15, 1))))
    return np.asarray(state.q)


def test_settle_cut_schedule_matches_jax(jax_run):
    struct_j, model_j = jax_scenes.tactile_insertion()
    want = jax_settle(jax_run, struct_j, model_j, *CUT)
    struct, model = task_scenes.tactile_insertion()
    got = tti.settle(struct, model.to("cpu", F64), stages=CUT[0],
                     hold=CUT[1])
    assert scale_err(got, want) <= 1e-9
    # the cut settle still grasps: the fingers closed on the box
    assert abs(float(got[4]) + 0.03) > 1e-3


@pytest.fixture(scope="module")
def jenv():
    """The JAX env with its own settle (or its disk cache)."""
    return jti.make(**PROTOCOL)


def test_shipped_q_init_matches_jax(jenv):
    q = shipped()
    want = np.asarray(jenv.q_init_ref)
    assert scale_err(q["float64"], want) <= 1e-8
    assert scale_err(q["float32"], want) <= 1e-5


def test_single_instance_reset_matches_jax(jenv, jax_run, monkeypatch):
    env_t = tti.make(device="cpu", dtype=F64, **PROTOCOL)
    key = jax.random.PRNGKey(21)
    s = jenv._sample_reset(key)
    # JAX's draws from its key, as its _sample_reset splits it
    kp, kr, kh, kdr, kobs, _ = jax.random.split(key, 6)
    ks = jax.random.split(kdr, 9)
    f64 = jnp.float64
    u = lambda k, lo, hi: np.asarray(jax.random.uniform(
        k, minval=lo, maxval=hi, dtype=f64))
    draws = {"pos": np.asarray(jax.random.uniform(
        kp, (3,), minval=jnp.asarray([-0.006, -0.006, -0.0002]),
        maxval=jnp.asarray([0.006, 0.006, 0.0002]), dtype=f64)),
        "rot": u(kr, -jenv.max_error[2], jenv.max_error[2]),
        "height": u(kh, -0.01, 0.005)}
    for i, (name, lo, hi) in enumerate(
            (("ckn", 2e3, 14e3), ("ckt", 20.0, 140.0), ("cmu", 0.5, 2.5),
             ("tkn", 50.0, 450.0), ("tkt", 0.2, 2.3), ("tmu", 0.5, 2.5),
             ("tda", 0.0, 100.0), ("grasp",) + jenv.grasp_force_range)):
        draws[name] = u(ks[i], lo, hi)
    noise = np.asarray(jax.random.normal(
        kobs, (1, 2, jti.ROWS, jti.COLS, 2), f64))
    calls = iter([{k: torch.tensor(v)[None] for k, v in draws.items()},
                  torch.tensor(noise)[None]])
    monkeypatch.setattr(env_t, "_draw", lambda what, B: next(calls))
    finals = []
    execute = env_t._execute

    def recording(*args):
        final_q, obs = execute(*args)
        finals.append(final_q)
        return final_q, obs
    monkeypatch.setattr(env_t, "_execute", recording)
    state, obs = env_t.reset()

    # JAX: the script's controls (TactileInsertionEnv._execute), its step
    # and the field at the capture substeps
    model = jenv.model.replace(**{k: s[k] for k in tti.DR_NAMES})
    q_cmd = s["q_cmd"]
    init_jp = q_cmd[:6]
    target = init_jp.at[2].add(-0.0011)
    frac = (jnp.arange(1, jti.EXEC_STEPS + 1, dtype=f64)
            / jti.EXEC_STEPS)[:, None]
    us = init_jp[None] + frac * (target - init_jp)[None]
    us = us.at[:, 2].add(0.003)
    us = us.at[:, 4].set(s["grasp_force"]).at[:, 5].set(s["grasp_force"])
    sim = jax_integrators.initial_state(jenv.struct, model).replace(
        q=q_cmd, q_prev=q_cmd)
    field = jax.jit(lambda m, q, v: jax_dynamics.tactile_field(
        jenv.struct, m, q, v))
    qs, vs = [], []
    for part in range(jti.EXEC_STEPS // 15):
        sim, (q, v) = jax_run(model, sim, us[15 * part:15 * part + 15])
        qs.append(q)
        vs.append(v)
    qs, vs = jnp.concatenate(qs), jnp.concatenate(vs)
    caps = {f: field(model, qs[f], vs[f]) for f in jenv.capture_frames}
    captured = jnp.stack([caps[f] for f in jenv.capture_frames])
    want_obs = jenv._obs_from_captured(captured, kobs)
    assert scale_err(finals[0], sim.q) <= 1e-10
    # the observation is a difference of two fields (substep 44 less
    # substep 6), each a force of order 1e-3 N from sub-micron depths,
    # rescaled to 30: the solves' round-off and the start poses' 1.5e-13
    # part it from JAX by 1.5e-9 of scale
    assert scale_err(obs, want_obs) <= 1e-8
    assert float(jnp.abs(captured[-1]).max()) > 0, "no marker in contact"
    assert scale_err(state.extras.current_q_init, s["q_cmd"]) <= 1e-12
    assert scale_err(state.extras.grasp_force, s["grasp_force"]) <= 1e-12


@pytest.mark.slow
def test_full_settle_matches_shipped():
    struct, model = task_scenes.tactile_insertion()
    got = tti.settle(struct, model.to("cpu", F64))
    assert scale_err(got, shipped()["float64"]) <= 1e-10
