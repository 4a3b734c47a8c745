"""The port's TactileInsertion env and its lane-major vec env against the
JAX package, float64 on the CPU.

Both sides start from the same settled pose: the JAX env here takes the
port's shipped ``q_init`` (``tests/test_torch_insertion_settle.py`` holds
that file to the JAX env's own settle), so no 1,000-substep settle runs in
this file. JAX's draws come from its keys, split as its env splits them,
and go to the port through ``_draw``.

- the deterministic pieces, on several env options: ``_apply_relative_motion``
  (2- and 3-vectors, grasp height), ``_sample_reset``'s transform (with and
  without domain randomisation and rotation), ``_apply_action`` (relative
  and absolute, translation, rotation and both, clipped at the workspace
  boundaries), ``_outcome`` (both reward types, both success rules, success
  and failure) and ``_obs_from_captured`` (both observation types, 1 and 5
  frames, noise injected, normalised and not), to 1e-12 of scale;
- ``TactileInsertionLanes.vec_step_autoreset`` at B = 2 against JAX's
  (``fused=False``, one compile): one lane steps, one reaches
  ``max_episode_steps`` and takes its reset side; the next state (every
  leaf), obs, reward within 1e-9 of scale, t and the done, bad and
  success flags equal. The two build the chord Jacobian in other modes
  (JAX forward, the port reverse pullbacks): the same J to round-off;
- ``vec_step_autoreset`` at B = 3, which JAX's ``where_last`` cannot
  take: each lane's merge against its own side.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.envs import tactile_insertion as jti
from tactilesimulation_tpu.envs import tactile_insertion_lanes as jtil
from tactilesimulation_tpu_torch.envs import start_pose
from tactilesimulation_tpu_torch.envs import tactile_insertion as tti
from tactilesimulation_tpu_torch.envs import tactile_insertion_lanes as ttil
from tactilesimulation_tpu_torch.model import task_scenes

torch.set_num_threads(1)

F64 = torch.float64
PROTOCOL = dict(observation_type="tactile_map", allow_translation=True,
                allow_rotation=True, num_obs_frames=1,
                domain_randomization=True)      # the protocol's yaml
OPTIONS = {
    "protocol": PROTOCOL,
    "translation": dict(observation_type="tactile_flatten",
                        allow_translation=True, allow_rotation=False,
                        num_obs_frames=5, domain_randomization=False,
                        reward_type="delta"),
    "rotation": dict(observation_type="tactile_map", allow_translation=False,
                     allow_rotation=True, num_obs_frames=2,
                     action_type="absolute", normalize_tactile_obs=False),
}


def shipped_q_init():
    _, model = task_scenes.tactile_insertion()
    key = start_pose.model_key(model.to("cpu", F64))
    with open(tti.Q_INIT_FILE) as fp:
        return np.array(json.load(fp)[key]["q_init"])


@pytest.fixture(scope="module")
def make_pair():
    """make(option) -> (JAX env, port env) from the same start pose."""
    q_init = jnp.asarray(shipped_q_init())
    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jti.TactileInsertionEnv, "_generate_initial_pose",
                   lambda self: q_init)

        def make(option):
            if option not in cache:
                kw = OPTIONS[option]
                cache[option] = (jti.make(**kw),
                                 tti.make(device="cpu", dtype=F64, **kw))
            return cache[option]
        yield make


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def reset_draws(env_j, key):
    """JAX's ``_sample_reset`` draws from ``key`` (its own splits):
    (the port's "reset" dict for one lane, kobs, knext)."""
    kp, kr, kh, kdr, kobs, knext = jax.random.split(key, 6)
    d = {"pos": None, "rot": None}
    if env_j.allow_translation:
        d["pos"] = jax.random.uniform(
            kp, (3,), minval=jnp.asarray([-0.006, -0.006, -0.0002]),
            maxval=jnp.asarray([0.006, 0.006, 0.0002]), dtype=jnp.float64)
    if env_j.allow_rotation:
        d["rot"] = jax.random.uniform(kr, minval=-env_j.max_error[2],
                                      maxval=env_j.max_error[2],
                                      dtype=jnp.float64)
    d["height"] = jax.random.uniform(kh, minval=-0.01, maxval=0.005,
                                     dtype=jnp.float64)
    if env_j.domain_randomization:
        ks = jax.random.split(kdr, 9)
        for i, (name, lo, hi) in enumerate(
                (("ckn", 2e3, 14e3), ("ckt", 20.0, 140.0), ("cmu", 0.5, 2.5),
                 ("tkn", 50.0, 450.0), ("tkt", 0.2, 2.3), ("tmu", 0.5, 2.5),
                 ("tda", 0.0, 100.0),
                 ("grasp",) + tuple(env_j.grasp_force_range))):
            d[name] = jax.random.uniform(ks[i], minval=lo, maxval=hi,
                                         dtype=jnp.float64)
    return d, kobs, knext


def obs_noise(env_j, key):
    shape = (env_j.tactile_samples, 2, jti.ROWS, jti.COLS, 2)
    return np.asarray(jax.random.normal(key, shape, jnp.float64))


def stack_draws(draws):
    """Per-lane "reset" dicts -> one (B, ...) dict of tensors."""
    return {k: (None if draws[0][k] is None
                else torch.tensor(np.stack([np.asarray(d[k])
                                            for d in draws])))
            for k in draws[0]}


def injector(*calls):
    """A ``_draw`` that hands out ``calls`` = ((what, value), ...) in
    order."""
    it = iter(calls)

    def draw(what, B):
        want, value = next(it)
        assert what == want, (what, want)
        return value
    return draw


# ---------------------------------------------------------------------------
# the deterministic pieces
# ---------------------------------------------------------------------------

def test_apply_relative_motion():
    rng = np.random.RandomState(0)
    q = rng.randn(3, 12) * 0.1
    for width in (2, 3):
        rel = rng.randn(3, width) * 0.01
        rot = rng.randn(3) * 0.2
        got = tti.TactileInsertionEnv._apply_relative_motion(
            torch.tensor(q), torch.tensor(rel), torch.tensor(rot),
            torch.tensor([0.0, 0.003, -0.004], dtype=F64))
        for b in range(3):
            want = jti.TactileInsertionEnv._apply_relative_motion(
                jnp.asarray(q[b]), jnp.asarray(rel[b]), jnp.asarray(rot[b]),
                (0.0, 0.003, -0.004)[b])
            assert scale_err(got[b], want) <= 1e-12


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_sample_reset_transform(make_pair, option, monkeypatch):
    env_j, env_t = make_pair(option)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    draws = [reset_draws(env_j, k)[0] for k in keys]
    monkeypatch.setattr(env_t, "_draw", injector(("reset",
                                                  stack_draws(draws))))
    got = env_t._sample_reset(3)
    for b, key in enumerate(keys):
        want = env_j._sample_reset(key)
        for k in ("q_cmd", "grasp_force") + tti.DR_NAMES:
            assert scale_err(got[k][b], want[k]) <= 1e-12, (k, b)
    if env_j.domain_randomization:
        dr = env_t._dr_pairs
        assert len(dr) == 2 and not torch.equal(got["pair_kn"][0, dr],
                                                env_t.model.pair_kn[dr])


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_apply_action(make_pair, option):
    """Random actions beyond +-1 from start poses near the workspace's
    edges, so both clips act."""
    env_j, env_t = make_pair(option)
    rng = np.random.RandomState(1)
    B = 6
    cur = np.tile(np.asarray(env_j.q_init_ref), (B, 1))
    cur[:, 0:2] += rng.uniform(-0.016, 0.016, (B, 2))
    cur[:, 3] += rng.uniform(-0.3, 0.3, B)
    orig = np.tile(np.asarray(env_j.q_init_ref), (B, 1))
    u = rng.uniform(-1.6, 1.6, (B, env_j.action_dim))
    got = env_t._apply_action(torch.tensor(cur), torch.tensor(orig),
                              torch.tensor(u))
    for b in range(B):
        want = env_j._apply_action(jnp.asarray(cur[b]), jnp.asarray(orig[b]),
                                   jnp.asarray(u[b]))
        assert scale_err(got[b], want) <= 1e-12, b


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_outcome(make_pair, option):
    env_j, env_t = make_pair(option)
    rng = np.random.RandomState(2)
    B = 8
    final = np.tile(np.asarray(env_j.q_init_ref), (B, 1))
    final[:, 6:8] = rng.uniform(-0.004, 0.004, (B, 2))
    final[:, 8] = rng.uniform(0.02, 0.03, B)
    q_cmd = final + rng.randn(B, 12) * 0.003
    prev = rng.randn(B, 3) * 0.004
    got = env_t._outcome(*map(torch.tensor, (final, q_cmd, prev)))
    flags = [set(), set()]
    for b in range(B):
        want = env_j._outcome(jnp.asarray(final[b]), jnp.asarray(q_cmd[b]),
                              jnp.asarray(prev[b]))
        assert bool(got[0][b]) == bool(want[0])
        assert bool(got[3][b]) == bool(want[3])
        flags[0].add(bool(want[0]))
        flags[1].add(bool(want[3]))
        for i in (1, 2):
            assert scale_err(got[i][b], want[i]) <= 1e-12, (i, b)
    assert flags == [{False, True}, {False, True}]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_obs_from_captured(make_pair, option):
    env_j, env_t = make_pair(option)
    rng = np.random.RandomState(5)
    B, S = 2, env_j.tactile_samples
    M = len(env_t.struct.tac_joint)
    cap = rng.randn(B, S + 1, M, 3) * 1e-3
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    noise = np.stack([obs_noise(env_j, k) for k in keys])
    got = env_t._obs_from_captured(torch.tensor(cap), torch.tensor(noise))
    assert got.shape == (B,) + env_t.obs_size()
    for b in range(B):
        want = env_j._obs_from_captured(jnp.asarray(cap[b]), keys[b])
        assert tuple(want.shape) == env_t.obs_size()
        assert scale_err(got[b], want) <= 1e-12, b


# ---------------------------------------------------------------------------
# the lane-major vec env
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lane_case(make_pair):
    """The protocol env's lane step at B = 2 in JAX (fused=False): a state
    from ``_sample_reset`` (lane 1 one step short of the limit), and the
    draws each side takes."""
    env_j, env_t = make_pair("protocol")
    B = 2
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    rkeys = jax.random.split(jax.random.PRNGKey(12), B)
    s = jax.vmap(env_j._sample_reset)(keys)
    st_j = jtil.LaneInsertionState(
        current_q_init=s["q_cmd"].T, original_q_init=s["q_cmd"].T,
        prev_object_pose=jnp.stack([s["q_cmd"][:, 0], s["q_cmd"][:, 1],
                                    s["q_cmd"][:, 3]]),
        **{k: s[k].T for k in tti.DR_NAMES}, grasp_force=s["grasp_force"],
        key=s["knext"])
    t = np.array([0, env_j.max_episode_steps - 1], np.int32)
    # both lanes move 15 mm off the hole (its clearance is 2.25 mm): they
    # land on the wall and fail, lane 0 goes on, lane 1 is cut by the limit
    action = np.array([[1.0, -1.0, 0.5], [-1.0, 1.0, -0.3]])
    lenv_j = jtil.TactileInsertionLanes(env_j, fused=False)
    out_j = jax.jit(lenv_j.vec_step_autoreset)(
        st_j, jnp.zeros((B,) + env_j.obs_size()), jnp.asarray(t),
        jnp.asarray(action), rkeys)
    # the draws: the reset side's from rkeys, then the obs noise of the
    # step side (each lane's key split) and of the reset side
    r = [reset_draws(env_j, k) for k in rkeys]
    kobs_step = [jax.random.split(k)[0] for k in s["knext"]]
    noise = np.stack([obs_noise(env_j, k) for k in kobs_step]
                     + [obs_noise(env_j, d[1]) for d in r])
    draws = (("reset", stack_draws([d[0] for d in r])),
             ("obs_noise", torch.tensor(noise)))
    st_t = ttil.LaneInsertionState(**{
        f: torch.tensor(np.asarray(getattr(st_j, f)))
        for f in ttil.LaneInsertionState.__dataclass_fields__})
    return dict(env_t=env_t, st_t=st_t, t=t, action=action, draws=draws,
                out_j=jax.tree.map(np.asarray, out_j))


def test_vec_step_autoreset_matches_jax(lane_case, monkeypatch):
    c = lane_case
    env_t = c["env_t"]
    lenv = ttil.TactileInsertionLanes(env_t)
    assert lenv.pair_wrenches is None            # the CPU's plain contact
    monkeypatch.setattr(env_t, "_draw", injector(*c["draws"]))
    B = 2
    out_t = lenv.vec_step_autoreset(
        c["st_t"], torch.zeros((B,) + env_t.obs_size(), dtype=F64),
        torch.tensor(c["t"]), torch.tensor(c["action"]))
    st_j, obs_j, t_j, r_j, done_j, bad_j, succ_j = c["out_j"]
    st_t, obs_t, t_t, r_t, done_t, bad_t, succ_t = out_t
    assert np.array_equal(t_t.numpy(), t_j)
    for got, want in ((done_t, done_j), (bad_t, bad_j), (succ_t, succ_j)):
        assert np.array_equal(got.numpy(), want)
    assert list(done_j) == [False, True] and list(bad_j) == [False, True]
    assert not succ_j.any()
    assert scale_err(r_t, r_j) <= 1e-9
    assert scale_err(obs_t, obs_j) <= 1e-9
    assert float(np.abs(obs_j).max()) > 0
    for f in ttil.LaneInsertionState.__dataclass_fields__:
        assert scale_err(getattr(st_t, f), getattr(st_j, f)) <= 1e-9, f


def test_vec_step_merges_each_lane_at_any_width(make_pair):
    """B = 3 (JAX's ``where_last`` fails for B != 2): lanes 0 and 2 end
    (time limit), lane 1 steps; the ended lanes carry the reset side's
    state and observation. The script is checked above; here it is
    replaced by a stub that tags each lane."""
    _, env_t = make_pair("protocol")
    lenv = ttil.TactileInsertionLanes(env_t)
    B = 3
    s = env_t._sample_reset(B)
    st = ttil.LaneInsertionState(
        current_q_init=s["q_cmd"].T, original_q_init=s["q_cmd"].T,
        prev_object_pose=ttil._pose(s["q_cmd"].T),
        **{k: s[k].T for k in tti.DR_NAMES}, grasp_force=s["grasp_force"])

    def fake_execute(model, q_cmd, grasp, noise):
        lanes = torch.arange(q_cmd.shape[1], dtype=F64)
        obs = lanes.reshape(-1, 1, 1, 1).expand((-1,) + env_t.obs_size())
        final = q_cmd.clone()
        final[8] = 0.05                  # the box stays above the hole
        return final, obs.clone()
    lenv._lane_execute = fake_execute
    t = torch.tensor([env_t.max_episode_steps - 1, 0,
                      env_t.max_episode_steps - 1])
    new, obs, t2, _, done, bad, _ = lenv.vec_step_autoreset(
        st, torch.zeros((B,) + env_t.obs_size(), dtype=F64), t,
        torch.zeros((B, 3), dtype=F64))
    assert done.tolist() == [True, False, True] and bad.equal(done)
    assert t2.tolist() == [0, 1, 0]
    # obs: the stub tags lane i of the 2B-lane execution with i
    assert [float(obs[i].mean()) for i in range(B)] == [3.0, 1.0, 5.0]
    assert torch.equal(new.pair_kn[:, 1], st.pair_kn[:, 1])
    for i in (0, 2):
        assert not torch.equal(new.pair_kn[:, i], st.pair_kn[:, i])
        assert torch.equal(new.current_q_init[:, i],
                           new.original_q_init[:, i])
    q_step = env_t._apply_action(st.current_q_init.T, st.original_q_init.T,
                                 torch.zeros((B, 3), dtype=F64)).T
    assert torch.equal(new.current_q_init[:, 1], q_step[:, 1])
    assert torch.equal(new.original_q_init[:, 1], st.original_q_init[:, 1])
