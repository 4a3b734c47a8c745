"""The port's fused env step (``ops/megastep.py``, K2/K3) on the CPU, f64.

- the packed scene tables against the JAX package's ``megastep._SceneConst``
  (point table, contact parameters, ancestor mask, segments);
- the plain residual and momentum (the port's ``sim/lanes.py``, which K2's
  plain version evaluates) against ``_SceneConst.residual`` / ``momentum``
  at rtol 1e-9, as tests/test_megastep.py::test_residual_parity;
- the residual's derivative in the megastep's contact-torque convention
  (``moving_point``) against ``_SceneConst.residual``'s JVP at a pad-on-box
  state, rtol 1e-9; the lanes convention parts from it there;
- the megastep ``autograd.Function`` through its CPU route (the plain
  version) against the port's lanes env step in the same convention: values
  to rtol 1e-6, because the two stop the chord at different floors
  (megastep max(solver_tol, 1e-7) in every dtype, lanes max(solver_tol,
  1e-12) = solver_tol = 1e-8 in f64; both also stop at 1e-7 |r0|), and
  gradients w.r.t. (q0, qd0, u) to rtol 2e-6, as tests/test_megastep.py
  pins the JAX pair. The loss reads q_prev and qdot_prev too;
- the step refuses a model other than the one it was built with;
- the kernels' own source (csrc/megastep.cu, its lane routines built as
  host C++ in float64 by ``megastep_host.py``, the team dealing tasks as a
  warp does) against the plain version on contact states where the chord
  does and does not converge: K2 to 1e-9 and K3 to 1e-7 of scale, the same
  bars as on the card (the same algorithm in another summation order); and
  the team at widths 1, 7 and 32, equal bit for bit;
- the structure the operation count of K2/K3's bound assumes
  (``megastep_host.py``: how many Lagrangians and residuals each sweeping
  function of the CUDA source runs), so that the count cannot go stale, and
  the needed units themselves at ``python megastep_host.py``'s inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megastep_host
from chip_smoke import contact_state, resting_contact
from tactilesimulation_tpu.envs import tactile_push as jax_tp
from tactilesimulation_tpu.ops import megastep as jax_mega
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import megastep
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes

torch.set_num_threads(1)

B = 3


@pytest.fixture(scope="module")
def scene():
    env = jax_tp.make("no_tactile")
    sj, mj = env.struct, env.model
    st, mt = torch_scenes.tactile_push()
    return dict(sj=sj, mj=mj, st=st, mt=mt,
                sc=jax_mega._SceneConst(sj, mj),
                tables=megastep.SceneTables(st, mt))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def _resting_contact(mt, seed):
    """The pad pressed into the box and moving slowly, the box pressed into
    the ground: contact active in every lane, and the chord converges from
    the entry factor; controls drawn beside."""
    q, v = resting_contact(mt.q_init.numpy(), B, seed, pad_speed=0.002)
    return q, v, 0.3 * np.random.RandomState(seed + 1).randn(6, B)


def test_scene_tables_match_jax(scene):
    sc, tb = scene["sc"], scene["tables"]
    assert megastep.supported(scene["st"], scene["mt"])
    np.testing.assert_array_equal(tb.xi, sc.xi)
    np.testing.assert_allclose(tb.params, sc.params, rtol=1e-15)
    np.testing.assert_array_equal(tb.anc, sc.anc)
    assert [dataclasses.asdict(s) for s in tb.segments] == \
        [dataclasses.asdict(s) for s in sc.segments]
    for name in ("trans_idx", "rot_idx", "basis", "body_joint", "motor_dof"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(sc, name))
    np.testing.assert_array_equal(tb.mflags[:, 0], sc.m_rev.reshape(-1))
    np.testing.assert_array_equal(tb.parents, sc.parents)
    assert tb.h == sc.h
    # the packed float table holds the points in segment order
    ints, floats = tb.packed("cpu", torch.float64)
    npts = int(ints[6])
    np.testing.assert_array_equal(floats[-3 * npts:].numpy(),
                                  tb.xi[tb.packed_rows].ravel())


def test_plain_residual_and_momentum_match_scene_const(scene):
    sc, st, mt = scene["sc"], scene["st"], scene["mt"]
    rng = np.random.RandomState(0)
    q = mt.q_init.numpy()[:, None] + 0.01 * rng.randn(st.ndof_q, B)
    q[1] = rng.uniform(0.0005, 0.003, B)
    v = 0.1 * rng.randn(st.ndof_q, B)
    u = 0.3 * rng.randn(st.ndof_u, B)
    p_base = torch_lanes.momentum(st, mt, _t(q), _t(v))
    _close(p_base, sc.momentum(jnp.asarray(q), jnp.asarray(v)), 1e-9)
    inputs = torch_lanes.StepInputs(model=mt, u=_t(u), q_base=_t(q),
                                    p_base=p_base, gamma=mt.h.reshape(1, 1))
    r_t = torch_lanes.make_residual(st)(_t(v), inputs)
    r_j = sc.residual(jnp.asarray(v), jnp.asarray(u), jnp.asarray(q),
                      jnp.asarray(p_base.numpy()))
    _close(r_t, r_j, 1e-9)


def test_moving_point_residual_matches_jax_megastep(scene):
    sc, st, mt = scene["sc"], scene["st"], scene["mt"]
    q, v, u = _resting_contact(mt, 4)
    rng = np.random.RandomState(2)
    dv, dq = rng.randn(*v.shape), rng.randn(*q.shape)
    p_base = torch_lanes.momentum(st, mt, _t(q), _t(v)).numpy()
    _, want = jax.jvp(
        lambda vv, qq: sc.residual(vv, jnp.asarray(u), qq,
                                   jnp.asarray(p_base)),
        (jnp.asarray(v), jnp.asarray(q)), (jnp.asarray(dv), jnp.asarray(dq)))
    got = {}
    for moving_point in (True, False):
        vv, qq = _t(v).requires_grad_(), _t(q).requires_grad_()
        r = torch_lanes.make_residual(st, moving_point=moving_point)(
            vv, torch_lanes.StepInputs(model=mt, u=_t(u), q_base=qq,
                                       p_base=_t(p_base),
                                       gamma=mt.h.reshape(1, 1)))
        rows = []
        for i in range(st.ndof_q):
            gv, gq = torch.autograd.grad(r[i].sum(), (vv, qq),
                                         retain_graph=True)
            rows.append((gv * _t(dv) + gq * _t(dq)).sum(0))
        got[moving_point] = torch.stack(rows)
    _close(got[True], want, 1e-9)
    # the state exercises the pad-box torque, where the conventions part
    assert float((got[False] - got[True]).abs().max()) > \
        1e-6 * float(np.abs(want).max())


def test_mega_step_matches_lanes_step(scene):
    st, mt = scene["st"], scene["mt"]
    q, v, u = (_t(a) for a in _resting_contact(mt, 4))
    mega = megastep.build_env_step_mega(st, mt, 5, max_iter=8)
    ref = torch_lanes.build_env_step(st, 5, max_iter=8, moving_point=True)
    w = [_t(a) for a in np.random.RandomState(9).randn(4, *q.shape)]

    def run(step):
        xs = [x.clone().requires_grad_() for x in (q, v, u)]
        s = step(mt, torch_lanes.LaneSimState(
            q=xs[0], qdot=xs[1], q_prev=xs[0], qdot_prev=xs[1],
            t=torch.zeros(B, dtype=torch.int32)), xs[2])
        loss = sum(torch.sum(wi * x) for wi, x in
                   zip(w, (s.q, s.qdot, s.q_prev, s.qdot_prev)))
        return s, torch.autograd.grad(loss, xs)

    s_m, g_m = run(mega)
    s_l, g_l = run(ref)
    for a, b in zip(s_m[:4], s_l[:4]):
        _close(a, b.detach().numpy(), 1e-6)
    np.testing.assert_array_equal(s_m.t.numpy(), s_l.t.numpy())
    for a, b in zip(g_m, g_l):
        _close(a, b.numpy(), 2e-6)
    # the CPU route ran the plain version: no kernel launch
    assert (mega.op.fwd_launches, mega.op.bwd_launches) == (0, 0)


def test_mega_step_refuses_another_model(scene):
    st, mt = scene["st"], scene["mt"]
    step = megastep.build_env_step_mega(st, mt, 5)
    q = mt.q_init[:, None].repeat(1, 2)
    state = torch_lanes.LaneSimState(q=q, qdot=torch.zeros_like(q), q_prev=q,
                                     qdot_prev=torch.zeros_like(q),
                                     t=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="another model"):
        step(mt.to("cpu", torch.float64), state, torch.zeros(6, 2,
                                                             dtype=q.dtype))


@pytest.fixture(scope="module")
def host(scene):
    """The kernels' lane routines built as host C++ (one g++ build)."""
    if not megastep_host.available():
        pytest.skip("needs g++ to build the kernels' device code as host C++")
    op = megastep.MegaStep(scene["st"], scene["mt"], 5, 8)
    return megastep_host.HostMegastep(op)


@pytest.fixture(scope="module")
def counter():
    """The counting build of the kernels' source (one g++ build)."""
    if not megastep_host.available():
        pytest.skip("needs g++ to build the kernels' device code as host C++")
    return megastep_host.Counter()


def _host_case(mt):
    """Violent and resting contact, a control on its clip bound, and four
    cotangents: (q, v, u) and g, float64 tensors of 2 B lanes."""
    rng = np.random.RandomState(6)
    q, v = contact_state("tactile_push", mt.q_init.numpy(), B, seed=1)
    rq, rv, ru = _resting_contact(mt, 4)
    q = np.concatenate([q, rq], axis=1)
    v = np.concatenate([v, rv], axis=1)
    u = np.concatenate([0.5 * rng.randn(6, B), ru], axis=1)
    u[0, 0] = 1.0
    q, v, u = (_t(a) for a in (q, v, u))
    return (q, v, u), [_t(rng.randn(*q.shape)) for _ in range(4)]


def test_kernel_source_matches_plain_version_on_host(scene, host):
    """The team orchestration of K2/K3 (a warp's dealing of tasks, width
    32) against the plain version: K2 to 1e-9 and K3 to 1e-7 of scale."""
    (q, v, u), g = _host_case(scene["mt"])
    op = host.op
    want = op.fwd_ref(q, v, u)
    host.width = 32
    got = host.run_fwd(q, v, u)
    for a, b in zip(got, want):
        _close(a, b.numpy(), 1e-9)
    ref = op.bwd_ref(q, v, u, want[2], *g)
    for a, b in zip(host.run_bwd(q, v, u, want[2], *g), ref):
        _close(a, b.numpy(), 1e-7)


def test_host_team_widths_agree_bit_for_bit(scene, host):
    """Every task writes its own slots and every combine runs in a fixed
    order, so a team of width 1 (tasks in order) and one of width 32 (dealt
    round-robin, rank by rank, as a warp deals them) or 7 give equal
    results, bit for bit, and the same residual counts."""
    (q, v, u), g = _host_case(scene["mt"])
    runs = []
    for width in (1, 32, 7):
        host.width = width
        fwd = host.run_fwd(q, v, u)
        nres = host.last_residuals.clone()
        runs.append((fwd, nres, host.run_bwd(q, v, u, fwd[2], *g)))
    host.width = 32
    (f0, n0, b0), *rest = runs
    for f, n, b in rest:
        assert torch.equal(n, n0)
        for x, y in zip(f + b, f0 + b0):
            assert torch.equal(x, y)


def test_k2_jumps_at_round_off_on_a_violent_lane(scene, host):
    """Lanes 505 and 984 of contact_state(seed 0) at B = 1024 sit where
    K2's function itself jumps (the chord's stop and best iterate flip):
    changes of (q, qdot, u) by 1e-15 of themselves move the plain version's
    output by more than 1e-2 of scale there, and the kernels' source jumps
    with it. The card's float64 check (tests/test_torch_cuda.py) excuses a
    lane off its plain version only where the plain version jumps so."""
    mt = scene["mt"]
    q, v = contact_state("tactile_push", mt.q_init.numpy(), 1024, seed=0)
    u = 0.5 * np.random.RandomState(1).randn(6, 1024)
    lanes, draws = [505, 984], 4
    cols = np.repeat(lanes, draws + 1)          # each lane, then its draws
    changed = np.tile(np.r_[0, np.ones(draws)], len(lanes))
    rng = np.random.RandomState(0)
    args = [_t(a[:, cols] * (1 + 1e-15 * changed * rng.randn(a.shape[0],
                                                           len(cols))))
            for a in (q, v, u)]
    host.width = 32

    def moved(out):
        out = [x.reshape(-1, len(lanes), draws + 1) for x in out]
        return [max(float((x[:, i, 1:] - x[:, i, :1]).abs().max()
                          / x[:, i, :1].abs().max()) for x in out)
                for i in range(len(lanes))]

    assert min(moved(host.op.fwd_ref(*args))) > 1e-2
    assert min(moved(host.run_fwd(*args))) > 1e-2


# the operations per lane that K2/K3 need (megastep_host.needed) at the
# inputs of `python megastep_host.py`: contact_state(seed 0), 4 lanes, u from
# RandomState(1); the bound's yardstick, recorded before the warp redesign
NEEDED = {"momentum": [42067] * 4, "residual": [117787] * 4,
          "column": [194300, 194300, 194012, 194012],
          "momentum_column": [70320] * 4, "factor": [234] * 4,
          "solve": [91] * 4}


def test_needed_units_pinned(scene, counter):
    st, mt = scene["st"], scene["mt"]
    q, v = contact_state("tactile_push", mt.q_init.numpy(), 4, seed=0)
    u = 0.5 * np.random.RandomState(1).randn(st.ndof_u, 4)
    need = megastep_host.needed(counter.units(scene["tables"], q, v, u),
                                st.ndof_q)
    assert {k: a.tolist() for k, a in need.items()} == NEEDED


def test_operation_count_structure(scene, counter):
    """The jet count of megastep_host.needed assumes how many Lagrangians
    and residuals each sweeping function of csrc/megastep.cu runs."""
    st, mt = scene["st"], scene["mt"]
    q, v = contact_state("tactile_push", mt.q_init.numpy(), 2, seed=0)
    u = 0.5 * np.random.RandomState(1).randn(st.ndof_u, 2)
    units = counter.units(scene["tables"], q, v, u, executed=True)
    c = {k: units[:, i] for i, k in enumerate(megastep_host.UNITS)}
    n = st.ndof_q
    np.testing.assert_array_equal(c["momentum_exec"], n * c["Lq1"])
    np.testing.assert_array_equal(c["el_pair_exec"], 2 * n * c["Lr1"])
    np.testing.assert_array_equal(c["columns_exec"], n * c["R1"] + 2 * n)
    np.testing.assert_array_equal(c["momentum_column_exec"], n * c["Lq2"])
    need = megastep_host.needed(units, n)
    # each needed unit is positive and below what the sweeps execute
    for k, ex in (("momentum", c["momentum_exec"]),
                  ("residual", c["R0"]),
                  ("momentum_column", c["momentum_column_exec"])):
        assert np.all((need[k] > 0) & (need[k] < ex)), k
    assert np.all((need["column"] > 0) & (need["column"] < c["R1"]))
    k2, k3 = megastep_host.k2_k3_ops(need, n, 5, np.full(2, 45))
    assert 0 < k2 < k3
