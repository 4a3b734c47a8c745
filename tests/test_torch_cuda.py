"""The port's CUDA kernels on the card (marker ``cuda``).

Each test skips with a reason where no CUDA device is present. This module
imports neither JAX nor the JAX package, so it runs on a machine with the
card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import (ACTOR_CFG, ADJ_F64_TOL, DCLAW_CONTACT, DCLAW_RADII,
                        GRASP_SHORT, K1T_TOL, K1_SCENES, K23_F32_VS_F64,
                        K23_F64_TOL, K4_TOL, READ_SCENES, READ_TOL, Smoke,
                        block_chain, contact_state, facade_backward, max_rel,
                        pair_wrench_inputs, read_case, read_f64_tol)
from tactilesimulation_tpu_torch import envs
from tactilesimulation_tpu_torch.algorithms.ppo import PPO
from tactilesimulation_tpu_torch.envs import tactile_push, tactile_push_lanes
from tactilesimulation_tpu_torch.model import task_scenes
from tactilesimulation_tpu_torch.models.nets import DiagGaussianActor
from tactilesimulation_tpu_torch.ops import (dense_contact, lane_contact,
                                            megastep, tactile_query)
from tactilesimulation_tpu_torch.sim import dense_single, dynamics, lanes
from tactilesimulation_tpu_torch.sim import simulation

pytestmark = pytest.mark.cuda
B = 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(name, dev, per_lane):
    op, args, lanes_prm = pair_wrench_inputs(name, B)
    if per_lane:
        args[7] = lanes_prm
    return op, [a.to(dev, torch.float32).contiguous() for a in args]


def _cotangents(op, args, seed=2):
    rng = np.random.RandomState(seed)
    Bk = args[0].shape[-1]
    return [torch.as_tensor(rng.randn(3, n, Bk), dtype=torch.float32,
                            device=args[0].device)
            for n in (op.J, op.J, op.ntac)]


def _twin_vjp(op, args, cots):
    ins = [a.detach().requires_grad_() for a in args]
    outs = op.reference(*ins)
    live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    return torch.autograd.grad([o for o, _ in live], ins,
                               [c for _, c in live], allow_unused=True)


@pytest.mark.parametrize("per_lane", [False, True], ids=["static", "lanes"])
@pytest.mark.parametrize("name", K1_SCENES)
def test_k1_matches_plain_version(card, name, per_lane):
    op, args = _k1_inputs(name, card, per_lane)
    with torch.no_grad():
        got = op(*args)
        want = op.reference(*args)
    assert op.launches == 1
    assert float(got[0].abs().max()) > 1e-3            # contacts are active
    for g, w in zip(got, want):
        if w.numel():
            scale = float(w.abs().max()) + 1e-6
            assert float((g - w).abs().max()) <= 1e-5 * scale


# K1T against the twin's VJP in float32 (tolerance and its reason:
# chip_smoke.py K1T_TOL)
@pytest.mark.parametrize("per_lane", [False, True], ids=["static", "lanes"])
@pytest.mark.parametrize("name", K1_SCENES)
def test_k1t_matches_twin_vjp(card, name, per_lane):
    op, args = _k1_inputs(name, card, per_lane)
    cots = _cotangents(op, args)
    got = op.run_adjoint(args, cots, (True,) * 11)
    want = _twin_vjp(op, args, cots)
    assert op.bwd_launches == 1 and op.twin_vjps == 0
    for g, w, what in zip(got, want, lane_contact._ARG_NAMES):
        if w is None:               # an input no segment reads
            assert float(g.abs().max()) == 0.0, what
            continue
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= K1T_TOL["rel"] * scale, (what, err, scale)
        if scale > 0:
            cos = float((g * w).sum() / (g.norm() * w.norm()))
            assert cos >= K1T_TOL["cos"], (what, cos)


def test_k1_and_k1t_are_bit_equal_across_launches(card):
    op, args = _k1_inputs("stable_grasp", card, True)
    cots = _cotangents(op, args)
    with torch.no_grad():
        first, second = op(*args), op(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    first = op.run_adjoint(args, cots, (True,) * 11)
    second = op.run_adjoint(args, cots, (True,) * 11)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k1t_never_reaches_the_twin(card, monkeypatch):
    op, args = _k1_inputs("tactile_push", card, False)
    ins = [a.detach().requires_grad_(i < 6) for i, a in enumerate(args)]
    F, T, tac = op(*ins)

    def refuse(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(op, "reference", refuse)
    grads = torch.autograd.grad(tac.sum() + F.sum(), ins[:6])
    assert (op.launches, op.bwd_launches, op.twin_vjps,
            op.twin_recomputes) == (1, 1, 0, 0)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_k1t_computes_what_is_asked(card):
    """Only the cotangents asked for come back; a None cotangent counts as
    zero; what is asked equals the full launch's."""
    op, args = _k1_inputs("tactile_insertion", card, True)
    cots = _cotangents(op, args)
    full = op.run_adjoint(args, [cots[0], cots[1], None], (True,) * 11)
    need = (False, True, False, False, True, False, True, False, False,
            False, True)
    some = op.run_adjoint(args, [cots[0], cots[1], None], need)
    for nd, g, w in zip(need, some, full):
        assert (g is None) == (not nd)
        if nd:
            assert torch.equal(g, w)


def test_k1_forward_never_runs_the_plain_version(card, monkeypatch):
    op, args = _k1_inputs("tactile_push", card, False)

    def refuse(*a):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(op, "reference", refuse)
    with torch.no_grad():
        F, T, tac = op(*args)
    torch.cuda.synchronize()
    assert op.launches == 1 and F.is_cuda and bool(torch.isfinite(tac).all())


def test_k1_rejects_what_it_does_not_take(card):
    op, args = _k1_inputs("tactile_push", card, False)
    with pytest.raises(TypeError, match="float32"):
        op(*[a.double() for a in args])
    bad = list(args)
    bad[1] = bad[1][:, :, :-1].contiguous()                 # jq lane count
    with pytest.raises(ValueError, match="jq"):
        op(*bad)
    bad = list(args)
    bad[6] = bad[6].cpu()                                   # sizes off card
    with pytest.raises(ValueError, match="sizes"):
        op(*bad)
    assert op.launches == 0


def test_slice_runs_through_k1(card):
    env = tactile_push_lanes.make("tactile_flatten", device=card, seed=0)
    env.rebuild_solver(mega=False)             # slice 1: the lanes stepper
    torch.manual_seed(0)
    actor = DiagGaussianActor(env.obs_size()[0], env.ndof_u,
                              ACTOR_CFG).to(card)
    rewards, dones, infos = env.batched_rollout_fn(actor.act, 1)(16)
    pw = env.pair_wrenches
    assert pw.launches == 1 + 47
    # the chord factor's 7 pullbacks are 7 K1T launches, no twin
    assert (pw.bwd_launches, pw.twin_vjps, pw.twin_recomputes) == (7, 0, 0)
    assert tuple(rewards.shape) == (16, 1)
    assert bool(torch.isfinite(rewards).all())
    assert all(bool(torch.isfinite(x).all()) for x in infos.values())


def _mega_case(dev, dtype, Bm, seed=0):
    struct, model = task_scenes.tactile_push()
    q, v = contact_state("tactile_push", model.q_init.numpy(), Bm, seed=seed)
    rng = np.random.RandomState(seed + 1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=dev)
    op = megastep.MegaStep(struct, model.to(dev, dtype), 5, 8)
    return (op, t(q), t(v), t(0.5 * rng.randn(6, Bm)),
            [t(rng.randn(7, Bm)) for _ in range(4)])


def _rel(a, b):
    return float((a.double() - b).abs().max()) / float(b.abs().max())


def _lane_err(got, want):
    """Per lane, the largest error of any output over that output's scale
    (its largest magnitude over all lanes, as in _rel)."""
    err = torch.zeros(want[0].shape[-1], dtype=torch.float64,
                      device=want[0].device)
    for a, b in zip(got, want):
        e = (a.double() - b).abs().reshape(-1, b.shape[-1]).max(0).values
        err = torch.maximum(err, e / b.abs().max())
    return err


def _jumping(op, q, v, u, want, lanes, draws=64):
    """Of ``lanes``, those where the plain version itself moves by more
    than 1e-9 of scale when (q, qdot, u) change by 1e-15 of themselves (any
    of ``draws`` random changes): K2's function jumps there at round-off, as
    the chord's stop and best iterate flip (CPU witness:
    tests/test_torch_megastep.py, test_k2_jumps_at_round_off_on_a_violent_
    lane)."""
    if not lanes:
        return []
    idx = torch.tensor(lanes, device=q.device).repeat_interleave(draws)
    rng = np.random.RandomState(7)
    args = [(a[:, idx] * (1 + 1e-15 * torch.as_tensor(
        rng.randn(a.shape[0], len(idx)), dtype=a.dtype, device=a.device)))
        .contiguous() for a in (q, v, u)]
    moved = torch.zeros(len(lanes), dtype=torch.bool, device=q.device)
    for a, b in zip(op.fwd_ref(*args), want):
        jump = (a - b[..., idx]).abs() > 1e-9 * b.abs().max()
        moved |= jump.reshape(-1, len(lanes), draws).any(-1).any(0)
    return [lane for lane, m in zip(lanes, moved.tolist()) if m]


# on violent contact states: float64 against the plain version, the same
# algorithm to round-off, on every lane but those where the plain version
# itself jumps at round-off (each lane off its plain version must be one of
# them; printed; at most 5 % of the lanes); float32, the kernel and the f32
# plain version each against the f64 plain version, the kernel within a
# small multiple of the plain version's error (the tolerances and their
# reasons: chip_smoke.py K23_F64_TOL, K23_F32_VS_F64). B = 1 and 33 leave a
# ragged last block; 16 is the GD width; 1024 the main path's.
@pytest.mark.parametrize("Bm", [1, 16, 33, 1024])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k2_k3_match_plain_version(card, dtype, Bm):
    op, q, v, u, g = _mega_case(card, dtype, Bm)
    got = op.run_fwd(q, v, u)
    want = op.fwd_ref(q, v, u)
    grads = op.run_bwd(q, v, u, want[2], *g)
    ref = op.bwd_ref(q, v, u, want[2], *g)
    torch.cuda.synchronize()
    assert (op.fwd_launches, op.bwd_launches) == (1, 1)
    assert all(bool(torch.isfinite(a).all()) for a in got + grads)
    if dtype == torch.float64:
        off = ((_lane_err(got, want) > K23_F64_TOL["fwd"])
               | (_lane_err(grads, ref) > K23_F64_TOL["bwd"]))
        off = torch.nonzero(off).flatten().tolist()
        jumping = _jumping(op, q, v, u, want, off)
        errs = [_rel(a, b) for a, b in zip(got + grads, want + ref)]
        print(f"f64 B={Bm}: lanes off the plain version {off}, of which the "
              f"plain version jumps at round-off on {jumping}; rel err on "
              f"all lanes {errs}")
        assert jumping == off and len(off) <= 0.05 * Bm
        return
    op64, *x64 = _mega_case(card, torch.float64, Bm)
    x64 = [x64[0], x64[1], x64[2]] + x64[3]
    ref64 = op64.fwd_ref(*x64[:3])
    y64 = x64[:3] + [ref64[2]] + x64[3:]
    y32 = [a.float().contiguous() for a in y64]
    mult, floor = K23_F32_VS_F64
    for kern, plain, exact in (
            (got, want, ref64),
            (op.run_bwd(*y32), op.bwd_ref(*y32), op64.bwd_ref(*y64))):
        for k, p, e in zip(kern, plain, exact):
            assert _rel(k, e) <= mult * _rel(p, e) + floor


def test_k2_k3_large_instance_matches_small(card, monkeypatch):
    """The instance for scenes of up to 16 coordinates, joints, bodies and
    controls, forced onto TactilePush, against the small instance that the
    wrapper picks: the same arithmetic in other array sizes, float64 to
    round-off."""
    op, q, v, u, g = _mega_case(card, torch.float64, 33)
    big, *_ = _mega_case(card, torch.float64, 33)
    lim = megastep.limits()
    assert op.instance() == lim["small_instance"] < lim["n"]
    monkeypatch.setattr(big, "instance", lambda: lim["n"])
    small = op.run_fwd(q, v, u)
    large = big.run_fwd(q, v, u)
    for a, b in zip(large, small):
        assert _rel(a, b) <= 1e-12
    sg = op.run_bwd(q, v, u, small[2], *g)
    lg = big.run_bwd(q, v, u, small[2], *g)
    for a, b in zip(lg, sg):
        assert _rel(a, b) <= 1e-12


def test_k2_k3_launch_nothing_at_b0(card):
    op, q, v, u, g = _mega_case(card, torch.float32, 0)
    qo, qdo, vs = op.run_fwd(q, v, u)
    grads = op.run_bwd(q, v, u, vs, *g)
    assert (op.fwd_launches, op.bwd_launches) == (0, 0)
    assert tuple(vs.shape) == (5, 7, 0)
    assert [tuple(x.shape) for x in grads] == [(7, 0), (7, 0), (6, 0)]


def test_k2_k3_refuse_a_scene_above_the_largest_instance(card):
    op, q, v, u, g = _mega_case(card, torch.float32, 8)
    lim = megastep.limits()
    op.tables.J = lim["joints"] + 1
    with pytest.raises(ValueError, match="limits"):
        op.run_fwd(q, v, u)
    op.tables.J = 7
    op.tables.segments = op.tables.segments * (lim["segments"] // 3 + 1)
    with pytest.raises(ValueError, match="limits"):
        op.run_bwd(q, v, u, torch.zeros((5, 7, 8), device=card), *g)
    assert (op.fwd_launches, op.bwd_launches) == (0, 0)


def test_k2_k3_reject_what_they_do_not_take(card):
    op, q, v, u, g = _mega_case(card, torch.float32, 8)
    with pytest.raises(TypeError, match="float32 or float64"):
        op.run_fwd(q.half(), v.half(), u.half())
    with pytest.raises(ValueError, match="u"):
        op.run_fwd(q, v, u[:3].contiguous())
    with pytest.raises(ValueError, match="qdot"):
        op.run_fwd(q, v.double(), u)
    assert op.fwd_launches == 0


def test_mega_rollout_backward_runs_through_k2_k3(card):
    env = tactile_push_lanes.make("tactile_flatten", device=card, seed=0)
    assert env.solver_mega
    torch.manual_seed(0)
    actor = DiagGaussianActor(env.obs_size()[0], env.ndof_u,
                              ACTOR_CFG).to(card)
    rewards = env.batched_rollout_fn(actor.act, 2)(16)[0]
    loss = -rewards.sum(dim=1).mean()
    grads = torch.autograd.grad(loss, list(actor.mlp.parameters()))
    assert (env.megastep.fwd_launches, env.megastep.bwd_launches) == (2, 2)
    pw = env.pair_wrenches
    assert pw.launches == 1 + 2
    # the tactile observation's pullback: K1T for each observation an action
    # was taken on (the reset's), never the twin
    assert (pw.bwd_launches, pw.twin_vjps, pw.twin_recomputes) == (1, 0, 0)
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    assert sum(float(x.abs().sum()) for x in grads) > 0


# K4 against its plain version (tolerances and their reasons:
# chip_smoke.py K4_TOL)
@pytest.mark.parametrize("N", [1, 257, 40000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("gtype", [-1, 0, 1, 2],
                         ids=["ground", "cuboid", "cylinder", "sphere"])
def test_k4_matches_plain_version(card, gtype, dtype, N):
    dc, args = Smoke.k4_inputs(gtype, N, dtype, card)
    dense_contact.reset_counts()
    got = dc.dense_point_contact(gtype, *args)
    torch.cuda.synchronize()
    assert dense_contact.launches == 1
    want = dc.dense_point_contact_ref(gtype, *args)
    assert got.dtype == dtype and tuple(got.shape) == (N, 3)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= K4_TOL[dtype] * scale
    if N > 1:
        assert 0 < int((want.abs().sum(dim=1) > 0).sum()) < N


def test_k4_raises_instead_of_falling_back(card):
    dc, args = Smoke.k4_inputs(2, 257, torch.float32, card)
    x, xd, rest = args[0], args[1], args[2:]
    dense_contact.reset_counts()
    with pytest.raises(ValueError, match="contiguous"):
        dc.dense_point_contact(2, x.T.contiguous().T, xd, *rest)
    with pytest.raises(ValueError, match="shape"):
        dc.dense_point_contact(2, x[:, :2].contiguous(), xd, *rest)
    with pytest.raises(ValueError, match="shape"):
        dc.dense_point_contact(2, x, xd[:-1], *rest)
    with pytest.raises(TypeError):
        dc.dense_point_contact(2, x.half(), xd.half(), *rest)
    with pytest.raises(ValueError, match="xdot"):
        dc.dense_point_contact(2, x, xd.cpu(), *rest)
    with pytest.raises(ValueError, match="primitive type"):
        dc.dense_point_contact(5, x, xd, *rest)
    assert dense_contact.launches == 0


def test_rolling_query_runs_through_k4(card):
    struct, model = task_scenes.rolling_ball(resolution=8)
    model = model.to(card, torch.float32)
    q, v = Smoke.pressed_ball(model.q_init.cpu().numpy())
    q = torch.as_tensor(q, dtype=torch.float32, device=card)
    v = torch.as_tensor(v, dtype=torch.float32, device=card)
    dense_contact.reset_counts()
    got = tactile_query.tactile_field(struct, model, q, v)
    assert (dense_contact.read_launches, dense_contact.launches) == (1, 0)
    # the plain differentiable path in float32: marker velocities from the
    # joint twists there, from the FK's dual part in the read kernel; the
    # two differ by float round-off (6e-6 of scale measured at 40,000
    # markers)
    want = dense_single.tactile_field_points_major(struct, model, q, v)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-4 * scale
    sim = simulation.Simulator(struct, model)
    rollout = sim.make_rollout_strided(5, fast_tactile=True)
    us = torch.tensor([[0.1, 0.0, 0.2]] * 2, device=card)
    dense_contact.reset_counts()
    state, qs, _, tacs = rollout(model, sim.init_state(q=q, qdot=v), us)
    assert (dense_contact.read_launches, dense_contact.launches) == (2, 0)
    assert bool(torch.isfinite(qs).all()) and bool(torch.isfinite(tacs).all())


# the tactile read against its plain version (tolerances and their reasons:
# chip_smoke.py READ_TOL, READ_ROUNDING_ROWS)
@pytest.mark.parametrize("name", ("rolling_ball_200",) + READ_SCENES)
def test_tactile_read_matches_plain_version(card, name):
    # float64 within 1e-12 x scale, float32 within 1e-5 x scale but on the
    # rows where float32 rounding decides a jump (at most 1 %, held to
    # float64 there); one launch a read; two launches bit-equal
    Smoke().read_check(name, card)


# the batched read (one launch for B states): against its plain version
# over the batch by the read rule, and against B single launches bit for
# bit (chip_smoke.py Smoke.batch_read_check)
@pytest.mark.parametrize("name,B", [("rolling_ball_200", 8)]
                         + [(name, 3) for name in READ_SCENES])
def test_batched_tactile_read(card, name, B):
    Smoke().batch_read_check(name, card, B)


def test_tactile_read_raises_without_launching(card):
    struct, model, q, v = read_case("tactile_push", torch.float32, card)
    plan = tactile_query.read_plan(struct, model)
    dense_contact.reset_counts()
    with pytest.raises(ValueError, match="on cpu"):
        dense_contact.tactile_read(plan, q.cpu(), v)
    with pytest.raises(TypeError):
        dense_contact.tactile_read(plan, q.double(), v.double())
    with pytest.raises(ValueError, match="shape"):
        dense_contact.tactile_read(plan, q[:-1], v[:-1])
    with pytest.raises(ValueError, match="shape"):
        dense_contact.tactile_read(plan, q, torch.stack([v, v], 1)[:, 0])
    assert dense_contact.read_launches == 0
    out = dense_contact.tactile_read(plan, q, v)
    assert dense_contact.read_launches == 1 and out.shape == (plan.N, 3)


def test_tactile_read_raises_past_shared_memory(card):
    # the read's tables live in a block's shared memory, sized from the
    # plan: 900 pairs in float64 ask for more than a block may hold
    from tactilesimulation_tpu_torch.model import scenes
    struct, model = block_chain(scenes, blocks=900)
    model = model.to(card, torch.float64)
    plan = tactile_query.read_plan(struct, model)
    q = torch.zeros(plan.n, dtype=torch.float64, device=card)
    dense_contact.reset_counts()
    with pytest.raises(RuntimeError, match="shared memory"):
        dense_contact.tactile_read(plan, q, q)
    assert dense_contact.read_launches == 0


def test_tactile_read_sees_model_edits(card):
    struct, model, q, v = read_case("dclaw", torch.float64, card)
    before = tactile_query.tactile_field(struct, model, q, v)
    model.body_size[struct.body_index("cap"), 0] += 0.002    # in place
    model.tac_kn.mul_(2.0)
    got = tactile_query.tactile_field(struct, model, q, v)
    want = tactile_query.tactile_field_ref(struct, model, q, v)
    scale = float(want.abs().max())
    assert not torch.equal(got, before)
    assert float((got - want).abs().max()) <= READ_TOL[torch.float64] * scale


def test_facade_backward_on_card_matches_cpu(card):
    """``backward()`` and ``backward_steps(2)`` with every flag on, on
    RollingBall 8x8 pressed, float64: card within ADJ_F64_TOL of the CPU."""
    struct, model = task_scenes.rolling_ball(resolution=8)
    q, v = Smoke.pressed_ball(model.q_init.numpy())
    got = facade_backward(struct, model, card, torch.float64, q, v)
    want = facade_backward(struct, model, torch.device("cpu"),
                           torch.float64, q, v)
    assert all(float(w.abs().max()) > 0 for w in want.values())
    for k, err in max_rel(got, want).items():
        assert err <= ADJ_F64_TOL, (k, err)


def test_strided_rollout_under_grad_launches_no_read(card):
    """The read kernel has no backward: under grad the strided rollout
    takes the differentiable field even with ``fast_tactile``, and the
    tactile term's gradient is non-zero; without grad it reads through the
    kernel, to the same values."""
    struct, model = task_scenes.rolling_ball(resolution=8)
    model = model.to(card, torch.float32)
    q, v = Smoke.pressed_ball(model.q_init.cpu().numpy())
    sim = simulation.Simulator(struct, model)
    rollout = sim.make_rollout_strided(5, fast_tactile=True)
    us = torch.tensor([[0.1, 0.0, 0.2]] * 2, device=card, requires_grad=True)
    dense_contact.reset_counts()
    _, _, _, tacs = rollout(model, sim.init_state(q=q, qdot=v), us)
    (g,) = torch.autograd.grad(torch.sum(tacs ** 2), us)
    assert (dense_contact.read_launches, dense_contact.launches) == (0, 0)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    with torch.no_grad():
        _, _, _, fast = rollout(model, sim.init_state(q=q, qdot=v), us)
    assert dense_contact.read_launches == 2
    scale = float(tacs.abs().max())
    assert float((fast - tacs.detach()).abs().max()) <= 1e-4 * scale


def test_facade_read_sees_update_edits(card):
    """A facade read after ``update_tactile_parameters`` and after
    ``update_body_size`` (the ball) launches the read with the new leaves:
    it equals the plain version on the edited model and differs from the
    read before."""
    struct, model = task_scenes.rolling_ball(resolution=8)
    q, v = Smoke.pressed_ball(model.q_init.numpy())
    fac = simulation.Simulation((struct, model), device=card,
                                dtype=torch.float64)
    fac.set_state_init(q, v)
    fac.reset()
    prev = fac.get_tactile_force_vector()
    assert np.abs(prev).max() > 0
    for edit in (lambda f: f.update_tactile_parameters("pad", kn=2.0),
                 lambda f: f.update_body_size("object", [0.021])):
        edit(fac)
        dense_contact.reset_counts()
        got = fac.get_tactile_force_vector()
        assert dense_contact.read_launches == 1
        want = tactile_query.tactile_field_ref(
            struct, fac.model, fac._state.q, fac._state.qdot).reshape(-1)
        want = want.cpu().numpy()
        assert np.abs(got - want).max() <= (READ_TOL[torch.float64]
                                            * np.abs(want).max())
        assert not np.array_equal(got, prev)
        prev = got



def test_env_observation_reads_through_the_kernel(card):
    """The single-instance TactilePush env reads its field through the read
    kernel under ``no_grad`` (one launch a read), equal to
    ``dynamics.tactile_field`` in float64; under grad it takes the
    differentiable field and launches nothing."""
    env = tactile_push.make("tactile_flatten", device=card,
                            dtype=torch.float64, seed=1)
    dense_contact.reset_counts()
    with torch.no_grad():
        state, obs = env.reset()
        for u in ([2.0, 0.3, -0.2], [2.0, -0.1, 0.1], [1.5, 0.0, 0.0]):
            state, obs, _, _, _ = env.step(
                state, torch.tensor(u, dtype=torch.float64, device=card))
    assert (dense_contact.read_launches, dense_contact.launches) == (4, 0)
    want = dynamics.tactile_field(env.struct, env.model, state.sim.q,
                                  state.sim.qdot).reshape(-1)
    scale = float(want.abs().max())
    assert scale > 0, "the pad never touched the box"
    assert float((obs[3:] - want).abs().max()) <= (
        READ_TOL[torch.float64] * scale)
    dense_contact.reset_counts()
    u = torch.zeros(3, dtype=torch.float64, device=card, requires_grad=True)
    _, obs, reward, _, _ = env.step(state, u)
    (g,) = torch.autograd.grad(reward + obs[3:].sum(), u)
    assert dense_contact.read_launches == 0
    assert bool(torch.isfinite(g).all())


def test_ppo_update_on_card(card):
    """One PPO update on TactilePush on the card (N = 2, T = 2): every
    observation one read launch, finite loss and parameters, the
    generators on the card."""
    cfg = {"network": {"actor": "DiagGaussianActor",
                       "actor_mlp": {"layer_sizes": [64, 64],
                                     "activation": "elu"},
                       "actor_logstd_init": 0,
                       "critic": "MLPCritic",
                       "critic_mlp": {"layer_sizes": [64, 64],
                                      "activation": "elu"}},
           "config": {"num_processes": 2, "num_steps": 2,
                      "num_env_steps": 4, "num_mini_batch": 2,
                      "ppo_epoch": 2}}
    env = envs.make("TactilePush-v1", device=card, dtype=torch.float32)
    algo = PPO(env, cfg, seed=0)
    assert algo.act_generator.device.type == "cuda"
    dense_contact.reset_counts()
    algo.train()
    assert dense_contact.read_launches == 2 * (1 + 2)
    metrics = algo.last_update["metrics"]
    assert bool(torch.isfinite(metrics).all())
    assert all(bool(torch.isfinite(p).all()) for p in algo.ac.parameters())
    assert all(p.is_cuda for p in algo.ac.parameters())


@pytest.mark.parametrize("B", (8, 16))
def test_insertion_lane_execute_matches_plain_route(card, B, monkeypatch):
    """TactileInsertion's lane script with K1 (per-lane contact parameters)
    and K1T (the chord factors' pullbacks) against the plain lane contact,
    both on the card in float32 (K1 has no float64 instance): the first
    substep's chord factor and chord from the start pose within 1e-3 of
    scale (on the CPU K1's plain twin parts from the plain contact by
    about 1e-5: the sums run in other orders and the 10 sweeps do not
    converge); then the script cut to 10 substeps (3 chord factors, the
    captures at substeps 6 and 9) through K1: launches 3 + 10 x 11 + 2 and
    3 x 12, the twin never, finite q and observations. The whole script
    diverges lane by lane under round-off (see chip_smoke's insertion
    phase), so its outputs are not compared here."""
    from tactilesimulation_tpu_torch.envs import tactile_insertion
    from tactilesimulation_tpu_torch.envs import tactile_insertion_lanes
    env = tactile_insertion.make(device=card, dtype=torch.float32, seed=B,
                                 allow_rotation=True, num_obs_frames=1,
                                 domain_randomization=True)
    fused = tactile_insertion_lanes.TactileInsertionLanes(env)
    plain = tactile_insertion_lanes.TactileInsertionLanes(env, fused=False)
    pw = fused.pair_wrenches
    assert pw is not None and plain.pair_wrenches is None
    s = env._sample_reset(B)
    model = fused._batched_model({k: s[k].T
                                  for k in tactile_insertion.DR_NAMES})
    q = s["q_cmd"].T.contiguous()
    v = torch.zeros_like(q)
    u = env.script(q.T, s["grasp_force"])[0].T.contiguous()
    inputs = lanes.StepInputs(model=model, u=u, q_base=q,
                              p_base=lanes.momentum(env.struct, model, q, v),
                              gamma=model.h.reshape(1, 1))
    out = {}
    for name, lenv in (("kernel", fused), ("plain", plain)):
        lu = lanes.make_chord_lu(lenv._residual, inputs, v)
        with torch.no_grad():
            out[name] = {"lu": lu, "v": lanes._chord(
                lenv._residual, lenv.max_iter, 1e-7, inputs, v, lu)}
    err = max_rel(out["kernel"], out["plain"])
    assert err["lu"] <= 1e-3 and err["v"] <= 1e-3, err

    monkeypatch.setattr(tactile_insertion_lanes, "EXEC_STEPS", 10)
    env.capture_frames = [6, 9]
    pw.reset_counts()
    with torch.no_grad():
        q_k, obs_k = fused._lane_execute(model, q, s["grasp_force"],
                                         env._draw("obs_noise", B))
    assert (pw.launches, pw.bwd_launches,
            pw.twin_vjps + pw.twin_recomputes) == (3 + 10 * 11 + 2, 3 * 12,
                                                   0)
    assert bool(torch.isfinite(q_k).all() and torch.isfinite(obs_k).all())


def test_stable_grasp_capture_reads_through_the_kernel(card, monkeypatch):
    """StableGrasp on the card, float64, on the short schedule GRASP_SHORT
    from the draws of GRASP_DRAWS: the reset's script reads its capture
    through the read kernel once (the points entry never), equal to the
    plain version at the recorded state (``read_f64_tol``) with rows in
    contact."""
    from tactilesimulation_tpu_torch.envs import stable_grasp
    monkeypatch.setattr(stable_grasp, "STAGE_STEPS", list(GRASP_SHORT[0]))
    monkeypatch.setattr(stable_grasp, "CAPTURE_FRAME", GRASP_SHORT[1])
    env = stable_grasp.make(device=card, dtype=torch.float64)
    draws = Smoke.grasp_draws(card, torch.float64)
    env._draw = lambda what, B: draws
    dense_contact.reset_counts()
    with torch.no_grad():
        state, obs = env.reset()
    assert (dense_contact.read_launches, dense_contact.launches) == (1, 0)
    ex = state.extras
    model = env._model_for(ex)
    want = tactile_query.tactile_field_ref(env.struct, model, ex.cap_q,
                                           ex.cap_qdot)
    assert float(want.abs().max()) > 0, "no row in contact at the capture"
    # light contact (about 1e-3 N): held as the smoke holds an env's read
    tol, _ = read_f64_tol(env.struct, model, ex.cap_q, ex.cap_qdot, want)
    assert float((ex.cap_field - want).abs().max()) <= tol
    assert obs.shape == (4, 13, 10) and bool(torch.isfinite(obs).all())


def test_dclaw_resets_read_through_the_kernel(card):
    """DClaw on the card, float64: each reset's observation is one read
    launch, equal to the plain version on that episode's Model: the cap of
    DCLAW_CONTACT under every fingertip, then the radii DCLAW_RADII, each
    through a plan of its own."""
    from tactilesimulation_tpu_torch.envs import dclaw_rotate
    env = dclaw_rotate.make(device=card, dtype=torch.float64)
    plans = []
    for radius in (DCLAW_CONTACT["radius"],) + DCLAW_RADII:
        draws = Smoke.dclaw_draws(dict(DCLAW_CONTACT, radius=radius), card,
                                  torch.float64)
        env._draw = lambda what, B, d=draws: d
        dense_contact.reset_counts()
        with torch.no_grad():
            state, obs = env.reset()
        assert dense_contact.read_launches == 1
        model = env._model_for(state.extras)
        q = state.sim.q
        want = tactile_query.tactile_field_ref(env.struct, model, q,
                                               torch.zeros_like(q))
        scale = float(want.abs().max())
        err = float((state.extras.tactile_imgs - env._images(want)).abs()
                    .max())
        assert err <= READ_TOL[torch.float64] * scale
        if radius == DCLAW_CONTACT["radius"]:
            assert bool((state.extras.tactile_imgs.abs().sum(dim=(1, 2, 3))
                         > 0).all()), "a fingertip misses the cap"
        plans.append(tactile_query.read_plan(env.struct, model))
    assert len({id(p) for p in plans}) == len(plans)


def test_scene_xml_phase(card):
    """chip_smoke's scene_xml phase at rolling_ball(16): the RollingBall and
    TactilePush files built on the card equal to the bundled scenes and
    agreeing with the native compiler; the CLI's --scene (one read launch a
    chunk, bit-equal to the bundled scene); GD from the TactilePush file
    (K2/K3/K1/K1T launches an epoch, the trace names K2's and K3's
    kernels, the scalar tags); the facade from the file bit-equal."""
    smoke = Smoke()
    smoke.scene_xml_run(card, 16)
    launches = {k: r["launches"] for k, r in smoke.kernel_rows.items()}
    assert launches["K2"] == launches["K3"] > 0
    assert launches["K4R"] > 0 and launches["K4RB"] > 0
