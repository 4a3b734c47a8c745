"""The port's CUDA kernels on the card (marker ``cuda``).

Each test skips with a reason where no CUDA device is present. This module
imports neither JAX nor the JAX package, so it runs on a machine with the
card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import (ACTOR_CFG, K23_F32_VS_F64, K23_F64_TOL, K4_TOL,
                        Smoke, contact_state, cylinder_probe)
from tactilesimulation_tpu_torch.envs import tactile_push_lanes
from tactilesimulation_tpu_torch.model import task_scenes
from tactilesimulation_tpu_torch.models.nets import DiagGaussianActor
from tactilesimulation_tpu_torch.ops import (dense_contact, lane_contact,
                                            megastep, tactile_query)
from tactilesimulation_tpu_torch.sim import contact, dense_single, lanes
from tactilesimulation_tpu_torch.sim import simulation

pytestmark = pytest.mark.cuda
B = 256
SCENES = {
    "tactile_push": task_scenes.tactile_push,
    "rolling_ball_8": lambda: task_scenes.rolling_ball(resolution=8),
    "cylinder_probe": lambda: cylinder_probe(task_scenes),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(name, dev, per_lane):
    struct, model = SCENES[name]()
    q, v = contact_state(name, model.q_init.numpy(), B, seed=0)
    model = model.to(dev, torch.float32)
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    v = torch.as_tensor(v, dtype=torch.float32, device=dev)
    op = lane_contact.PairWrenches(struct)
    with torch.no_grad():
        jp, jq, bp, bquat, _, _, _, Om, be = lanes._fused_small_stage(
            struct, model, q, v)
        params = contact.combined_params(model)
        if per_lane:
            rng = np.random.RandomState(1)
            params = params[:, :, None] * torch.as_tensor(
                rng.uniform(0.5, 1.5, tuple(params.shape) + (B,)),
                dtype=torch.float32, device=dev)
        xi = lane_contact.pack_points(struct, model, op.src_idx)
    args = [jp, jq, Om, be, bp, bquat, model.body_size, params,
            model.ground_pos, model.ground_normal, xi]
    return op, [a.contiguous() for a in args]


@pytest.mark.parametrize("per_lane", [False, True], ids=["static", "lanes"])
@pytest.mark.parametrize("name", sorted(SCENES))
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
    assert env.pair_wrenches.launches == 1 + 47
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


# on violent contact states: float64 against the plain version, the same
# algorithm to round-off; float32, the kernel and the f32 plain version each
# against the f64 plain version, the kernel within a small multiple of the
# plain version's error (the tolerances and their reasons: chip_smoke.py
# K23_F64_TOL, K23_F32_VS_F64)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k2_k3_match_plain_version(card, dtype):
    op, q, v, u, g = _mega_case(card, dtype, 32)
    got = op.run_fwd(q, v, u)
    want = op.fwd_ref(q, v, u)
    grads = op.run_bwd(q, v, u, want[2], *g)
    ref = op.bwd_ref(q, v, u, want[2], *g)
    torch.cuda.synchronize()
    assert (op.fwd_launches, op.bwd_launches) == (1, 1)
    assert all(bool(torch.isfinite(a).all()) for a in got + grads)
    if dtype == torch.float64:
        for tol, pairs in ((K23_F64_TOL["fwd"], zip(got, want)),
                           (K23_F64_TOL["bwd"], zip(grads, ref))):
            assert all(_rel(a, b) <= tol for a, b in pairs)
        return
    op64, *x64 = _mega_case(card, torch.float64, 32)
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
    assert env.pair_wrenches.launches == 1 + 2
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
    assert dense_contact.launches == 1
    # the plain differentiable path in float32: marker velocities from the
    # joint twists there, v + w x d inside K4; the two differ by float
    # round-off (6e-6 of scale measured at 40,000 markers)
    want = dense_single.tactile_field_points_major(struct, model, q, v)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-4 * scale
    sim = simulation.Simulator(struct, model)
    rollout = sim.make_rollout_strided(5, fast_tactile=True)
    us = torch.tensor([[0.1, 0.0, 0.2]] * 2, device=card)
    dense_contact.reset_counts()
    state, qs, _, tacs = rollout(model, sim.init_state(q=q, qdot=v), us)
    assert dense_contact.launches == 2
    assert bool(torch.isfinite(qs).all()) and bool(torch.isfinite(tacs).all())
