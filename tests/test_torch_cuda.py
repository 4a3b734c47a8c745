"""The port's CUDA kernels on the card (marker ``cuda``).

Each test skips with a reason where no CUDA device is present. This module
imports neither JAX nor the JAX package, so it runs on a machine with the
card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import ACTOR_CFG, contact_state, cylinder_probe
from tactilesimulation_tpu_torch.envs import tactile_push_lanes
from tactilesimulation_tpu_torch.model import task_scenes
from tactilesimulation_tpu_torch.models.nets import DiagGaussianActor
from tactilesimulation_tpu_torch.ops import lane_contact
from tactilesimulation_tpu_torch.sim import contact, lanes

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
    torch.manual_seed(0)
    actor = DiagGaussianActor(env.obs_size()[0], env.ndof_u,
                              ACTOR_CFG).to(card)
    rewards, dones, infos = env.batched_rollout_fn(actor.act, 1)(16)
    assert env.pair_wrenches.launches == 1 + 47
    assert tuple(rewards.shape) == (16, 1)
    assert bool(torch.isfinite(rewards).all())
    assert all(bool(torch.isfinite(x).all()) for x in infos.values())
