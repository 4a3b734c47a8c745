"""K1, the pair-wrench op (``ops/lane_contact.py``), against the JAX package.

On the CPU the port's op runs its plain PyTorch version, so these tests pin
that version (the one the card's kernel is held to in ``chip_smoke.py``)
against the JAX package's Pallas kernel in interpret mode and its jnp twin:

- float32 against the Pallas kernel and the jnp twin, to 3e-6 x scale (the
  bar of tests/test_lane_contact.py: f32 round-off, other summation order);
- float64 against the jnp twin, to 1e-10 x scale, with static and per-lane
  (K, 4, B) contact parameters;
- the backward (a VJP through the plain twin) against ``jax.vjp``, float64;
- ``contact_terms_fused`` against the plain ``lanes.contact_terms``.

Inputs are the contact-rich lane states that ``chip_smoke.py`` holds the
card's kernel to, made from a numpy seed: the pad presses into the box and
the box into the ground (TactilePush: ground and cuboid); the pad presses
onto the ball (RollingBall, 8x8 markers: sphere); a tilted cube presses onto
a cylinder (a hand-made scene: cylinder). The kernel itself is tested on
the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import contact_state, cylinder_probe
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.ops import lane_contact as jax_lc
from tactilesimulation_tpu.sim import contact as jax_contact
from tactilesimulation_tpu.sim import lanes as jax_lanes
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import lane_contact as torch_lc
from tactilesimulation_tpu_torch.sim import contact as torch_contact
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes

torch.set_num_threads(1)

B = 4
SCENES = {
    "tactile_push": lambda m: m.tactile_push(),
    "rolling_ball_8": lambda m: m.rolling_ball(resolution=8),
    "cylinder_probe": cylinder_probe,
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    name = request.param
    sj, mj = SCENES[name](jax_scenes)
    st, mt = SCENES[name](torch_scenes)
    q, v = contact_state(name, mt.q_init.numpy(), B, seed=0)
    # op inputs from the port's small stage, float64; both sides get them
    jp, jq, bp, bquat, _, _, _, Om, be = torch_lanes._fused_small_stage(
        st, mt, torch.as_tensor(q), torch.as_tensor(v))
    pw_t, meta = torch_lc.make_pair_wrenches(st)
    params = torch_contact.combined_params(mt)
    xi = torch_lc.pack_points(st, mt, meta[2])
    args = [a.numpy() for a in (jp, jq, Om, be, bp, bquat, mt.body_size,
                                params, mt.ground_pos, mt.ground_normal, xi)]
    rng = np.random.RandomState(1)
    per_lane = params.numpy()[:, :, None] * rng.uniform(0.5, 1.5,
                                                        params.shape + (B,))
    return dict(name=name, sj=sj, mj=mj, st=st, mt=mt, q=q, v=v, args=args,
                per_lane=per_lane, pw_t=pw_t)


def _with_params(sc, per_lane):
    args = list(sc["args"])
    if per_lane:
        args[7] = sc["per_lane"]
    return args


def _assert_close(got, want, tol, what):
    for g, w, name in zip(got, want, ("F", "Tau", "tac")):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        if w.size == 0:       # a scene without tactile markers
            continue
        scale = float(np.max(np.abs(w))) + 1e-6
        err = float(np.max(np.abs(g - w)))
        assert err <= tol * scale, (what, name, err, scale)


def test_contacts_are_active(scene):
    F, Tau, tac = scene["pw_t"](*[torch.as_tensor(a)
                                  for a in scene["args"]])
    assert float(torch.max(torch.abs(F))) > 1e-3
    if tac.numel():
        assert float(torch.max(torch.abs(tac))) > 1e-3


@pytest.mark.parametrize("per_lane", [False, True], ids=["static", "lanes"])
def test_f32_matches_pallas_kernel_and_twin(scene, per_lane):
    args = [np.asarray(a, np.float32) for a in _with_params(scene, per_lane)]
    pw_j, _ = jax_lc.make_pair_wrenches(scene["sj"], interpret=True)
    want_kernel = pw_j(*[jnp.asarray(a) for a in args])
    want_twin = pw_j.reference(*[jnp.asarray(a) for a in args])
    got = scene["pw_t"](*[torch.as_tensor(a) for a in args])
    assert all(g.dtype == torch.float32 for g in got)
    _assert_close(got, want_kernel, 3e-6, "kernel")
    _assert_close(got, want_twin, 3e-6, "twin")
    assert scene["pw_t"].launches == 0     # the CPU route launches nothing


@pytest.mark.parametrize("per_lane", [False, True], ids=["static", "lanes"])
def test_f64_matches_jax_twin(scene, per_lane):
    args = _with_params(scene, per_lane)
    pw_j, _ = jax_lc.make_pair_wrenches(scene["sj"], interpret=True)
    want = pw_j.reference(*[jnp.asarray(a) for a in args])
    got = scene["pw_t"](*[torch.as_tensor(a) for a in args])
    _assert_close(got, want, 1e-10, "twin f64")


def test_vjp_matches_jax(scene):
    args = _with_params(scene, True)
    pw_j, _ = jax_lc.make_pair_wrenches(scene["sj"], interpret=True)
    outs, pullback = jax.vjp(pw_j.reference, *[jnp.asarray(a) for a in args])
    rng = np.random.RandomState(2)
    cots = [rng.randn(*o.shape) for o in outs]
    want = pullback(tuple(jnp.asarray(c) for c in cots))

    ins = [torch.as_tensor(a).requires_grad_() for a in args]
    got_outs = scene["pw_t"](*ins)
    got = torch.autograd.grad(got_outs, ins,
                              [torch.as_tensor(c) for c in cots],
                              allow_unused=True)
    for g, w, name in zip(got, want, torch_lc._ARG_NAMES):
        w = np.asarray(w)
        if g is None:          # an input no segment reads (gpos w/o ground)
            assert not np.any(w), name
            continue
        scale = float(np.max(np.abs(w))) + 1e-12
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= 1e-10 * scale, (name, err, scale)


def test_contact_terms_fused_matches_jax_contact_terms(scene):
    sj, mj, st, mt = scene["sj"], scene["mj"], scene["st"], scene["mt"]
    q, v = scene["q"], scene["v"]
    Qj, tacj = jax_lanes.contact_terms(sj, mj, jnp.asarray(q), jnp.asarray(v))
    pw, meta = torch_lc.make_pair_wrenches(st)
    Qt, tact = torch_lanes.contact_terms_fused(
        st, mt, torch.as_tensor(q), torch.as_tensor(v), pw, meta)
    # the plain group loop (the port's own oracle) agrees as well
    Qp, tacp = torch_lanes.contact_terms(st, mt, torch.as_tensor(q),
                                         torch.as_tensor(v))
    for g, w, name in ((Qt, Qj, "Q"), (tact, tacj, "tac"), (Qp, Qj, "Q plain"),
                       (tacp, tacj, "tac plain")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if w.size == 0:
            continue
        scale = float(np.max(np.abs(w)))
        assert scale > 1e-6, name
        assert float(np.max(np.abs(g.numpy() - w))) <= 1e-10 * scale, name


def test_chord_jacobian_recomputes_twin_once():
    """The chord factor's n pullbacks share ONE twin recompute."""
    st, mt = torch_scenes.tactile_push()
    q, v = contact_state("tactile_push", mt.q_init.numpy(), B, seed=3)
    q, v = torch.as_tensor(q), torch.as_tensor(v)
    pw, meta = torch_lc.make_pair_wrenches(st)
    residual = torch_lanes.make_residual(st, (pw, meta))
    inputs = torch_lanes.StepInputs(
        model=mt, u=torch.zeros(st.ndof_u, B, dtype=torch.float64),
        q_base=q, p_base=torch_lanes.momentum(st, mt, q, v),
        gamma=mt.h.reshape(1, 1))
    torch_lanes.make_chord_lu(residual, inputs, v)
    assert (pw.launches, pw.twin_vjps, pw.twin_recomputes) == \
        (0, st.ndof_q, 1)


def test_jax_combined_params_match(scene):
    want = np.asarray(jax_contact.combined_params(scene["mj"]))
    np.testing.assert_array_equal(scene["args"][7], want)
