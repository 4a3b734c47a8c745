"""The lanes chord solve's adjoint modes against the JAX package's,
float64 on the CPU: every ``bwd_mode`` but exact (stale and refine3, then
fwdfac and bare refine) through the port's ``chord_solve`` (its forward,
which factors the exact J at v* for fwdfac, and its backward,
``chord_bwd``) against JAX's ``_chord_fwd`` / ``_chord_bwd``, at the
``tests/test_torch_adjoint.py`` state (pad pressed into the box, v*
converged by Newton), to 1e-8 of scale, on the plain contact path and
through the pair-wrench op's CPU route (whose pullbacks count the K1T
launches the card makes). The stale factor is the chord factor at the
entry velocity, where refinement contracts on every lane, so no per-lane
choice of the best iterate ties. Exact is held to JAX's by
tests/test_torch_adjoint.py; fwdfac is also held to exact, and bare refine
to refine2, port against port.

JAX's residual is its own ``make_residual``, jitted once (its pullbacks
then run compiled: eager, each adjoint takes 25-80 s on a CPU). A file
of its own with few tests, so that ``--dist loadfile`` (files with more
tests first) runs it beside the suite's longest files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import resting_contact
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import lanes as jax_lanes
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import lane_contact as torch_lc
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes

torch.set_num_threads(1)

B = 3
MODES = ["stale", "refine3", "fwdfac", "refine"]
# the op's CPU route's pullbacks per chord solve: K1T launches on the card
# (fwdfac: n = 7 for the factor at v* in the forward, 1 in the backward)
K1T = {"stale": 1, "refine3": 5, "fwdfac": 8, "refine": 4}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def scenes():
    """(JAX structure, model, port structure, model, JAX's residual
    jitted)."""
    sj, mj = jax_scenes.tactile_push()
    st, mt = torch_scenes.tactile_push()
    return sj, mj, st, mt, jax.jit(jax_lanes.make_residual(sj))


@pytest.fixture(scope="module")
def adjoint_state(scenes):
    """The test_torch_adjoint state: v* by Newton, the entry factor, g, and
    JAX's adjoint of every mode there."""
    sj, mj, st, mt, res_j = scenes
    q, v = resting_contact(np.asarray(mj.q_init), B, 4)
    rng = np.random.RandomState(4)
    rng.uniform(size=2 * B)
    u = 0.3 * rng.randn(st.ndof_u, B)
    res_t = torch_lanes.make_residual(st)
    it = torch_lanes.StepInputs(
        model=mt, u=_t(u), q_base=_t(q),
        p_base=torch_lanes.momentum(st, mt, _t(q), _t(v)),
        gamma=mt.h.reshape(1, 1))
    v_star = _t(v)
    for _ in range(5):
        lu = torch_lanes.make_chord_lu(res_t, it, v_star)
        v_star = v_star - torch_lanes.gauss_solve(lu, res_t(v_star, it))
    g = np.random.RandomState(11).randn(st.ndof_q, B)
    ij = jax_lanes.StepInputs(model=mj, u=jnp.asarray(u),
                              q_base=jnp.asarray(q),
                              p_base=jnp.asarray(it.p_base.numpy()),
                              gamma=jnp.full((1, 1), float(mj.h)))
    lu_entry = torch_lanes.make_chord_lu(res_t, it, _t(v))
    v_j, lu_j = jnp.asarray(v_star.numpy()), jnp.asarray(lu_entry.numpy())
    want = {}
    for mode in MODES:
        # the forward's residuals: (inputs, v*, the factor the backward
        # takes): the entry factor, or for fwdfac the exact J at v*
        # factored by JAX's forward (max_iter 0: v* is the converged
        # iterate already)
        _, res = jax_lanes._chord_fwd(res_j, 0, 1e-12, mode, ij, v_j, lu_j)
        want[mode] = jax_lanes._chord_bwd(res_j, 0, 1e-12, mode, res,
                                          jnp.asarray(g))[0]
    return it, v_star, lu_entry, _t(g), want


def _matches_jax(scenes, adjoint_state, mode):
    """The port's chord solve at v* (no sweep), its gradient into (u,
    q_base, p_base) for the cotangent g, against JAX's, plain and fused."""
    st, mt = scenes[2:4]
    it, v_star, lu_entry, g, want = adjoint_state
    for pw in (None, torch_lc.make_pair_wrenches(st)):
        res = torch_lanes.make_residual(st, pw)
        wrt = [x.clone().requires_grad_() for x in (it.u, it.q_base,
                                                    it.p_base)]
        inputs = torch_lanes.StepInputs(model=mt, u=wrt[0], q_base=wrt[1],
                                        p_base=wrt[2], gamma=it.gamma)
        v = torch_lanes.chord_solve(res, 0, 1e-12, mode, inputs, v_star,
                                    lu_entry)
        assert torch.equal(v, v_star)
        got = torch.autograd.grad(v, wrt, g)
        for name, gt in zip(("u", "q_base", "p_base"), got):
            _close(gt, getattr(want[mode], name), 1e-8)
    assert pw[0].twin_vjps == K1T[mode]


@pytest.mark.parametrize("mode", ["stale", "refine3"])
def test_chord_bwd_matches_jax(scenes, adjoint_state, mode):
    _matches_jax(scenes, adjoint_state, mode)


def test_chord_bwd_fwdfac_and_bare_refine(scenes, adjoint_state):
    """fwdfac and bare refine against JAX's as above; and port against
    port: ``fwdfac`` solves with the exact J at v* factored in the
    forward, the matrix of ``exact`` factored untransposed, so the two
    agree to round-off; bare ``refine`` is ``refine2``, bit for bit."""
    for mode in ("fwdfac", "refine"):
        _matches_jax(scenes, adjoint_state, mode)
    st = scenes[2]
    it, v_star, lu_entry, g, _ = adjoint_state
    res = torch_lanes.make_residual(st)
    exact = torch_lanes.chord_bwd(res, "exact", it, v_star, None, g)
    fwdfac = torch_lanes.chord_bwd(
        res, "fwdfac", it, v_star,
        torch_lanes.make_chord_lu(res, it, v_star), g)
    for a, b in zip(fwdfac, exact):
        _close(a, b, 1e-10)
    bare = torch_lanes.chord_bwd(res, "refine", it, v_star, lu_entry, g)
    two = torch_lanes.chord_bwd(res, "refine2", it, v_star, lu_entry, g)
    assert all(torch.equal(a, b) for a, b in zip(bare, two))
