"""The port's chord-solve adjoint (``sim/lanes.py``) against the JAX package,
float64 on the CPU.

- ``gauss_solve_T`` against JAX's, to rtol 1e-12;
- the exact IFT adjoint (``chord_solve``'s backward) against JAX's
  ``lanes._chord_bwd(..., 'exact', (inputs, v*, lu), g)``, called eagerly at
  the same contact-active state and v*, to rtol 1e-8 on the u, q_base and
  p_base cotangents (both are the same linear algebra on residual graphs
  that agree to 1e-9, tests/test_torch_lanes.py);
- the exact adjoint of one implicit solve at a pad-on-box state against
  central finite differences of its Newton-converged solution, in both
  contact-torque conventions (below);
- the env step's gradient w.r.t. (q0, qd0, u) against central finite
  differences of the port's own forward (JAX's env step is not
  differentiated here: its CPU compile alone takes minutes).

The chord stops at max(tol, 1e-7 |r0|) in float64, so v* carries a solve
error of about 1e-7 relative that differs between x + eps d and x - eps d;
the at-solution adjoint is the derivative of the exact solution. FD and
adjoint therefore agree to about that level, and the test holds them to
1e-5 relative, with a 20-sweep budget so that both sides converge alike.

The env-step FD check runs with the box pressed into the ground and the pad
off the box. Where a contact has a primitive body (pad on box), the lanes
path's pullback holds the primitive side's application point fixed in the
primitive's frame (the JAX package's lanes convention, ``stop_gradient`` in
``lanes.contact_terms``): there its adjoint is not the derivative of the
solution, and one implicit solve's FD parts from it by 2.6e-3 to 2.6e-1
per lane. The
megastep's convention (``moving_point``: the torque at the moving contact
point, the JAX package's ``megastep``) is the derivative: FD agrees to the
FD step's error (5e-8 measured). That check uses a solve converged by
Newton, since at a pad-on-box state with controls the chord of an env
step does not converge from its entry factor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from chip_smoke import resting_contact
from tactilesimulation_tpu.sim import lanes as jax_lanes
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import lane_contact as torch_lc
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes

torch.set_num_threads(1)

B = 3


@pytest.fixture(scope="module")
def scene():
    sj, mj = jax_scenes.tactile_push()
    st, mt = torch_scenes.tactile_push()
    # at rest, the pad pressed into the box and the box into the ground:
    # contact is active in every lane (off-axis offsets or random
    # velocities put the pad on the box's edge)
    q, v = resting_contact(np.asarray(mj.q_init), B, 4)
    rng = np.random.RandomState(4)
    rng.uniform(size=2 * B)               # the state's draws, then controls
    u = 0.3 * rng.randn(st.ndof_u, B)
    return dict(sj=sj, mj=mj, st=st, mt=mt, q=q, v=v, u=u)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def test_gauss_solve_T_matches_jax():
    rng = np.random.RandomState(0)
    n = 7
    A = rng.randn(n, n, B) + 4.0 * np.eye(n)[:, :, None]
    b = rng.randn(n, B)
    lu_t = torch_lanes.gauss_factor(_t(A))
    got = torch_lanes.gauss_solve_T(lu_t, _t(b))
    want = jax_lanes.gauss_solve_T(jax_lanes.gauss_factor(jnp.asarray(A)),
                                   jnp.asarray(b))
    _close(got, want, 1e-12)
    # and it solves A^T x = b
    x = got.numpy()
    np.testing.assert_allclose(np.einsum("kib,kb->ib", A, x), b, atol=1e-12)


@pytest.fixture(scope="module")
def adjoint_case(scene):
    """A Newton-converged, contact-active v*, a cotangent g, and JAX's
    exact adjoint there (jit-compiled once: eager dispatch of the same
    function takes longer than its compile)."""
    sj, mj, st, mt = (scene[k] for k in ("sj", "mj", "st", "mt"))
    q, v, u = scene["q"], scene["v"], scene["u"]
    res_t = torch_lanes.make_residual(st)
    it = torch_lanes.StepInputs(
        model=mt, u=_t(u), q_base=_t(q),
        p_base=torch_lanes.momentum(st, mt, _t(q), _t(v)),
        gamma=mt.h.reshape(1, 1))
    v_star = _t(v)
    for _ in range(5):      # Newton: v* to round-off
        lu = torch_lanes.make_chord_lu(res_t, it, v_star)
        v_star = v_star - torch_lanes.gauss_solve(lu, res_t(v_star, it))
    assert float(torch.linalg.norm(res_t(v_star, it), dim=0).max()) < 1e-12
    g = np.random.RandomState(11).randn(st.ndof_q, B)

    res_j = jax_lanes.make_residual(sj)
    ij = jax_lanes.StepInputs(model=mj, u=jnp.asarray(u),
                              q_base=jnp.asarray(q),
                              p_base=jnp.asarray(it.p_base.numpy()),
                              gamma=jnp.full((1, 1), float(mj.h)))
    bwd = jax.jit(lambda inputs, vs, lu_, gg: jax_lanes._chord_bwd(
        res_j, 8, 1e-8, "exact", (inputs, vs, lu_), gg))
    want, gv, _ = bwd(ij, jnp.asarray(v_star.numpy()),
                      jnp.asarray(lu.numpy()), jnp.asarray(g))
    assert float(jnp.max(jnp.abs(gv))) == 0.0
    return it, v_star, g, want


@pytest.fixture(scope="module")
def solve_fd(scene, adjoint_case):
    """Central FD of <g, v*(u, q_base, p_base)> per lane along two random
    directions, v* converged by Newton (the residual's value is the same in
    both conventions; the moving-point Jacobian is its derivative). The
    step is 1e-7: at 1e-5 a step crosses a kink of the contact law (1e-2
    apart on one lane), at 1e-7 the FD error is about 5e-8."""
    st, mt = scene["st"], scene["mt"]
    it, v_star, g, _ = adjoint_case
    exact = torch_lanes.make_residual(st, moving_point=True)
    rng = np.random.RandomState(12)
    eps = 1e-7

    def solve(d, sign):
        x = torch_lanes.StepInputs(
            model=mt, u=it.u + sign * eps * d[0],
            q_base=it.q_base + sign * eps * d[1],
            p_base=it.p_base + sign * eps * d[2], gamma=it.gamma)
        v = v_star
        for _ in range(3):
            lu = torch_lanes.make_chord_lu(exact, x, v)
            v = v - torch_lanes.gauss_solve(lu, exact(v, x))
        assert float(torch.linalg.norm(exact(v, x), dim=0).max()) < 1e-11
        return v

    out = []
    for _ in range(2):
        d = [_t(rng.randn(*a.shape)) for a in (it.u, it.q_base, it.p_base)]
        dv = solve(d, 1) - solve(d, -1)
        out.append((d, torch.sum(_t(g) * dv, dim=0) / (2 * eps)))
    return out


# per lane, |adjoint - FD| / |FD|: the megastep's convention is the
# derivative (FD agrees to the FD step's error); the lanes convention parts
# from it, pinned so that the documents stay true
@pytest.mark.parametrize("moving_point", [True, False],
                         ids=["megastep", "lanes"])
def test_chord_adjoint_conventions_against_fd(scene, adjoint_case, solve_fd,
                                              moving_point):
    it, v_star, g, _ = adjoint_case
    bars = torch_lanes.chord_adjoint(
        torch_lanes.make_residual(scene["st"], moving_point=moving_point),
        it, v_star, _t(g))
    gaps = []
    for d, fd in solve_fd:
        an = sum(torch.sum(b * x, dim=0) for b, x in zip(bars, d))
        gaps += (torch.abs(an - fd) / torch.abs(fd)).tolist()
    print(f"moving_point={moving_point}: |adjoint - FD| / |FD| per lane "
          f"and direction: " + ", ".join(f"{x:.2e}" for x in gaps))
    if moving_point:
        assert max(gaps) <= 1e-6
    else:
        assert max(gaps) >= 1e-3


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_chord_adjoint_matches_jax(scene, adjoint_case, fused):
    it, v_star, g, want = adjoint_case
    pw = torch_lc.make_pair_wrenches(scene["st"]) if fused else None
    got = torch_lanes.chord_adjoint(
        torch_lanes.make_residual(scene["st"], pw), it, v_star, _t(g))
    for name, gt in zip(("u", "q_base", "p_base"), got):
        _close(gt, getattr(want, name), 1e-8)
    assert float(np.max(np.abs(got[0].numpy()))) > 0


def test_env_step_gradient_matches_fd(scene):
    st, mt = scene["st"], scene["mt"]
    rng = np.random.RandomState(6)
    q = _t(scene["q"])
    q[1] = -0.002                            # the pad off the box
    v = _t(0.01 * rng.randn(*q.shape))
    u = _t(scene["u"])
    step = torch_lanes.build_env_step(st, 5, max_iter=20,
                                      fused_pw=torch_lc.make_pair_wrenches(st))
    wq, wv = _t(rng.randn(*q.shape)), _t(rng.randn(*q.shape))

    def loss(q0, qd0, uu):
        s = step(mt, torch_lanes.LaneSimState(
            q=q0, qdot=qd0, q_prev=q0, qdot_prev=qd0,
            t=torch.zeros(B, dtype=torch.int32)), uu)
        return (torch.sum(wq * s.q) + 1e-2 * torch.sum(wv * s.qdot)
                + torch.sum(s.q_prev ** 2))

    xs = [x.clone().requires_grad_() for x in (q, v, u)]
    grads = torch.autograd.grad(loss(*xs), xs)
    eps = 1e-6
    for k in range(2):
        d = [_t(rng.randn(*x.shape)) for x in (q, v, u)]
        with torch.no_grad():
            lp = loss(*[x + eps * dx for x, dx in zip((q, v, u), d)])
            lm = loss(*[x - eps * dx for x, dx in zip((q, v, u), d)])
        fd = float(lp - lm) / (2 * eps)
        an = float(sum(torch.sum(g * dx) for g, dx in zip(grads, d)))
        assert abs(fd - an) <= 1e-5 * max(abs(fd), abs(an)), (k, fd, an)
