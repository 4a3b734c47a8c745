"""iLQR (``algorithms/ilqr.py``) against the JAX package's, float64 on the
CPU.

On the pendulum of tests/test_torch_trajopt.py (H = 5 steps of 0.1 s, the
swing towards pi / 2), 3 iterations: cost history, best controls and best
cost to 1e-9 relative, and every iteration improves. At JAX's 0.01 s step
the problem is almost linear-quadratic: by the third iteration the line
search's candidates tie at round-off (1e-15 of the cost) and the two
packages pick different step lengths, so the test takes 0.1 s steps,
where each iteration still gains. JAX's iLQR is one jitted program (its
trace and compile about 70-130 s on a CPU).

On TactilePush, one single-instance state with the pad pressed into the
box and the box into the ground (``chip_smoke.resting_contact``, moving), a control off
zero: A = df/ds and B = df/du of one step in the packed state s = [q, qdot,
q_prev, qdot_prev] (28) from ``ILQROptimizer.dynamics_jacobians`` (rows
pulled back through the solve's implicit-function adjoint, one residual
graph and one factor of J shared by the rows) against ``jax.jacrev`` of
the JAX package's single-instance step, to 1e-8 of scale. They also equal
those built without sharing (a fresh J per row), bit for bit, in fewer
eager ops (printed; ``-s`` shows them).

A file of its own, with few tests: the JAX step's jitted ``jacrev`` costs
about 130 s to trace and compile on a CPU, and ``--dist loadfile`` runs the
file beside the suite's longest ones.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import AtenCount, resting_contact
from test_torch_trajopt import H, US0, _check, _cost, _cost_jax, sims  # noqa: F401
from tactilesimulation_tpu.algorithms.ilqr import ILQROptimizer as JaxILQR
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import integrators as jax_integrators
from tactilesimulation_tpu.sim.types import SimState as JaxSimState
from tactilesimulation_tpu_torch.algorithms import ilqr
from tactilesimulation_tpu_torch.model import task_scenes
from tactilesimulation_tpu_torch.sim import integrators
from tactilesimulation_tpu_torch.sim.simulation import Simulator

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ilqr_jax(sims):
    simj, _ = sims
    opt = JaxILQR(simj, H, _cost_jax, iterations=3)
    return opt.solve(simj.model, simj.init_state(), jnp.asarray(US0))


def test_ilqr_matches_jax(sims, ilqr_jax):
    _, sim = sims
    opt = ilqr.ILQROptimizer(sim, H, _cost, iterations=3)
    got = opt.solve(sim.model, sim.init_state(), torch.tensor(US0))
    _check(got, ilqr_jax)
    hist = got[2].numpy()
    assert np.all(np.diff(hist) < -1e-7 * hist[0])


def test_dynamics_jacobians_match_jax(monkeypatch):
    sj, mj = jax_scenes.tactile_push()
    st, mt = task_scenes.tactile_push()
    mt = mt.to("cpu", torch.float64)
    n = st.ndof_q
    q, v = resting_contact(np.asarray(mj.q_init), 1, 3, pad_speed=0.01)
    q, v = q[:, 0], v[:, 0]
    rng = np.random.RandomState(5)
    qp, vp = q - 1e-5 * rng.randn(n), v + 1e-3 * rng.randn(n)
    s = np.concatenate([q, v, qp, vp])
    u = 0.3 * rng.randn(st.ndof_u)

    step_j = jax_integrators.build_step(sj)

    def f(s_, u_):
        state = JaxSimState(q=s_[:n], qdot=s_[n:2 * n], q_prev=s_[2 * n:3 * n],
                            qdot_prev=s_[3 * n:], t=jnp.zeros((), jnp.int32))
        out = step_j(mj, state, u_)
        return jnp.concatenate([out.q, out.qdot, out.q_prev, out.qdot_prev])

    A_j, B_j = jax.jit(jax.jacrev(f, argnums=(0, 1)))(jnp.asarray(s),
                                                      jnp.asarray(u))

    opt = ilqr.ILQROptimizer(Simulator(st, mt), 1, lambda state, uu: 0.0)
    t0 = torch.zeros((), dtype=torch.int32)
    args = (mt, torch.tensor(s), torch.tensor(u), t0)
    with AtenCount() as shared_ops:
        A, B = opt.dynamics_jacobians(*args)
    for got, want in ((A, A_j), (B, B_j)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-8 * float(np.abs(want).max()))
    assert float(B[:2 * n].abs().max()) > 0
    assert integrators._SHARED[0] == 0

    # the shared residual graph and factor change no number, in fewer ops
    monkeypatch.setattr(integrators, "shared_adjoint", contextlib.nullcontext)
    with AtenCount() as fresh_ops:
        A_f, B_f = opt.dynamics_jacobians(*args)
    assert torch.equal(A_f, A) and torch.equal(B_f, B)
    print(f"A, B of one TactilePush step: {shared_ops.n} eager ops with a "
          f"shared factor of J, {fresh_ops.n} with a fresh one per row")
    assert shared_ops.n < 0.6 * fresh_ops.n
