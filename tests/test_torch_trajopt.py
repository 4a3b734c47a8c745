"""The port's trajectory optimisers (``algorithms/shooting.py``,
``algorithms/ilqr.py``) against the JAX package's, float64 on the CPU, on
the pendulum (H = 5 steps of 0.1 s, swing towards pi / 2, the cost of
JAX's ``tests/test_ilqr.py``):

- ``ShootingOptimizer`` (4 Adam iterations, lr 0.1) with an active
  control bound, with and without remat: cost history, best controls and
  best cost to 1e-9 relative. The starting controls stay off the bound
  (``jnp.clip`` and ``torch.clamp`` may split a gradient differently at a
  tie); one of them starts past it, so the clip acts;
- ``ILQROptimizer`` against JAX's: tests/test_torch_ilqr_push.py;
- the model argument is the one used (a heavier pendulum changes both
  optimisers' results); multistart and ``mpc_step`` shapes.

JAX's optimiser is one jitted program: its trace and compile (about 50 s
on a CPU) take most of this file's time.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tactilesimulation_tpu.algorithms.shooting import \
    ShootingOptimizer as JaxShooting
from tactilesimulation_tpu.model import scenes as jax_scenes
from tactilesimulation_tpu.sim.simulation import Simulator as JaxSimulator
from tactilesimulation_tpu_torch.algorithms.ilqr import ILQROptimizer
from tactilesimulation_tpu_torch.algorithms.shooting import \
    ShootingOptimizer
from tactilesimulation_tpu_torch.model import scenes
from tactilesimulation_tpu_torch.sim.simulation import Simulator

torch.set_num_threads(1)

H = 5
BOUNDS = (-2.0, 0.35)
US0 = np.array([[0.3], [-0.2], [0.5], [0.1], [-0.4]])  # 0.5 past the bound


def _cost_jax(state, u):
    return ((state.q[0] - jnp.pi / 2) ** 2 + 0.05 * state.qdot[0] ** 2
            + 1e-3 * jnp.sum(u ** 2))


def _cost(state, u):
    return ((state.q[0] - np.pi / 2) ** 2 + 0.05 * state.qdot[0] ** 2
            + 1e-3 * torch.sum(u ** 2))


@pytest.fixture(scope="module")
def sims():
    sj, mj = jax_scenes.pendulum(timestep=0.1, damping=0.05)
    st, mt = scenes.pendulum(timestep=0.1, damping=0.05)
    return JaxSimulator(sj, mj), Simulator(st, mt.to("cpu", torch.float64))


def _close(got, want, rtol=1e-9):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def _check(got, want):
    for g, w in zip(got, want):
        _close(g, w)


@pytest.fixture(scope="module")
def shooting_jax(sims):
    simj, _ = sims
    opt = JaxShooting(simj, H, _cost_jax, u_bounds=BOUNDS, iterations=4,
                      lr=0.1, remat=False)
    return opt.solve(simj.model, simj.init_state(), jnp.asarray(US0))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_shooting_matches_jax(sims, shooting_jax, remat):
    _, sim = sims
    opt = ShootingOptimizer(sim, H, _cost, u_bounds=BOUNDS, iterations=4,
                            lr=0.1, remat=remat)
    got = opt.solve(sim.model, sim.init_state(), torch.tensor(US0))
    _check(got, shooting_jax)
    assert float(got[1]) < float(got[2][0])          # it improved


def test_model_argument_is_used(sims):
    _, sim = sims
    m = sim.model
    heavy = type(m)(**{**m.__dict__, "body_mass": m.body_mass * 3.0,
                       "body_inertia": m.body_inertia * 3.0})
    us0 = torch.tensor(US0)
    for opt in (ShootingOptimizer(sim, H, _cost, iterations=1),
                ILQROptimizer(sim, H, _cost, iterations=1)):
        _, c_nom, _ = opt.solve(m, sim.init_state(), us0)
        _, c_heavy, _ = opt.solve(heavy, sim.init_state(heavy), us0)
        assert abs(float(c_nom) - float(c_heavy)) > 1e-8


def test_multistart_and_mpc_shapes(sims):
    _, sim = sims
    gen = torch.Generator().manual_seed(0)
    nu = sim.struct.ndof_u
    for opt, mpc in ((ShootingOptimizer(sim, H, _cost, iterations=1),
                      {"replan_iters": 1}),
                     (ILQROptimizer(sim, H, _cost, iterations=1), {})):
        us, c = opt.solve_multistart(sim.model, sim.init_state(), 2,
                                     generator=gen)
        assert us.shape == (H, nu) and bool(torch.isfinite(c))
        u0, plan = opt.mpc_step(sim.model, sim.init_state(), us, **mpc)
        assert u0.shape == (nu,) and plan.shape == us.shape
