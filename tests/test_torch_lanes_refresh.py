"""One env step of the lanes stepper at chord refresh 1 and 2
(``lanes.build_env_step(refresh=r)``) against the JAX package's, float64
on the CPU: B = 3 lanes of TactilePush with the pad pressed into the box,
forward, to 1e-6 relative (the bar and reason of
tests/test_torch_lanes.py::test_env_step: a lane whose residual norm
straddles the tolerance can take one more masked chord iteration on one
side), and the twin's pullbacks counting one chord factor at each substep
of the schedule.

JAX's refresh-2 step is its own (substeps unrolled, factors at 0, 2 and
4). Its refresh-1 step is a ``lax.scan`` of its one-substep step (factor,
then chord), whose compile takes minutes on a CPU, so the test chains that
one-substep step, ``build_env_step(frame_skip=1)``, five times;
tests/test_torch_lanes_solver.py reads JAX's schedule itself. JAX's env
step takes its own ``make_residual`` and ``momentum`` jitted in place of
its module's, and its fused-contact branch (``fused_pw`` set), so that it
factors J by reverse-mode pullbacks as the port does, with the plain
residual (its Pallas kernel in interpret mode would take minutes). A file
of its own with few tests, so that ``--dist loadfile`` (files with more
tests first) runs it beside the suite's longest files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import lanes as jax_lanes
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import lane_contact as torch_lc
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes

torch.set_num_threads(1)

B = 3


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
    """(JAX structure, model, port structure, model, JAX's residual and
    momentum jitted)."""
    sj, mj = jax_scenes.tactile_push()
    st, mt = torch_scenes.tactile_push()
    momentum = jax_lanes.momentum
    return (sj, mj, st, mt, jax.jit(jax_lanes.make_residual(sj)),
            jax.jit(lambda m, q, v: momentum(sj, m, q, v)))


@pytest.mark.parametrize("refresh", [1, 2])
def test_env_step_refresh_matches_jax(scenes, refresh):
    sj, mj, st, mt, res_j, momentum_j = scenes
    n = st.ndof_q
    rng = np.random.RandomState(0)
    q = np.asarray(mj.q_init)[:, None] + 0.01 * rng.randn(n, B)
    q[1] = rng.uniform(0.0005, 0.003, B)     # pad pressing on the box
    q[5] = rng.uniform(-0.0005, 0.0, B)      # box pressing on the ground
    v = 0.01 * rng.randn(n, B)
    u = 0.3 * rng.randn(st.ndof_u, B)
    s_j = jax_lanes.LaneSimState(
        q=jnp.asarray(q), qdot=jnp.asarray(v), q_prev=jnp.asarray(q),
        qdot_prev=jnp.asarray(v), t=jnp.zeros(B, jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lanes, "make_residual", lambda struct, pw=None: res_j)
        mp.setattr(jax_lanes, "momentum",
                   lambda struct, m, q, v: momentum_j(m, q, v))
        fused = (None, None)     # the fused branch: J by reverse mode
        if refresh == 2:
            s_j = jax_lanes.build_env_step(sj, 5, refresh=2,
                                           fused_pw=fused)(mj, s_j,
                                                           jnp.asarray(u))
        else:
            one = jax_lanes.build_env_step(sj, 1, refresh=1, fused_pw=fused)
            for _ in range(5):
                s_j = one(mj, s_j, jnp.asarray(u))
    pw = torch_lc.make_pair_wrenches(st)
    s_t = torch_lanes.build_env_step(st, 5, refresh=refresh, fused_pw=pw)(
        mt, torch_lanes.LaneSimState(q=_t(q), qdot=_t(v), q_prev=_t(q),
                                     qdot_prev=_t(v),
                                     t=torch.zeros(B, dtype=torch.int32)),
        _t(u))
    for a, b in zip(s_t[:4], s_j[:4]):
        _close(a, b, 1e-6)
    np.testing.assert_array_equal(s_t.t.numpy(), np.asarray(s_j.t))
    # one chord factor (n twin pullbacks) at each substep of the schedule
    assert pw[0].twin_vjps == n * {1: 5, 2: 3}[refresh]
