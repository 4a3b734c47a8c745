"""The port's single-instance sim core against the JAX package (f64).

On RollingBall 8x8 (the pad pressed onto the ball, the ball on the ground)
and TactilePush (the pad pressed into the box, the box into the ground), at
seeded states in contact, to 1e-10 of each output's scale:
- FK: ``fk_bodies``, ``fk_all``, ``tactile_frames_world``,
  ``contact_points_world``, ``tactile_points_world``, ``ee_positions``;
- dynamics: ``el_terms``, ``momentum``, ``mass_matrix`` (the port takes the
  body velocities from the joints' twists, JAX from a JVP of FK);
- contact: the row-major ``dynamics.contact_terms`` and ``tactile_field``
  and the points-major ``dense_single.contact_terms_points_major``.
The JAX side is one jitted function per scene. Also: a graph built under
``dynamics.inner_graph`` is freed with its last reference, one kept for the
outer graph is packed by a caller's hooks, and BPTT under a non-reentrant
checkpoint leaves nothing behind.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.sim import dense_single as jax_ds
from tactilesimulation_tpu.sim import dynamics as jax_dyn
from tactilesimulation_tpu.sim import kinematics as jax_kin
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.sim import dense_single, dynamics, kinematics

torch.set_num_threads(1)

TOL = 1e-10


def contact_state(name, q_init, seed=0):
    rng = np.random.RandomState(seed)
    q = q_init + 1e-3 * rng.randn(q_init.shape[0])
    if name == "tactile_push":
        q[1] = 0.002                     # pad into the box
        q[5] = -0.0005                   # box into the ground
    else:
        q[2] = -0.0175                   # pad onto the ball
        q[5] = -0.0005                   # ball into the ground
    return q, 0.1 * rng.randn(q_init.shape[0])


def _jax_outputs(sj):
    def fn(m, q, v):
        out = {"fk_bodies": jax_kin.fk_bodies(sj, m, q),
               "fk_all": jax_kin.fk_all(sj, m, q),
               "frames": jax_kin.tactile_frames_world(sj, m, q),
               "contact_points": jax_kin.contact_points_world(sj, m, q),
               "tactile_points": jax_kin.tactile_points_world(sj, m, q),
               "ee": jax_kin.ee_positions(sj, m, q),
               "el_terms": jax_dyn.el_terms(sj, m, q, v),
               "momentum": jax_dyn.momentum(sj, m, q, v),
               "mass": jax_dyn.mass_matrix(sj, m, q),
               "contact": jax_dyn.contact_terms(sj, m, q, v),
               "tactile": jax_dyn.tactile_field(sj, m, q, v),
               "points_major": jax_ds.contact_terms_points_major(sj, m, q, v)}
        return out
    return jax.jit(fn)


@pytest.fixture(scope="module", params=["rolling_ball_8", "tactile_push"])
def scene(request):
    name = request.param
    build = {"rolling_ball_8": lambda m: m.rolling_ball(resolution=8),
             "tactile_push": lambda m: m.tactile_push()}[name]
    sj, mj = build(jax_scenes)
    st, _ = build(torch_scenes)
    mt = convert.model_from_numpy({f.name: np.asarray(getattr(mj, f.name))
                                   for f in dataclasses.fields(mj)})
    q, v = contact_state(name, np.asarray(mj.q_init))
    want = jax.tree.map(np.asarray,
                        _jax_outputs(sj)(mj, jnp.asarray(q), jnp.asarray(v)))
    return dict(st=st, mt=mt, q=torch.as_tensor(q), v=torch.as_tensor(v),
                want=want)


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    got = got.detach().numpy()
    assert got.shape == want.shape
    if want.size:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= TOL * scale


def test_kinematics(scene):
    st, mt, q, want = scene["st"], scene["mt"], scene["q"], scene["want"]
    _close(kinematics.fk_bodies(st, mt, q), want["fk_bodies"])
    _close(kinematics.fk_all(st, mt, q), want["fk_all"])
    _close(kinematics.tactile_frames_world(st, mt, q), want["frames"])
    _close(kinematics.contact_points_world(st, mt, q),
           want["contact_points"])
    _close(kinematics.tactile_points_world(st, mt, q),
           want["tactile_points"])
    _close(kinematics.ee_positions(st, mt, q), want["ee"])


def test_dynamics(scene):
    st, mt, q, v, want = (scene[k] for k in ("st", "mt", "q", "v", "want"))
    _close(dynamics.el_terms(st, mt, q, v), want["el_terms"])
    _close(dynamics.momentum(st, mt, q, v), want["momentum"])
    _close(dynamics.mass_matrix(st, mt, q), want["mass"])


def test_contact(scene):
    st, mt, q, v, want = (scene[k] for k in ("st", "mt", "q", "v", "want"))
    Q, tac = dynamics.contact_terms(st, mt, q, v)
    _close((Q, tac), want["contact"])
    assert float(np.abs(want["contact"][1]).max()) > 0     # markers touch
    _close(dynamics.tactile_field(st, mt, q, v), want["tactile"])
    _close(dense_single.contact_terms_points_major(st, mt, q, v),
           want["points_major"])


def test_inner_graph_frees_its_graph():
    """``inner_graph`` leaves saving to autograd, so an op's output saved by
    its own node is freed with its last reference (hooks that keep the
    tensor made a cycle the garbage collector cannot see: each StableGrasp
    substep kept about 25 MB on the CPU). Under a caller's hooks (a
    non-reentrant checkpoint's, two of them nested here) it steps outside
    them and pushes them back, innermost on top, on exit."""
    top = torch._C._autograd._top_saved_tensors_default_hooks

    def built():
        x = torch.ones(3, requires_grad=True)
        y = x.exp()                        # exp saves its output
        return weakref.ref(y)

    with dynamics.inner_graph():
        assert top(False) is None
        ref = built()
    gc.collect()
    assert ref() is None
    packed = []
    outer = (lambda t: packed.append(t) or t, lambda t: t)
    inner = (lambda t: packed.append(t) or t, lambda t: t)
    with torch.autograd.graph.saved_tensors_hooks(*outer), \
            torch.autograd.graph.saved_tensors_hooks(*inner):
        with dynamics.inner_graph():
            assert top(False) is None
            ref = built()
        assert top(False)[0] is inner[0]
        assert packed == []
        with dynamics.inner_graph():
            pass
        assert top(False)[0] is inner[0]
    assert top(False) is None
    gc.collect()
    assert ref() is None


def test_inner_graph_keep_packs_through_the_caller():
    """``inner_graph(keep=True)``, an inner grad with ``create_graph`` whose
    graph the caller differentiates later: under a caller's hooks (two
    nested) the graph's saved tensors go through the innermost pack hook
    (so a checkpoint recomputes them instead of keeping them), the inner
    grad reads them as they are (no unpack through the caller before
    exit), the outer backward reads them through the caller's unpack, and
    the graph is freed with its last reference."""
    top = torch._C._autograd._top_saved_tensors_default_hooks
    outer_packed, packed, unpacked = [], [], []
    outer = (lambda t: outer_packed.append(1) or t, lambda t: t)
    inner = (lambda t: packed.append(1) or t.detach().clone(),
             lambda t: unpacked.append(1) or t)
    x = torch.linspace(0.1, 0.3, 3, dtype=torch.float64, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(*outer), \
            torch.autograd.graph.saved_tensors_hooks(*inner):
        with dynamics.inner_graph(keep=True):
            x_ = x.view_as(x)
            e = torch.exp(x_)                    # exp saves its output
            (g,) = torch.autograd.grad(torch.sum(e * x_), x_,
                                       create_graph=True)
            assert packed and not unpacked
        assert top(False)[0] is inner[0]
    assert top(False) is None and not outer_packed
    ref = weakref.ref(e)
    del e, x_
    (gg,) = torch.autograd.grad(g.sum(), x)
    assert unpacked
    torch.testing.assert_close(gg, torch.exp(x) * (x + 2), rtol=1e-15,
                               atol=0)
    del g
    gc.collect()
    assert ref() is None


def _live_tensors():
    gc.collect()
    return sum(1 for o in gc.get_objects() if isinstance(o, torch.Tensor))


def test_inner_graph_frees_its_graph_under_checkpoint():
    """BPTT with remat (one non-reentrant checkpoint per step) on
    RollingBall 8x8 pressed, float64: repeated backward passes leave no
    tensor behind (with identity hooks under the checkpoint each pass kept
    5 more), and the values and gradients equal those without remat to
    1e-12 of scale. The checkpoint itself checks that its recompute packs
    the forward's saved tensors one for one."""
    struct, model = torch_scenes.rolling_ball(resolution=8)
    model = model.to("cpu", torch.float64)
    rng = np.random.RandomState(0)
    q = model.q_init.clone()
    q[2] = -0.0153
    q[3:5] = torch.as_tensor(2e-3 * rng.randn(2))
    v = torch.as_tensor(0.005 * rng.randn(q.shape[0]))
    from tactilesimulation_tpu_torch.sim import simulation
    sim = simulation.Simulator(struct, model)
    us = torch.as_tensor(0.1 * rng.randn(2, struct.ndof_u))

    def run(remat):
        u = us.clone().requires_grad_()
        _, qs, vars_, tacs = sim.make_rollout_dense(remat=remat)(
            model, sim.init_state(q=q, qdot=v), u)
        loss = qs.sum() + vars_.sum() + 1e2 * tacs.sum()
        (g,) = torch.autograd.grad(loss, u)
        return loss.detach(), g

    want = run(False)
    got = run(True)
    again = run(True)
    base = _live_tensors()
    for _ in range(2):
        again = run(True)
        assert _live_tensors() == base
    for a, b, c in zip(got, again, want):
        scale = float(c.abs().max())
        assert scale > 0
        assert float((a - c).abs().max()) <= 1e-12 * scale
        assert float((b - c).abs().max()) <= 1e-12 * scale
