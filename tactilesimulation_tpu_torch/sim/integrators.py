"""Implicit BDF1/BDF2 stepping of one instance or a batch of them, with the
implicit-function adjoint of the solve.

Port of ``tactilesimulation_tpu/sim/integrators.py``. One step solves the
momentum-form residual

    r(v') = p(q', v') - p_base - gamma * [dL/dq(q', v') + Q(q', v', u)]
    q'    = q_base + gamma * v'

with a chord iteration: the Jacobian is built and LU-factored once at the
warm start, then ``max_iter`` masked sweeps reuse the factor and the best
iterate (by residual norm) is returned. Coefficients:

    BDF1: gamma = h,    q_base = q,            p_base = p(q, v)
    BDF2: gamma = 2h/3, q_base = (4q - q_)/3,  p_base = (4 p(q,v) - p(q_,v_))/3
          (the first step falls back to BDF1: no history yet)

Over a batch (states (B, n), the step counter (B,); Model leaves shared or
with a leading (B, ...) axis, as ``vmap`` with ``in_axes`` over Model
leaves does in JAX) every instance has its own chord factor, its own
ridge, stop rule and best iterate, and its own first-step fallback; the
single instance is the empty batch shape. No reduction runs over the batch
axis but the sums an inner ``autograd.grad`` differentiates
(``dynamics``), which are exact.

The step never waits for the device: the sweep count is fixed, a converged
iterate is frozen by ``torch.where``, BDF2's first-step fallback is a
``torch.where`` on the step counter, and the LU is ``lu_factor_ex`` (no
error check that would synchronise).

Gradients: ``newton_solve`` is an ``autograd.Function`` whose backward is
the implicit-function adjoint at the solution (JAX: the solve's
``custom_vjp``). With J = dr/dv at v*, dv*/dtheta = -J^-1 dr/dtheta, so the
backward is one transposed solve of the ridged J and one pullback of -lambda
through the residual into u, q_base, p_base, gamma and every Model leaf
(design parameters, the reference's ``flag_p``). The sweeps are never
differentiated, and the warm start gets no cotangent.

The Jacobian J = dr/dv comes from n reverse-mode pullbacks of one residual
graph (row i = the pullback of the i-th basis cotangent), run as one
batched backward pass; JAX forms it from ``jax.linearize``. Both factor
the ridged J with a pivoted LU. Under ``shared_adjoint()`` a solve's
residual graph at v* and J's factor are built once and reused by every
later backward through the same solve (the rows of a step's Jacobian,
pulled back one by one).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from . import dynamics
from .types import Model, SimState, Structure


class StepInputs(NamedTuple):
    model: Model
    u: torch.Tensor
    q_base: torch.Tensor
    p_base: torch.Tensor
    gamma: torch.Tensor


def ridge_eps(dtype) -> float:
    """Tikhonov ridge scale for the chord dense solves.

    The ridge added to the iteration matrix is ``ridge_eps * (mean|diag| + 1)``
    -- scale-aware so near-massless dofs stay solvable in f32. Same formula
    as the JAX package's ``integrators.ridge_eps``."""
    return 1e-7 if dtype == torch.float32 else 1e-12


def _ridged(J):
    """J (..., n, n) + scale-aware ridge, each instance by its own mean
    diagonal (lane-major twin: ``lanes._ridge``)."""
    n = J.shape[-1]
    diag_mag = torch.mean(torch.abs(torch.diagonal(J, dim1=-2, dim2=-1)),
                          dim=-1)
    eye = torch.eye(n, dtype=J.dtype, device=J.device)
    return J + (ridge_eps(J.dtype) * (diag_mag + 1.0))[..., None, None] * eye


def make_residual(struct: Structure, points_major: bool = False):
    """``points_major`` evaluates contact in the (3, N) points-in-lanes
    layout (``sim/dense_single.py``), the dense-marker-field path."""
    if points_major:
        from . import dense_single
        forces = dense_single.applied_forces_points_major
    else:
        forces = dynamics.applied_forces

    def residual(v_new, inputs: StepInputs):
        qn = inputs.q_base + inputs.gamma * v_new
        dLdq, p_new = dynamics.el_terms(struct, inputs.model, qn, v_new)
        Q, _ = forces(struct, inputs.model, qn, v_new, inputs.u,
                      tactile=False)
        return p_new - inputs.p_base - inputs.gamma * (dLdq + Q)
    return residual


def _detach(inputs: StepInputs) -> StepInputs:
    return StepInputs(model=inputs.model, u=inputs.u.detach(),
                      q_base=inputs.q_base.detach(),
                      p_base=inputs.p_base.detach(),
                      gamma=inputs.gamma.detach())


def _jacobian(r, v, retain_graph=False):
    """J = dr/dv (..., n, n) from one residual graph: the n pullbacks as one
    batched backward pass (vmap over the cotangents); row i is the pullback
    of e_i in every instance at once."""
    n = v.shape[-1]
    basis = torch.eye(n, dtype=v.dtype, device=v.device)
    basis = basis.reshape((n,) + (1,) * (v.ndim - 1) + (n,))
    (J,) = torch.autograd.grad(r, v, basis.expand((n,) + v.shape),
                               retain_graph=retain_graph,
                               is_grads_batched=True)
    return J.movedim(0, -2)


def chord_factor(residual_fn, inputs: StepInputs, v_guess):
    """(LU, pivots, r0): the pivoted LU of the ridged chord Jacobian
    J = dr/dv at the warm start (one per instance), and the residual there;
    all detached."""
    inputs = _detach(inputs)
    with dynamics.inner_graph():
        v = v_guess.detach().requires_grad_()
        r = residual_fn(v, inputs)
        J = _jacobian(r, v)
    lu, piv, _ = torch.linalg.lu_factor_ex(_ridged(J))
    return lu, piv, r.detach()


def chord_sweeps(residual_fn, max_iter, tol, inputs: StepInputs, v_guess,
                 factor):
    """``max_iter`` chord sweeps from ``v_guess`` with the factor of
    ``chord_factor``; a converged iterate is frozen, the best is returned,
    each per instance (norms over the last axis, masks broadcast over it).
    The tolerance is residual-scale aware: max(tol, rel |r0|)."""
    lu, piv, r0 = factor
    rel = 1e-4 if v_guess.dtype == torch.float32 else 1e-7
    inputs = _detach(inputs)
    with torch.no_grad():
        rn0 = torch.linalg.norm(r0, dim=-1)
        tol_eff = torch.clamp(rel * rn0, min=tol)
        v, r, rn = v_guess.detach(), r0, rn0
        v_best, rn_best = v, rn0
        for _ in range(max_iter):
            dv = torch.linalg.lu_solve(lu, piv, r[..., None])[..., 0]
            v = torch.where((rn <= tol_eff)[..., None], v, v - dv)
            r = residual_fn(v, inputs)
            rn = torch.linalg.norm(r, dim=-1)
            better = rn < rn_best
            v_best = torch.where(better[..., None], v, v_best)
            rn_best = torch.where(better, rn, rn_best)
    return v_best


_LEAVES = tuple(f.name for f in dataclasses.fields(Model))


def _requires_grad(inputs: StepInputs) -> bool:
    return (any(t.requires_grad for t in (inputs.u, inputs.q_base,
                                          inputs.p_base, inputs.gamma))
            or any(getattr(inputs.model, k).requires_grad for k in _LEAVES))


def _solve(residual_fn, max_iter, tol, inputs: StepInputs, v_guess):
    factor = chord_factor(residual_fn, inputs, v_guess)
    return chord_sweeps(residual_fn, max_iter, tol, inputs, v_guess, factor)


_SHARED = [0]


@contextlib.contextmanager
def shared_adjoint():
    """Within this context each solve keeps its residual graph at v* and
    the factor of J after its first backward, and every later backward
    through the same solve (``retain_graph``) reuses them: one J build per
    solve instead of one per pullback, the same numbers (iLQR's A and B
    rows). The kept graph lives as long as the solve's node."""
    _SHARED[0] += 1
    try:
        yield
    finally:
        _SHARED[0] -= 1


class _NewtonSolve(torch.autograd.Function):
    """The chord solve with the implicit-function adjoint at v*. Its tensor
    arguments are u, q_base, p_base, gamma, v_guess and the Model's leaves
    in field order (a Function takes tensors, not the dataclass). Over a
    batch the backward solves each instance's transposed system; the one
    pullback of -lambda gives a shared leaf the sum of the instances'
    cotangents and a batched leaf its own."""

    @staticmethod
    def forward(ctx, residual_fn, max_iter, tol, u, q_base, p_base, gamma,
                v_guess, *leaves):
        model = Model(*(x.detach() for x in leaves))
        inputs = StepInputs(model, u, q_base, p_base, gamma)
        v_star = _solve(residual_fn, max_iter, tol, inputs, v_guess)
        ctx.residual_fn = residual_fn
        ctx.save_for_backward(v_star, u, q_base, p_base, gamma, *leaves)
        return v_star

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # u, q_base, p_base, gamma, then the leaves (v_guess gets none)
        need = ctx.needs_input_grad[3:7] + ctx.needs_input_grad[8:]
        with dynamics.inner_graph():
            kept = getattr(ctx, "adjoint", None)
            if kept is None:
                v_star, *xs = ctx.saved_tensors
                xs = [x.detach().requires_grad_(w) for x, w in zip(xs, need)]
                v = v_star.detach().requires_grad_()
                inputs = StepInputs(Model(*xs[4:]), *xs[:4])
                r = ctx.residual_fn(v, inputs)
                # J at v*, ridged as the chord's, solved transposed:
                # _ridged(J)^T lam = g
                J = _jacobian(r, v, retain_graph=True)
                lu, piv, _ = torch.linalg.lu_factor_ex(_ridged(J))
                wrt = [x for x in xs if x.requires_grad]
                kept = (r, wrt, lu, piv)
                if _SHARED[0]:
                    ctx.adjoint = kept
            r, wrt, lu, piv = kept
            lam = torch.linalg.lu_solve(lu, piv, g[..., None],
                                        adjoint=True)[..., 0]
            got = iter(torch.autograd.grad(r, wrt, -lam,
                                           retain_graph=bool(_SHARED[0]),
                                           materialize_grads=True)
                       if wrt else ())
        grads = [next(got) if w else None for w in need]
        return (None, None, None, *grads[:4], None, *grads[4:])


def newton_solve(residual_fn, max_iter, tol, inputs: StepInputs, v_guess):
    """The chord solve. Under grad mode, with an input that requires grad,
    it runs as ``_NewtonSolve``, whose backward is the implicit-function
    adjoint at the solution; otherwise as the plain solve."""
    if torch.is_grad_enabled() and _requires_grad(inputs):
        m = inputs.model
        return _NewtonSolve.apply(
            residual_fn, max_iter, tol, inputs.u, inputs.q_base,
            inputs.p_base, inputs.gamma, v_guess,
            *(getattr(m, k) for k in _LEAVES))
    return _solve(residual_fn, max_iter, tol, inputs, v_guess)


def step_inputs(struct: Structure, model: Model, state: SimState, u):
    """StepInputs of one BDF1/BDF2 step from ``state``: BDF2 falls back to
    BDF1 on the first step (a ``torch.where`` on the counter, no sync),
    per instance over a batch. gamma is () for one instance and (B, 1) over
    a batch (or per-instance h)."""
    h = model.h
    if state.t.ndim or h.ndim:
        h = h[..., None]
    u = torch.as_tensor(u, dtype=state.q.dtype, device=state.q.device)
    p_now = dynamics.momentum(struct, model, state.q, state.qdot)
    if struct.integrator.upper() == "BDF2":
        first = (state.t == 0)[..., None] if state.t.ndim else state.t == 0
        p_prev = dynamics.momentum(struct, model, state.q_prev,
                                   state.qdot_prev)
        gamma = torch.where(first, h, 2.0 * h / 3.0)
        q_base = torch.where(first, state.q,
                             (4.0 * state.q - state.q_prev) / 3.0)
        p_base = torch.where(first, p_now, (4.0 * p_now - p_prev) / 3.0)
    else:
        gamma, q_base, p_base = h, state.q, p_now
    return StepInputs(model=model, u=u, q_base=q_base, p_base=p_base,
                      gamma=gamma)


def solver_tol(struct: Structure, dtype) -> float:
    return max(struct.solver_tol, 1e-7 if dtype == torch.float32 else 1e-12)


def build_step(struct: Structure, points_major: bool = False):
    """step(model, state, u) -> state'. ``points_major`` routes contact
    through the (3, N) layout (``sim/dense_single.py``)."""
    residual_fn = make_residual(struct, points_major=points_major)
    max_iter = struct.solver_max_iter

    def step(model: Model, state: SimState, u):
        inputs = step_inputs(struct, model, state, u)
        v_new = newton_solve(residual_fn, max_iter,
                             solver_tol(struct, state.q.dtype), inputs,
                             state.qdot)
        q_new = inputs.q_base + inputs.gamma * v_new
        return SimState(q=q_new, qdot=v_new, q_prev=state.q,
                        qdot_prev=state.qdot, t=state.t + 1)

    step.residual_fn = residual_fn
    return step


def initial_state(struct: Structure, model: Model) -> SimState:
    return SimState(q=model.q_init, qdot=model.qdot_init,
                    q_prev=model.q_init, qdot_prev=model.qdot_init,
                    t=torch.zeros((), dtype=torch.int32,
                                  device=model.q_init.device))
