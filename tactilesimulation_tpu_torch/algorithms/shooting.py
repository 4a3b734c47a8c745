"""Gradient-based trajectory optimisation (shooting) and receding-horizon
MPC on the single-instance simulator.

Port of ``tactilesimulation_tpu/algorithms/shooting.py``: Adam over the
control sequence, its gradient by BPTT through the implicit steps'
adjoints (``integrators.newton_solve``), the best iterate kept. The JAX
package jits the solve and vmaps the multi-start; here the solve is an
eager loop on the model's device, and ``solve_multistart`` runs the starts
one after another (``torch.func.vmap`` cannot run the core, whose residual
calls ``torch.autograd.grad``). ``mpc_step`` replans for ``replan_iters``
iterations (the JAX package takes the argument and runs ``iterations``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .gd import Adam


def clip_controls(u, u_bounds):
    """``u`` clipped to ``u_bounds`` = (lo, hi) (scalars or per-control
    arrays), or ``u`` when there are none."""
    if u_bounds is None:
        return u
    lo, hi = (torch.as_tensor(b, dtype=u.dtype, device=u.device)
              for b in u_bounds)
    return torch.clamp(u, lo, hi)


class ShootingOptimizer:
    """min_u  sum_t cost(state_t, u_t) + final_cost(state_H) over a rollout
    of ``horizon`` steps of ``simulator.step``.

    cost_fn(state, u) -> scalar running cost on the state after the step;
    final_cost_fn(state) -> scalar. Both receive the ``SimState``. Controls
    are clipped to ``u_bounds`` inside the rollout. ``remat`` recomputes
    each step in the backward (one non-reentrant checkpoint per step)."""

    def __init__(self, simulator, horizon: int, cost_fn: Callable,
                 final_cost_fn: Optional[Callable] = None,
                 u_bounds: Optional[tuple] = None, iterations: int = 100,
                 lr: float = 0.1, remat: bool = True):
        self.sim = simulator
        self.horizon = horizon
        self.cost_fn = cost_fn
        self.final_cost_fn = final_cost_fn
        self.u_bounds = u_bounds
        self.iterations = iterations
        self.lr = lr
        self.remat = remat

    def total_cost(self, model, state0, us):
        """The cost of the controls ``us`` (H, nu) from ``state0``."""
        step = self.sim.step

        def body(state, u):
            u = clip_controls(u, self.u_bounds)
            new_state = step(model, state, u)
            return new_state, self.cost_fn(new_state, u)

        if self.remat and torch.is_grad_enabled():
            call = lambda *a: checkpoint(body, *a, use_reentrant=False,
                                         preserve_rng_state=False)
        else:
            call = body
        state, costs = state0, []
        for u in us:
            state, cost = call(state, u)
            costs.append(cost)
        total = torch.sum(torch.stack(costs))
        if self.final_cost_fn is not None:
            total = total + self.final_cost_fn(state)
        return total

    def solve(self, model, state0, us0, iterations: Optional[int] = None):
        """us0 (H, nu) -> (best_us, best_cost, cost history (iterations,)):
        ``iterations`` Adam steps; an iterate is kept, before its update,
        when its cost is the lowest so far."""
        us = us0.detach().clone().requires_grad_()
        opt = Adam([us], self.lr)
        best_us = us0.detach().clone()
        best_cost = torch.full((), float("inf"), dtype=us0.dtype,
                               device=us0.device)
        history = []
        for _ in range(self.iterations if iterations is None
                       else iterations):
            cost = self.total_cost(model, state0, us)
            (grad,) = torch.autograd.grad(cost, us)
            cost = cost.detach()
            better = cost < best_cost
            best_us = torch.where(better, us.detach(), best_us)
            best_cost = torch.where(better, cost, best_cost)
            opt.step([grad])
            history.append(cost)
        return best_us, best_cost, torch.stack(history)

    def solve_multistart(self, model, state0, num_starts: int,
                         init_scale: float = 0.1,
                         generator: Optional[torch.Generator] = None):
        """``num_starts`` solves from controls ``init_scale`` x N(0, 1)
        drawn from ``generator``, one after another; returns (the best
        control sequence found, its cost)."""
        us0 = init_scale * torch.randn(
            (num_starts, self.horizon, self.sim.struct.ndof_u),
            generator=generator, dtype=state0.q.dtype,
            device=state0.q.device)
        return _best_start(self.solve, model, state0, us0)

    def mpc_step(self, model, state, us_warm, replan_iters: int = 10):
        """Receding horizon: re-optimise from ``state`` for
        ``replan_iters`` iterations, warm-started by the previous plan
        shifted by one step; returns (u0, the new plan)."""
        best_us, _, _ = self.solve(model, state, shift_plan(us_warm),
                                   iterations=replan_iters)
        return best_us[0], best_us


def shift_plan(us):
    """The plan one step on: its tail, the last control repeated."""
    return torch.cat([us[1:], us[-1:]], dim=0)


def _best_start(solve, model, state0, us0):
    outs = [solve(model, state0, u) for u in us0]
    costs = torch.stack([c for _, c, _ in outs])
    i = torch.argmin(costs)
    return torch.stack([u for u, _, _ in outs])[i], costs[i]
