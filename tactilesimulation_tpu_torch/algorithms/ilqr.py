"""iLQR (Gauss-Newton DDP) trajectory optimisation on the single-instance
simulator.

Port of ``tactilesimulation_tpu/algorithms/ilqr.py``. Each iteration
linearises the implicit steps along the nominal trajectory (A_t = df/ds,
B_t = df/du by reverse-mode rows through the solve's implicit-function
adjoint), quadratises the cost (``torch.func``: the cost is plain torch),
runs the Riccati backward pass with regularisation mu, and line-searches
the affine policy u = u_nom + alpha k + K (s - s_nom) over ``alphas``, one
closed-loop rollout per candidate. mu falls by ``mu_factor`` after an
improving iteration and rises by it otherwise, within [1e-9, 1e6]; the
controls are clipped to ``u_bounds`` at the end.

State convention: s = [q, qdot, q_prev, qdot_prev] (4n,), the whole
integrator state (BDF2's history is differentiated through); the step
counter enters as a constant. Of a step's Jacobian rows, those of q and
qdot are pulled back through the solve, 2n backward passes sharing one
residual graph and one factor of J (``integrators.shared_adjoint``); those
of q_prev and qdot_prev are copies of the entry's q and qdot.

The JAX package scans and vmaps; here every loop runs eagerly on the
model's device, and ``solve_multistart`` runs its starts one after
another.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import func

from ..sim import integrators
from ..sim.types import SimState
from .shooting import _best_start, clip_controls, shift_plan


def _pack(state: SimState):
    return torch.cat([state.q, state.qdot, state.q_prev, state.qdot_prev])


def _unpack(s, n, t):
    return SimState(q=s[0:n], qdot=s[n:2 * n], q_prev=s[2 * n:3 * n],
                    qdot_prev=s[3 * n:4 * n], t=t)


class ILQROptimizer:
    """min_u sum_t cost(state_t, u_t) + final_cost(state_H).

    The interface of ``ShootingOptimizer``: cost_fn(SimState, u) -> scalar
    (on the state before the step, as the JAX package's iLQR takes it),
    final_cost_fn(SimState) -> scalar, controls clipped to u_bounds inside
    the dynamics. ``solve`` returns (best_us, best_cost, cost_history)."""

    def __init__(self, simulator, horizon: int, cost_fn: Callable,
                 final_cost_fn: Optional[Callable] = None,
                 u_bounds: Optional[tuple] = None, iterations: int = 10,
                 mu_init: float = 1e-6, mu_factor: float = 10.0,
                 alphas=(1.0, 0.5, 0.25, 0.1, 0.03)):
        self.sim = simulator
        self.horizon = horizon
        self.cost_fn = cost_fn
        self.final_cost_fn = final_cost_fn
        self.u_bounds = u_bounds
        self.iterations = iterations
        self.mu_init, self.mu_factor = mu_init, mu_factor
        self.alphas = tuple(alphas)
        self.n = simulator.struct.ndof_q
        self.nu = simulator.struct.ndof_u

    # -- the problem in the packed state ------------------------------------
    def f(self, model, s, u, t):
        u = clip_controls(u, self.u_bounds)
        return _pack(self.sim.step(model, _unpack(s, self.n, t), u))

    def c(self, s, u, t):
        u = clip_controls(u, self.u_bounds)
        return self.cost_fn(_unpack(s, self.n, t), u)

    def cf(self, s, t):
        if self.final_cost_fn is None:
            return s.new_zeros(())
        return self.final_cost_fn(_unpack(s, self.n, t))

    def rollout(self, model, s0, t0, us):
        """(the states after each step (H, 4n), the total cost)."""
        s, ss, costs = s0, [], []
        for i, u in enumerate(us):
            s2 = self.f(model, s, u, t0 + i)
            costs.append(self.c(s, u, t0 + i))
            ss.append(s2)
            s = s2
        total = torch.sum(torch.stack(costs)) + self.cf(s, t0 + len(us))
        return torch.stack(ss), total

    def dynamics_jacobians(self, model, s, u, t):
        """(A (4n, 4n), B (4n, nu)) of one step at (s, u)."""
        n = self.n
        with torch.enable_grad(), integrators.shared_adjoint():
            s_ = s.detach().requires_grad_()
            u_ = u.detach().requires_grad_()
            out = self.f(model, s_, u_, t)
            rows = [torch.autograd.grad(out[i], (s_, u_), retain_graph=True,
                                        materialize_grads=True)
                    for i in range(2 * n)]
        A = torch.zeros(4 * n, 4 * n, dtype=s.dtype, device=s.device)
        B = torch.zeros(4 * n, self.nu, dtype=s.dtype, device=s.device)
        A[:2 * n] = torch.stack([a for a, _ in rows])
        B[:2 * n] = torch.stack([b for _, b in rows])
        A[2 * n:, :2 * n] = torch.eye(2 * n, dtype=s.dtype, device=s.device)
        return A, B

    def cost_derivatives(self, s, u, t):
        """(cx, cu, cxx, cuu, cux) of the running cost at (s, u)."""
        c = self.c
        return (func.grad(c, argnums=0)(s, u, t),
                func.grad(c, argnums=1)(s, u, t),
                func.hessian(c, argnums=0)(s, u, t),
                func.hessian(c, argnums=1)(s, u, t),
                func.jacrev(func.grad(c, argnums=1), argnums=0)(s, u, t))

    def final_derivatives(self, s, t):
        if self.final_cost_fn is None:
            return s.new_zeros(s.shape), s.new_zeros(s.shape * 2)
        return (func.grad(self.cf, argnums=0)(s, t),
                func.hessian(self.cf, argnums=0)(s, t))

    def backward_pass(self, derivs, Vx, Vxx, mu):
        """The Riccati recursion: gains (k_t, K_t) for every step."""
        eye = torch.eye(self.nu, dtype=Vx.dtype, device=Vx.device)
        ks, Ks = [None] * len(derivs), [None] * len(derivs)
        for i in reversed(range(len(derivs))):
            A, B, cx, cu, cxx, cuu, cux = derivs[i]
            Qx = cx + A.T @ Vx
            Qu = cu + B.T @ Vx
            Qxx = cxx + A.T @ Vxx @ A
            Quu = cuu + B.T @ Vxx @ B + mu * eye
            Qux = cux + B.T @ Vxx @ A
            k = -torch.linalg.solve(Quu, Qu)
            K = -torch.linalg.solve(Quu, Qux)
            Vx = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
            Vxx = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            Vxx = 0.5 * (Vxx + Vxx.T)
            ks[i], Ks[i] = k, K
        return ks, Ks

    def forward_alpha(self, model, s0, t0, us, ss_nom, ks, Ks, alpha):
        """Closed-loop rollout with u = u_nom + alpha k + K (s - s_nom)."""
        s_noms = torch.cat([s0[None], ss_nom[:-1]], dim=0)
        s, us2, costs = s0, [], []
        for i in range(len(us)):
            u = us[i] + alpha * ks[i] + Ks[i] @ (s - s_noms[i])
            s2 = self.f(model, s, u, t0 + i)
            us2.append(u)
            costs.append(self.c(s, u, t0 + i))
            s = s2
        total = torch.sum(torch.stack(costs)) + self.cf(s, t0 + len(us))
        return torch.stack(us2), total

    # -- solve -------------------------------------------------------------
    def solve(self, model, state0, us0):
        """us0 (H, nu) -> (best_us, best_cost, cost history (iterations,))."""
        with torch.no_grad():
            return self._solve(model, state0, us0.detach())

    def _solve(self, model, state0, us):
        s0 = _pack(state0).detach()
        t0 = state0.t
        _, cost = self.rollout(model, s0, t0, us)
        mu = torch.full((), self.mu_init, dtype=s0.dtype, device=s0.device)
        history = []
        for _ in range(self.iterations):
            ss, _ = self.rollout(model, s0, t0, us)
            s_noms = torch.cat([s0[None], ss[:-1]], dim=0)
            derivs = []
            for i in range(len(us)):
                A, B = self.dynamics_jacobians(model, s_noms[i], us[i],
                                               t0 + i)
                derivs.append((A, B) + self.cost_derivatives(
                    s_noms[i], us[i], t0 + i))
            Vx, Vxx = self.final_derivatives(ss[-1], t0 + len(us))
            ks, Ks = self.backward_pass(derivs, Vx, Vxx, mu)
            cands = [self.forward_alpha(model, s0, t0, us, ss, ks, Ks, a)
                     for a in self.alphas]
            cand_cost = torch.stack([c for _, c in cands])
            i = torch.argmin(cand_cost)
            improved = cand_cost[i] < cost
            us = torch.where(improved, torch.stack([u for u, _ in cands])[i],
                             us)
            cost = torch.where(improved, cand_cost[i], cost)
            mu = torch.where(improved,
                             torch.clamp(mu / self.mu_factor, min=1e-9),
                             torch.clamp(mu * self.mu_factor, max=1e6))
            history.append(cost)
        return clip_controls(us, self.u_bounds), cost, torch.stack(history)

    def solve_multistart(self, model, state0, num_starts: int,
                         init_scale: float = 0.1,
                         generator: Optional[torch.Generator] = None):
        """``num_starts`` solves from controls ``init_scale`` x N(0, 1)
        drawn from ``generator``, one after another; returns (the best
        control sequence found, its cost)."""
        us0 = init_scale * torch.randn(
            (num_starts, self.horizon, self.nu), generator=generator,
            dtype=state0.q.dtype, device=state0.q.device)
        return _best_start(self.solve, model, state0, us0)

    def mpc_step(self, model, state, us_warm):
        """Receding horizon: re-optimise from ``state`` warm-started by the
        previous plan shifted by one step; returns (u0, the new plan)."""
        best_us, _, _ = self.solve(model, state, shift_plan(us_warm))
        return best_us[0], best_us
