"""Single-instance simulation front ends, forward only.

Port of ``tactilesimulation_tpu/sim/simulation.py``:

- ``Simulator``: the functional API bound to one scene: ``step``,
  ``make_rollout_states``, ``make_rollout_strided``, tactile and variable
  queries. JAX jits and scans these; here they are eager Python loops over
  device tensors that never wait for the card (no ``.item()``, no host
  copies inside a rollout).
- ``Simulation``: a host facade with the reference ``redmax_py`` binding
  surface (dof properties, state access, ``reset`` / ``set_u`` /
  ``forward``, tactile queries, ``export_trajectory``). The state stays on
  the device until it is read.

Not ported yet: the single-instance implicit-function adjoint, so no
``make_rollout_dense``, ``backward``, ``backward_steps`` or backward cache;
the ``update_*`` model editing, ``replay`` and the XML constructor.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import dense_single, dynamics, integrators, kinematics
from ..envs.tactile_push import resolve_device
from ..ops import tactile_query
from .types import Model, SimState, Structure


class Simulator:
    """Functional simulation API bound to one scene structure."""

    def __init__(self, struct: Structure, model: Model,
                 points_major: Optional[bool] = None):
        self.struct = struct
        self.model = model
        # dense marker fields (e.g. the 200x200 rolling-ball pad): contact
        # in the (3, N) points-in-lanes layout (sim/dense_single.py); small
        # scenes keep the row-major path (the same numerics)
        if points_major is None:
            points_major = (len(struct.cp_joint) + len(struct.tac_joint)
                            >= 2048)
        self.points_major = points_major
        self.step = integrators.build_step(struct, points_major=points_major)

    # -- state ------------------------------------------------------------
    def init_state(self, model: Optional[Model] = None, q=None,
                   qdot=None) -> SimState:
        model = self.model if model is None else model
        state = integrators.initial_state(self.struct, model)
        as_state = lambda a: torch.as_tensor(a, dtype=state.q.dtype,
                                             device=state.q.device)
        if q is not None:
            q = as_state(q)
            state = state.replace(q=q, q_prev=q)
        if qdot is not None:
            qdot = as_state(qdot)
            state = state.replace(qdot=qdot, qdot_prev=qdot)
        return state

    def tactile(self, model: Model, state: SimState):
        """(ntac * 3,) sensor-frame tactile field at ``state``."""
        if self._use_fast_tactile(model):
            return tactile_query.tactile_field(
                self.struct, model, state.q, state.qdot).reshape(-1)
        return self._tactile_field(model, state.q, state.qdot).reshape(-1)

    def variables(self, model: Model, state: SimState):
        return kinematics.ee_positions(self.struct, model, state.q)

    def _tactile_field(self, model, q, qdot):
        """The tactile field in the layout matching the step."""
        if self.points_major:
            return dense_single.tactile_field_points_major(
                self.struct, model, q, qdot)
        return dynamics.tactile_field(self.struct, model, q, qdot)

    def _use_fast_tactile(self, model: Optional[Model] = None) -> bool:
        """The tactile read kernel's query: the model lives on the card and
        every tactile pair is point-vs-primitive (the counterpart of JAX's
        "backend is TPU")."""
        model = self.model if model is None else model
        return model.h.is_cuda and tactile_query.supported(self.struct)

    # -- rollouts ---------------------------------------------------------
    def make_rollout_states(self):
        """(model, state0, us (T, nu)) -> SimState with (T, ...) leaves:
        the state after every step."""
        step = self.step

        def rollout(model, state0, us):
            states = []
            s = state0
            for u in us:
                s = step(model, s, u)
                states.append(s)
            return SimState(*(torch.stack([getattr(x, k) for x in states])
                              for k in ("q", "qdot", "q_prev", "qdot_prev",
                                        "t")))

        return rollout

    def make_rollout_strided(self, stride: int, remat: bool = True,
                             fast_tactile: bool = False):
        """(model, state0, us (K, nu)) -> (state_K, qs (K, n),
        vars (K, nvar), tactiles (K, ntac*3)): outputs at chunk ends only;
        each control is held for ``stride`` sim steps (frame_skip with
        save_last_frame_var_only).

        ``fast_tactile`` queries the field through the tactile read kernel
        where the model lives on the card (``_use_fast_tactile``).
        ``remat`` is accepted for the JAX signature; a forward-only rollout
        keeps no graph to rematerialise."""
        del remat
        struct, step = self.struct, self.step

        def rollout(model, state0, us):
            fast = fast_tactile and self._use_fast_tactile(model)
            state = state0
            qs, vars_, tacs = [], [], []
            for u in us:
                for _ in range(stride):
                    state = step(model, state, u)
                if fast:
                    tac = tactile_query.tactile_field(
                        struct, model, state.q, state.qdot).reshape(-1)
                else:
                    with torch.no_grad():
                        tac = self._tactile_field(
                            model, state.q, state.qdot).reshape(-1)
                qs.append(state.q)
                vars_.append(kinematics.ee_positions(struct, model, state.q))
                tacs.append(tac)
            return (state, torch.stack(qs), torch.stack(vars_),
                    torch.stack(tacs))

        return rollout


# ---------------------------------------------------------------------------
# redmax_py-style host facade
# ---------------------------------------------------------------------------

class _Options:
    def __init__(self, h):
        self.h = h


class Simulation:
    """Host facade with the reference binding surface, forward only.

    ``Simulation((struct, model), device="cuda", dtype=None)`` moves the
    model to ``device`` (``dtype`` None keeps the model's own). The card is
    the default and must exist; pass ``device="cpu"`` for the plain path."""

    def __init__(self, model_path, verbose: bool = False, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        if not isinstance(model_path, tuple):
            raise NotImplementedError(
                "the XML scene constructor is not ported; pass a "
                "(struct, model) pair, e.g. from model.task_scenes")
        struct, model = model_path
        self.device = resolve_device(device)
        self.struct = struct
        self.model = model.to(self.device, dtype or model.dtype)
        self.sim = Simulator(self.struct, self.model)
        self.options = _Options(float(self.model.h))
        self._q_init = self.model.q_init.detach().cpu().numpy().copy()
        self._qdot_init = self.model.qdot_init.detach().cpu().numpy().copy()
        self._state = self.sim.init_state(self.model)
        self._u = self._device_vector(np.zeros(struct.ndof_u))
        self._trajectory: List[torch.Tensor] = []   # q history (device)
        self._rollout_states = None
        if verbose:
            s = self.struct
            print(f"[tsim] scene '{s.name}': integrator={s.integrator} "
                  f"h={self.options.h} ndof_r={s.ndof_q} ndof_u={s.ndof_u} "
                  f"ndof_var={s.ndof_var} ndof_tactile={s.ndof_tactile} "
                  f"bodies={s.nbodies} device={self.device}")

    def _device_vector(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self.model.dtype, device=self.device)

    # -- dof properties ----------------------------------------------------
    @property
    def ndof_r(self):
        return self.struct.ndof_q

    @property
    def ndof_u(self):
        return self.struct.ndof_u

    @property
    def ndof_var(self):
        return self.struct.ndof_var

    @property
    def ndof_tactile(self):
        return self.struct.ndof_tactile

    # -- state access ------------------------------------------------------
    def get_q(self):
        return self._state.q.detach().cpu().numpy()

    def get_qdot(self):
        return self._state.qdot.detach().cpu().numpy()

    def get_q_init(self):
        return self._q_init.copy()

    def set_q_init(self, q):
        self._q_init = np.asarray(q, dtype=np.float64).copy()

    def set_state_init(self, q, qdot):
        self._q_init = np.asarray(q, dtype=np.float64).copy()
        self._qdot_init = np.asarray(qdot, dtype=np.float64).copy()

    def get_variables(self):
        return self.sim.variables(self.model, self._state).cpu().numpy()

    # -- stepping ----------------------------------------------------------
    def reset(self, backward_flag: bool = False):
        if backward_flag:
            raise NotImplementedError(
                "reset(backward_flag=True): the backward engine (the "
                "single-instance implicit-function adjoint) is not ported")
        self._state = self.sim.init_state(self.model, self._q_init,
                                          self._qdot_init)
        self._trajectory = [self._state.q]

    def set_u(self, u):
        self._u = self._device_vector(u)

    def forward(self, num_steps: int, verbose: bool = False,
                test_derivatives: bool = False,
                save_last_frame_var_only: bool = False):
        del verbose, save_last_frame_var_only
        if test_derivatives:
            raise NotImplementedError("test_derivatives needs the backward "
                                      "engine, which is not ported")
        if num_steps > 1:
            if self._rollout_states is None:
                self._rollout_states = self.sim.make_rollout_states()
            us = self._u.expand(num_steps, self.struct.ndof_u)
            stacked = self._rollout_states(self.model, self._state, us)
            self._state = SimState(q=stacked.q[-1], qdot=stacked.qdot[-1],
                                   q_prev=stacked.q_prev[-1],
                                   qdot_prev=stacked.qdot_prev[-1],
                                   t=stacked.t[-1])
            self._trajectory.extend(stacked.q.unbind(0))
        else:
            for _ in range(num_steps):
                self._state = self.sim.step(self.model, self._state, self._u)
                self._trajectory.append(self._state.q)

    # -- tactile queries ---------------------------------------------------
    def get_tactile_force_vector(self):
        return self.sim.tactile(self.model, self._state).cpu().numpy()

    def get_tactile_image_pos(self, name: str):
        s = self.struct.sensors[self.struct.sensor_index(name)]
        return [tuple(rc) for rc in np.asarray(s.image_pos)]

    def get_tactile_flow_images(self):
        field = self.get_tactile_force_vector().reshape(-1, 3)
        images = []
        for s in self.struct.sensors:
            img = np.zeros((s.rows, s.cols, 3))
            ip = np.asarray(s.image_pos)
            img[ip[:, 0], ip[:, 1]] = field[s.marker_start:s.marker_start
                                            + s.marker_count]
            images.append(img)
        return images

    def export_trajectory(self):
        if not self._trajectory:
            return np.zeros((0, self.ndof_r))
        return torch.stack(self._trajectory).cpu().numpy()
