"""Single-instance simulation front ends.

Port of ``tactilesimulation_tpu/sim/simulation.py``:

- ``Simulator``: the functional API bound to one scene: ``step``,
  ``make_rollout_dense``, ``make_rollout_states``, ``make_rollout_strided``,
  tactile and variable queries, for one instance or a batch of them
  (states (B, n), the step counter (B,); ``init_state`` makes either; the
  JAX package ``vmap``s the single instance). JAX jits and scans these; here they are
  eager Python loops over device tensors that never wait for the card (no
  ``.item()``, no host copies inside a rollout). Gradients flow through
  ``integrators.newton_solve``'s implicit-function adjoint; ``remat``
  recomputes each step (dense) or chunk (strided) in the backward with
  ``torch.utils.checkpoint``.
- ``Simulation``: a host facade with the reference ``redmax_py`` binding
  surface (the constructor from a redmax XML file or a (struct, model)
  pair, dof properties, state access, ``reset`` / ``set_u`` /
  ``forward``, tactile queries, the backward engine with its cache,
  ``update_*`` model edits, ``export_trajectory``, ``viewer_options`` and
  ``replay``). The state stays on the device until it is read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import dense_single, dynamics, integrators, kinematics
from ..envs.tactile_push import resolve_device
from ..model import builder, xml_parser
from ..model.schema import GEOM_CYLINDER, GEOM_SPHERE
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
                   qdot=None, batch: Optional[int] = None) -> SimState:
        """The model's initial state, or (q, qdot) where given. A batch of
        states when ``batch`` is given or q / qdot is (B, n): every leaf
        (B, n), the step counter (B,) zeros."""
        model = self.model if model is None else model
        state = integrators.initial_state(self.struct, model)
        as_state = lambda a: torch.as_tensor(a, dtype=state.q.dtype,
                                             device=state.q.device)
        q = None if q is None else as_state(q)
        qdot = None if qdot is None else as_state(qdot)
        if batch is None:
            batch = next((a.shape[0] for a in (q, qdot)
                          if a is not None and a.ndim == 2), None)
        if batch is not None:
            vec = lambda a: a.expand(batch, a.shape[-1]).contiguous()
            state = SimState(q=vec(state.q), qdot=vec(state.qdot),
                             q_prev=vec(state.q_prev),
                             qdot_prev=vec(state.qdot_prev),
                             t=state.t.expand(batch).contiguous())
            q = None if q is None else vec(q)
            qdot = None if qdot is None else vec(qdot)
        if q is not None:
            state = state.replace(q=q, q_prev=q)
        if qdot is not None:
            state = state.replace(qdot=qdot, qdot_prev=qdot)
        return state

    def tactile(self, model: Model, state: SimState):
        """(..., ntac * 3) sensor-frame tactile field at ``state``: the
        read's query where ``tactile_query.may_read`` allows it."""
        if tactile_query.may_read(self.struct, model, state.q, state.qdot):
            return tactile_query.tactile_field(
                self.struct, model, state.q, state.qdot).flatten(-2)
        return self._tactile_field(model, state.q, state.qdot).flatten(-2)

    def variables(self, model: Model, state: SimState):
        return kinematics.ee_positions(self.struct, model, state.q)

    def _tactile_field(self, model, q, qdot):
        """The tactile field in the layout matching the step."""
        if self.points_major:
            return dense_single.tactile_field_points_major(
                self.struct, model, q, qdot)
        return dynamics.tactile_field(self.struct, model, q, qdot)

    # -- rollouts ---------------------------------------------------------
    def make_rollout_dense(self, remat: bool = True,
                           with_tactile: bool = True):
        """(model, state0, us (T, nu)) -> (state_T, qs (T, n), vars
        (T, nvar), tactiles (T, ntac*3)): every step's outputs
        (EpisodicSimFunction's), the field in the step's layout. Over a
        batch, states (B, ·), controls (T, nu) shared or (B, T, nu), the
        outputs (B, T, ·). ``remat`` recomputes each step in the
        backward."""
        struct, step = self.struct, self.step

        def body(model, state, u):
            state = step(model, state, u)
            tac = (self._tactile_field(model, state.q, state.qdot).flatten(-2)
                   if with_tactile
                   else state.q.new_zeros(state.q.shape[:-1] + (0,)))
            return state, kinematics.ee_positions(struct, model, state.q), tac

        def rollout(model, state0, us):
            return _scan(body, remat, model, state0, us)

        return rollout

    def make_rollout_states(self):
        """(model, state0, us (T, nu)) -> SimState with (T, ...) leaves:
        the state after every step (over a batch (B, T, ...), controls as
        ``make_rollout_dense``'s)."""
        step = self.step

        def rollout(model, state0, us):
            states = []
            s = state0
            for u in us.unbind(-2):
                s = step(model, s, u)
                states.append(s)
            return SimState(*(torch.stack([getattr(x, k) for x in states],
                                          dim=-1 if k == "t" else -2)
                              for k in ("q", "qdot", "q_prev", "qdot_prev",
                                        "t")))

        return rollout

    def make_rollout_strided(self, stride: int, remat: bool = True,
                             fast_tactile: bool = False):
        """(model, state0, us (K, nu)) -> (state_K, qs (K, n),
        vars (K, nvar), tactiles (K, ntac*3)): outputs at chunk ends only;
        each control is held for ``stride`` sim steps (frame_skip with
        save_last_frame_var_only). Over a batch, states (B, ·), controls
        (K, nu) shared or (B, K, nu), the outputs (B, K, ·). ``remat``
        recomputes each chunk in the backward: one non-reentrant checkpoint
        per chunk for the whole batch.

        ``fast_tactile`` queries the field through the tactile read
        where ``tactile_query.may_read`` allows it (no gradient can flow):
        over a batch, one read of every instance a chunk; otherwise the
        field keeps its graph."""
        struct, step = self.struct, self.step

        def chunk(model, state, u):
            for _ in range(stride):
                state = step(model, state, u)
            if fast_tactile and tactile_query.may_read(struct, model, state.q,
                                                       state.qdot):
                tac = tactile_query.tactile_field(
                    struct, model, state.q, state.qdot).flatten(-2)
            else:
                tac = self._tactile_field(model, state.q,
                                          state.qdot).flatten(-2)
            return state, kinematics.ee_positions(struct, model, state.q), tac

        def rollout(model, state0, us):
            return _scan(chunk, remat, model, state0, us)

        return rollout


def _scan(body, remat, model, state, us):
    """(state, stacked q, vars, tactiles) of ``body`` over the controls
    (us (T, nu), or (B, T, nu) over a batch; the outputs stacked on the
    axis before their last); with ``remat`` under grad mode each body call
    is a non-reentrant checkpoint (its activations recomputed in the
    backward)."""
    if remat and torch.is_grad_enabled():
        call = lambda *a: checkpoint(body, *a, use_reentrant=False,
                                     preserve_rng_state=False)
    else:
        call = body
    qs, vars_, tacs = [], [], []
    for u in us.unbind(-2):
        state, var, tac = call(model, state, u)
        qs.append(state.q)
        vars_.append(var)
        tacs.append(tac)
    return (state, torch.stack(qs, dim=-2), torch.stack(vars_, dim=-2),
            torch.stack(tacs, dim=-2))


# ---------------------------------------------------------------------------
# redmax_py-style host facade
# ---------------------------------------------------------------------------

class _Options:
    def __init__(self, h):
        self.h = h


class _ViewerOptions:
    """Replay and recording settings; rendering is offline
    (``utils/renderer.py``)."""

    def __init__(self):
        self.fps = 30
        self.speed = 1.0
        self.loop = False
        self.infinite = False
        self.record = False
        self.record_folder = "."
        self.camera_pos = np.array([2.0, -2.5, 2.0])
        self.camera_lookat = np.array([0.0, 0.0, 0.0])


class _BackwardInfo:
    def __init__(self):
        self.flag_q0 = False
        self.flag_qdot0 = False
        self.flag_p = False
        self.flag_u = True
        self.df_dq = None
        self.df_dvar = None
        self.df_dtactile = None
        self.df_dq0 = None
        self.df_dqdot0 = None
        self.df_du = None

    def set_flags(self, flag_q0, flag_qdot0, flag_p, flag_u):
        self.flag_q0, self.flag_qdot0 = flag_q0, flag_qdot0
        self.flag_p, self.flag_u = flag_p, flag_u


class _BackwardResults:
    def __init__(self):
        self.df_dq0 = None
        self.df_dqdot0 = None
        self.df_du = None
        self.df_dp = None      # design-parameter gradients (Model cotangent)


@dataclasses.dataclass
class _EpisodeRecord:
    q0: np.ndarray
    qdot0: np.ndarray
    us: List[np.ndarray]
    state_snapshots: List[SimState]    # the state BEFORE each recorded step


class Simulation:
    """Host facade with the reference binding surface: dof properties and
    state access, ``reset`` / ``set_u`` / ``forward``, tactile queries, the
    backward engine (``backward``, ``backward_steps``, the backward cache,
    design-parameter gradients), the ``update_*`` model edits and
    ``replay``. ``backward()`` runs the recorded episode again with the
    graph kept and pulls the seeded cotangents back through the solves'
    adjoint.

    ``Simulation(model_path, device="cuda", dtype=None)``: ``model_path``
    is a redmax XML file (parsed by ``xml_parser.parse_scene`` and built in
    float64 on ``device``) or a prebuilt (struct, model) pair, moved to
    ``device``; ``dtype`` None keeps the model's own. The card is the
    default and must exist; pass ``device="cpu"`` for the plain path."""

    def __init__(self, model_path, verbose: bool = False, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        if isinstance(model_path, tuple):
            struct, model = model_path
        else:
            struct, model = builder.build(xml_parser.parse_scene(model_path),
                                          device=self.device)
        self.struct = struct
        self.model = model.to(self.device, dtype or model.dtype)
        self.sim = Simulator(self.struct, self.model)
        self.options = _Options(float(self.model.h))
        self.viewer_options = _ViewerOptions()
        self.backward_info = _BackwardInfo()
        self.backward_results = _BackwardResults()
        self._q_init = self.model.q_init.detach().cpu().numpy().copy()
        self._qdot_init = self.model.qdot_init.detach().cpu().numpy().copy()
        self._state = self.sim.init_state(self.model)
        self._u_host = np.zeros(struct.ndof_u)
        self._u = self._device_vector(self._u_host)
        self._episode: Optional[_EpisodeRecord] = None
        self._cache: List[_EpisodeRecord] = []
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
        self._state = self.sim.init_state(self.model, self._q_init,
                                          self._qdot_init)
        self._trajectory = [self._state.q]
        self._episode = (_EpisodeRecord(
            q0=self._q_init.copy(), qdot0=self._qdot_init.copy(), us=[],
            state_snapshots=[self._state]) if backward_flag else None)

    def set_u(self, u):
        self._u_host = np.asarray(u, dtype=np.float64).copy()
        self._u = self._device_vector(self._u_host)

    def forward(self, num_steps: int, verbose: bool = False,
                test_derivatives: bool = False,
                save_last_frame_var_only: bool = False):
        del verbose, save_last_frame_var_only
        ep = self._episode
        if num_steps > 1:
            if self._rollout_states is None:
                self._rollout_states = self.sim.make_rollout_states()
            us = self._u.expand(num_steps, self.struct.ndof_u)
            stacked = self._rollout_states(self.model, self._state, us)
            states = [SimState(q=stacked.q[i], qdot=stacked.qdot[i],
                               q_prev=stacked.q_prev[i],
                               qdot_prev=stacked.qdot_prev[i],
                               t=stacked.t[i]) for i in range(num_steps)]
            if ep is not None:
                ep.us.extend(self._u_host.copy() for _ in range(num_steps))
                ep.state_snapshots.extend([self._state] + states[:-1])
            self._state = states[-1]
            self._trajectory.extend(stacked.q.unbind(0))
        else:
            for _ in range(num_steps):
                if ep is not None:
                    ep.us.append(self._u_host.copy())
                    ep.state_snapshots.append(self._state)
                self._state = self.sim.step(self.model, self._state, self._u)
                self._trajectory.append(self._state.q)
        if test_derivatives:
            self._test_derivatives()

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

    # -- backward engine ---------------------------------------------------
    def saveBackwardCache(self):
        if self._episode is None:
            raise RuntimeError("saveBackwardCache: reset(backward_flag=True) "
                               "first")
        self._cache.append(self._episode)

    def popBackwardCache(self):
        self._episode = self._cache.pop()

    def clearBackwardCache(self):
        self._cache = []

    def _recorded(self, num_steps=None) -> _EpisodeRecord:
        ep = self._episode
        if ep is None:
            raise RuntimeError("no episode recorded: reset(backward_flag="
                               "True) before forward")
        if num_steps is not None and len(ep.us) < num_steps:
            raise ValueError(f"backward_steps({num_steps}): only "
                             f"{len(ep.us)} steps recorded")
        return ep

    def backward(self):
        ep = self._recorded()
        self._run_backward(ep.q0, ep.qdot0, np.stack(ep.us),
                           ep.state_snapshots[0])

    def backward_steps(self, num_steps: int):
        ep = self._recorded(num_steps)
        snap = ep.state_snapshots[-num_steps]
        self._run_backward(snap.q, snap.qdot, np.stack(ep.us[-num_steps:]),
                           snap)

    def _run_backward(self, q0, qdot0, us, state0: SimState):
        """Seeds df_dq / df_dvar / df_dtactile (numpy, T x width flattened;
        a missing one reads as zeros) on the rollout from ``state0`` with
        (q, qdot) = (q0, qdot0) under ``us``, and writes df_dq0, df_dqdot0,
        df_du (flat) and, with ``flag_p``, df_dp (a Model of cotangents)."""
        T = us.shape[0]
        struct, bi = self.struct, self.backward_info
        leaf = lambda a: (a.detach().clone() if isinstance(a, torch.Tensor)
                          else self._device_vector(a)).requires_grad_()
        q0_, qdot0_, us_ = leaf(q0), leaf(qdot0), leaf(us)
        model = (Model(**{f.name: getattr(self.model, f.name).detach()
                          .clone().requires_grad_()
                          for f in dataclasses.fields(Model)})
                 if bi.flag_p else self.model)
        rollout = self.sim.make_rollout_dense(remat=True)
        with torch.enable_grad():
            _, qs, vars_, tacs = rollout(
                model, state0.replace(q=q0_, qdot=qdot0_), us_)

        def seed(a, width):
            a = np.zeros(T * width) if a is None else np.asarray(a)
            return self._device_vector(a.reshape(T, width))

        outs, cots = [], []
        for out, a, width in ((qs, bi.df_dq, struct.ndof_q),
                              (vars_, bi.df_dvar, struct.ndof_var),
                              (tacs, bi.df_dtactile, struct.ndof_tactile)):
            if out.requires_grad:
                outs.append(out)
                cots.append(seed(a, width))
        wrt = [q0_, qdot0_, us_]
        if bi.flag_p:
            wrt += [getattr(model, f.name) for f in dataclasses.fields(Model)]
        grads = torch.autograd.grad(outs, wrt, cots, materialize_grads=True)
        host = lambda g: g.detach().cpu().numpy()
        r = self.backward_results
        r.df_dq0, r.df_dqdot0 = host(grads[0]), host(grads[1])
        r.df_du = host(grads[2]).reshape(-1)
        r.df_dp = Model(*grads[3:]) if bi.flag_p else None

    def _test_derivatives(self, eps: float = 1e-6):
        """The reference's ``test_derivatives`` self-check: d(next q)/du
        from ndof_q reverse passes against central differences on the
        first three controls."""
        state0 = (self._episode.state_snapshots[-1] if self._episode
                  else self._state)

        def qnext(uu):
            return self.sim.step(self.model, state0, uu).q

        u = self._u.detach().clone().requires_grad_()
        with torch.enable_grad():
            qn = qnext(u)
            eye = torch.eye(qn.shape[0], dtype=qn.dtype, device=qn.device)
            J = torch.stack([torch.autograd.grad(qn, u, eye[i],
                                                 retain_graph=True)[0]
                             for i in range(qn.shape[0])])
        J = J.cpu().numpy()
        with torch.no_grad():
            for k in range(min(u.shape[0], 3)):
                du = torch.zeros_like(u)
                du[k] = eps
                fd = ((qnext(u + du) - qnext(u - du)) / (2 * eps)).cpu()
                err = np.abs(fd.numpy() - J[:, k]).max()
                if not err < 1e-4 * max(1.0, np.abs(J[:, k]).max()):
                    raise AssertionError("derivative self-check failed for "
                                         f"u[{k}]: {err}")

    # -- runtime model editing ---------------------------------------------
    def _edit(self, **leaves):
        """Replace Model leaves with new tensors (never in place: caches
        such as the tactile read's plan key on the leaves)."""
        self.model = dataclasses.replace(self.model, **leaves)
        self._resync()

    def _set_rows(self, name, index, value):
        t = getattr(self.model, name).detach().clone()
        t[index] = torch.as_tensor(np.asarray(value, dtype=np.float64),
                                   dtype=t.dtype, device=t.device)
        return t

    def update_body_density(self, name: str, density: float):
        bi = self.struct.body_index(name)
        self.model = builder.update_body_density(
            self.struct.body_gtype[bi], self.model, bi, density)
        self._resync()

    def update_body_color(self, name: str, rgb):
        bi = self.struct.body_index(name)
        self._edit(body_rgba=self._set_rows("body_rgba", bi,
                                            list(rgb) + [1.0]))

    def update_body_size(self, name: str, size):
        """Cylinder: [length, radius] (the 0.03-long DClaw cap passes
        [0.03, radius]); cuboid: full extents; sphere: [radius]."""
        bi = self.struct.body_index(name)
        size = np.asarray(size, dtype=np.float64)
        gtype = self.struct.body_gtype[bi]
        if gtype == GEOM_CYLINDER:
            new = [size[1], size[0] / 2.0, 0.0]
        elif gtype == GEOM_SPHERE:
            new = [size[0], 0.0, 0.0]
        else:
            new = size
        self._edit(body_size=self._set_rows("body_size", bi, new))

    def update_joint_damping(self, name: str, damping: float):
        ji = self.struct.joint_index(name)
        off = self.struct.joint_dof_offset[ji]
        nd = self.struct.joint_ndof[ji]
        self._edit(dof_damping=self._set_rows("dof_damping",
                                              slice(off, off + nd), damping))

    def update_joint_location(self, name: str, pos):
        ji = self.struct.joint_index(name)
        self._edit(joint_pos=self._set_rows("joint_pos", ji, pos))

    def update_endeffector_position(self, name: str, pos):
        idx = self.struct.ee_names.index(name)
        self._edit(ee_pos=self._set_rows("ee_pos", idx, pos))

    def update_contact_parameters(self, body1: str, body2: str, kn=None,
                                  kt=None, mu=None, damping=None):
        b1 = self.struct.body_index(body1)
        b2 = self.struct.body_index(body2)
        rows = [p.param_index for p in self.struct.pairs
                if {p.general_body, p.primitive_body} == {b1, b2}]
        self._edit(**{f"pair_{k}": self._set_rows(f"pair_{k}", rows, v)
                      for k, v in (("kn", kn), ("kt", kt), ("mu", mu),
                                   ("damping", damping))
                      if v is not None and rows})

    def update_tactile_parameters(self, name: str, kn=None, kt=None, mu=None,
                                  damping=None):
        s = self.struct.sensor_index(name)
        self._edit(**{f"tac_{k}": self._set_rows(f"tac_{k}", s, v)
                      for k, v in (("kn", kn), ("kt", kt), ("mu", mu),
                                   ("damping", damping)) if v is not None})

    def update_virtual_object(self, name: str, pos_quat):
        vi = self.struct.virtual_names.index(name)
        pq = np.asarray(pos_quat, dtype=np.float64)
        self._edit(virtual_pos=self._set_rows("virtual_pos", vi, pq[:3]),
                   virtual_quat=self._set_rows("virtual_quat", vi, pq[3:7]))

    def _resync(self):
        self.sim.model = self.model

    def export_trajectory(self):
        if not self._trajectory:
            return np.zeros((0, self.ndof_r))
        return torch.stack(self._trajectory).cpu().numpy()

    # -- replay ------------------------------------------------------------
    def replay(self):
        """Render the recorded trajectory offline; returns the frame count.

        With ``viewer_options.record``, numbered PNG frames go into
        ``viewer_options.record_folder`` (an animated GIF where the folder
        ends with .gif; "replay_frames" where it is empty); otherwise the
        last frame's RGB pixels are kept in ``last_render``."""
        from ..utils import renderer
        qs = self.export_trajectory()
        if not len(qs):
            return 0
        vo = self.viewer_options
        if vo.record:
            return renderer.render_trajectory(
                self.struct, self.model, qs, vo.record_folder or
                "replay_frames", fps=vo.fps, speed=vo.speed, loop=vo.loop,
                camera=(vo.camera_pos, vo.camera_lookat))
        self.last_render = renderer.frame_pixels(
            renderer.render_frame(self.struct, self.model, qs[-1]))
        return 1
