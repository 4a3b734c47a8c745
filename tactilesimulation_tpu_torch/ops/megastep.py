"""K2 / K3: the whole BDF1 env step and its exact IFT adjoint, one kernel per
direction.

Port of ``tactilesimulation_tpu/ops/megastep.py``. ``build_env_step_mega``
returns an env step that is a drop-in for ``sim/lanes.build_env_step``
(one chord factor per env step, exact at-solution adjoint) on a scene whose
model is baked in:

- forward (K2): the chord Jacobian at the entry state, a ridged no-pivot
  LU, then ``frame_skip`` substeps of chord iteration (best iterate); the
  step returns (q, qdot, q_prev = q - h vs[K-1], qdot_prev = vs[K-2]) and
  saves (q0, qd0, u, vs);
- backward (K3): in reverse over the substeps, J rebuilt at each solution,
  lambda = J^{-T} g, -lambda pulled back into (u, q_base, p_base) and
  p_base through momentum(q_k, qd_k); the q_prev / qdot_prev cotangents are
  folded in at the last substep.

Routes: a CUDA tensor goes to ``csrc/megastep.cu`` (nvcc at first use,
ctypes; one warp per lane; float32 and float64, each in a small instance
for scenes of up to 8 coordinates, joints, bodies and controls and a large
one for up to 16, which ``MegaStep.instance`` picks from the scene's
counts) and anything the kernels do not take raises (``limits()``);
a CPU tensor goes to the plain PyTorch version (``fwd_ref``, ``bwd_ref``),
which is ``sim/lanes.py``'s residual, chord and exact adjoint
with the megastep's tolerance floor max(solver_tol, 1e-7) in every dtype
and its contact-torque convention (``moving_point``: the primitive side's
torque at the moving contact point, so J and the adjoint are the
derivatives of the residual's value; the lanes stepper holds the point
fixed in the primitive's frame, as the JAX package's lanes path does).

Gradients reach the state and the controls; the model is a constant of the
step (no model cotangents, as on the JAX package's mega path), and the step
asserts that the model it is handed is the one it was built with.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..model.schema import JOINT_FREE3D_EULER, JOINT_FREE3D_EXP
from ..sim import contact, lanes
from .lane_contact import build_segments

_SEG_COLS = 8


def supported(struct, model) -> bool:
    """Mega-path preconditions (the JAX package's ``supported``): BDF1,
    static model leaves, no sphere_general contact groups."""
    if struct.integrator.upper() != "BDF1":
        return False
    if any(g.sphere_general for g in struct.contact_groups):
        return False
    if model.body_mass.ndim != 1 or model.pair_kn.ndim != 1:
        return False
    return all(p < j for j, p in enumerate(struct.joint_parents))


# ---------------------------------------------------------------------------
# scene tables
# ---------------------------------------------------------------------------

class SceneTables:
    """Host snapshot of (struct, model) for the kernels: the JAX package's
    ``_SceneConst`` as numpy arrays, and ``packed(device, dtype)``, the two
    flat tables the kernels read (layout in ``csrc/megastep.cu``), built
    once per (device, dtype).

    ``xi`` is the padded (n_rows, 3) point table (rows of unused pad slots
    at 1e6, as the JAX package's); the kernels read the compact ``points``
    table in segment order, whose offsets the packed segment rows carry."""

    def __init__(self, struct, model):
        self.struct = struct
        self.n, self.J, self.NB = struct.ndof_q, struct.njoints, struct.nbodies
        self.nu = struct.ndof_u
        self.h = float(model.h)
        f64 = lambda t: np.asarray(t.detach().cpu().numpy(), np.float64)
        tb = struct.fk_tables
        self.trans_idx = np.asarray(tb["trans_idx"], np.int64)
        self.rot_idx = np.asarray(tb["rot_idx"], np.int64)
        self.basis = np.asarray(tb["basis"], np.float64)
        self.mflags = np.stack([np.asarray(tb[k], bool).reshape(-1)
                                for k in ("m_rev", "m_exp", "m_eul")],
                               axis=1)                        # (J, 3)
        self.parents = np.asarray(struct.joint_parents, np.int64)
        self.body_joint = np.asarray(struct.body_joint, np.int64)
        self.motor_dof = np.asarray(struct.motor_dof, np.int64)
        (self.segments, self.n_rows, self.src_idx,
         self.packed_rows) = build_segments(struct)
        both = [f64(a) for a, idx in ((model.cp_pos, struct.cp_joint),
                                      (model.tac_pos, struct.tac_joint))
                if len(idx)]
        all_pts = np.concatenate(both, axis=0) if both else np.zeros((0, 3))
        self.points = all_pts[self.src_idx] if len(self.src_idx) else \
            np.zeros((0, 3))
        self.xi = np.full((self.n_rows, 3), 1e6)
        if len(self.src_idx):
            self.xi[self.packed_rows] = self.points
        self.params = f64(contact.combined_params(model))
        self.anc = np.asarray(lanes._dof_tables(struct), bool)     # (n, J)
        rot = np.zeros(self.n, bool)
        for j, jt in enumerate(struct.joint_types):
            if self.mflags[j, 0]:
                rot[self.rot_idx[j, 0]] = True
            elif jt in (JOINT_FREE3D_EXP, JOINT_FREE3D_EULER):
                rot[self.rot_idx[j]] = True
        self.rot_mask = rot
        seg, off = [], 0
        for s in self.segments:
            seg.append([off, s.n, s.joint, s.prim_body, s.prim_joint, s.gtype,
                        s.param_row, s.tac0])
            off += s.n
        self.seg = np.asarray(seg, np.int64).reshape(-1, _SEG_COLS)
        self._ints = np.concatenate([
            [self.n, self.J, self.NB, self.nu, len(self.segments),
             len(self.params), len(self.points)],
            self.parents, self.trans_idx.ravel(), self.rot_idx.ravel(),
            self.mflags.astype(np.int64).ravel(), self.body_joint,
            self.motor_dof, self.seg.ravel(),
            self.anc.astype(np.int64).ravel(),
            self.rot_mask.astype(np.int64)]).astype(np.int32)
        self._floats = np.concatenate([
            [self.h], f64(model.gravity), f64(model.ground_pos),
            f64(model.ground_normal),
            f64(model.joint_pos).ravel(), f64(model.joint_quat).ravel(),
            f64(model.joint_axis0).ravel(), self.basis.ravel(),
            f64(model.body_pos).ravel(), f64(model.body_quat).ravel(),
            f64(model.body_mass), f64(model.body_inertia).ravel(),
            f64(model.body_size).ravel(),
            f64(model.dof_damping), f64(model.dof_lim_lower),
            f64(model.dof_lim_upper), f64(model.dof_lim_stiffness),
            f64(model.motor_kp), f64(model.motor_kd),
            f64(model.motor_ctrl_lo), f64(model.motor_ctrl_hi),
            f64(model.motor_pos_mask),
            self.params.ravel(), self.points.ravel()])
        self._dev = {}

    def packed(self, device, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ints int32, floats ``dtype``) on ``device``, made once."""
        key = (torch.device(device), dtype)
        hit = self._dev.get(key)
        if hit is None:
            hit = (torch.as_tensor(self._ints, device=device),
                   torch.as_tensor(self._floats, dtype=dtype, device=device))
            self._dev[key] = hit
        return hit


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU route and the card's comparison)
# ---------------------------------------------------------------------------

def _inputs(struct, model, q, qd, u):
    return lanes.StepInputs(model=model, u=u, q_base=q,
                            p_base=lanes.momentum(struct, model, q, qd),
                            gamma=model.h.to(q.dtype).reshape(1, 1))


def fwd_ref(struct, model, frame_skip, max_iter, tol, q, qd, u):
    """K2's plain version: (q_K, qd_K, vs (K, n, B))."""
    residual = lanes.make_residual(struct, moving_point=True)
    with torch.no_grad():
        lu = lanes.make_chord_lu(residual, _inputs(struct, model, q, qd, u),
                                 qd)
        vs = []
        for _ in range(frame_skip):
            v = lanes._chord(residual, max_iter, tol,
                             _inputs(struct, model, q, qd, u), qd, lu)
            vs.append(v)
            q, qd = q + model.h.to(q.dtype) * v, v
    return q, qd, torch.stack(vs)


def bwd_ref(struct, model, q0, qd0, u, vs, gq, gqd, gqp, gqdp):
    """K3's plain version: (g_q0, g_qd0, g_u) by the exact adjoint of each
    substep (``lanes.chord_adjoint``) and autograd through momentum."""
    residual = lanes.make_residual(struct, moving_point=True)
    h = model.h.to(q0.dtype)
    K = vs.shape[0]
    qs, qds = [q0], [qd0]
    for k in range(K - 1):
        qs.append(qs[-1] + h * vs[k])
        qds.append(vs[k])
    g_q, g_v, g_u = gq, gqd, torch.zeros_like(u)
    for k in reversed(range(K)):
        gvs = g_v + h * g_q
        with torch.enable_grad():
            qk = qs[k].detach().requires_grad_()
            qdk = qds[k].detach().requires_grad_()
            p_base = lanes.momentum(struct, model, qk, qdk)
            inputs = lanes.StepInputs(model=model, u=u, q_base=qk.detach(),
                                      p_base=p_base.detach(),
                                      gamma=h.reshape(1, 1))
            bu, bq, bp = lanes.chord_adjoint(residual, inputs, vs[k], gvs)
            mq, mv = torch.autograd.grad(p_base, (qk, qdk), bp)
        g_q = g_q + bq + mq
        g_v = mv
        if k == K - 1:
            g_q, g_v = g_q + gqp, g_v + gqdp
        g_u = g_u + bu
    return g_q, g_v, g_u


# ---------------------------------------------------------------------------
# the op: kernels on the card, plain version on the CPU
# ---------------------------------------------------------------------------

_LIB_DTYPES = {torch.float32: ("f32", ctypes.c_float),
               torch.float64: ("f64", ctypes.c_double)}


def _library():
    from . import _build
    lib = _build.load("megastep")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for tag, scalar in _LIB_DTYPES.values():
            fwd = [p, p, i, i, scalar, p, p, p, i, p, p, p, p, p]
            bwd = [p, p, i] + [p] * 8 + [i, p, p, p, p]
            for name, args in ((f"megastep_fwd_{tag}", fwd),
                               (f"megastep_fwd_m_{tag}", [i] + fwd),
                               (f"megastep_bwd_{tag}", bwd),
                               (f"megastep_bwd_m_{tag}", [i] + bwd)):
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = i
        for name, args in (("megastep_limits", [p]),
                           ("megastep_kernel_info", [i, p])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        lib._typed = True
    return lib


def limits() -> dict:
    """What the kernels' largest instance takes, and the small instance's
    bound."""
    out = (ctypes.c_int * 8)()
    _library().megastep_limits(out)
    n, J, NB, nu, _, S, Kp, small = out
    return dict(n=n, joints=J, bodies=NB, controls=nu, segments=S,
                param_rows=Kp, small_instance=small)


INFO_FIELDS = ("M", "scalar_bytes", "registers", "local_bytes",
               "static_shared_bytes", "dynamic_shared_bytes",
               "lanes_per_block", "blocks_per_sm", "stack_limit_bytes")


def kernel_info() -> dict:
    """Per instance ("K2 f32 M=8", ...): what the compiler made of it
    (cudaFuncGetAttributes), the shared memory of a block and the resident
    blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib, res = _library(), {}
    for which in range(8):
        out = (ctypes.c_int * len(INFO_FIELDS))()
        err = lib.megastep_kernel_info(which, out)
        if err != 0:
            raise RuntimeError(f"megastep_kernel_info({which}): CUDA error "
                               f"{err}")
        d = dict(zip(INFO_FIELDS, out))
        name = (f"{'K3' if which & 1 else 'K2'} "
                f"{'f32' if d['scalar_bytes'] == 4 else 'f64'} M={d['M']}")
        res[name] = d
    return res


@dataclasses.dataclass
class MegaStep:
    """K2/K3 for one scene and model. ``fwd_launches`` / ``bwd_launches``
    count kernel launches (and nothing else); ``last_residuals`` holds K2's
    per-lane count of residual evaluations from its last launch (the chord
    stops early on converged lanes)."""
    struct: object
    model: object
    frame_skip: int
    max_iter: int

    def __post_init__(self):
        if not supported(self.struct, self.model):
            raise ValueError("megastep: scene outside the mega path "
                             "(BDF1, static model, no sphere_general)")
        self.tables = SceneTables(self.struct, self.model)
        self.tol = max(self.struct.solver_tol, 1e-7)
        self.fwd_launches = 0
        self.bwd_launches = 0
        self.last_residuals = None

    def reset_counts(self):
        self.fwd_launches = self.bwd_launches = 0

    # -- plain version -------------------------------------------------------
    def fwd_ref(self, q, qd, u):
        return fwd_ref(self.struct, self.model.to(q.device, q.dtype),
                       self.frame_skip, self.max_iter, self.tol, q, qd, u)

    def bwd_ref(self, q, qd, u, vs, gq, gqd, gqp, gqdp):
        return bwd_ref(self.struct, self.model.to(q.device, q.dtype), q, qd,
                       u, vs, gq, gqd, gqp, gqdp)

    # -- kernels -------------------------------------------------------------
    def instance(self) -> int:
        """The bound M of the kernels' instance that takes this scene: the
        small one where its counts fit, else the large one."""
        lim, t = limits(), self.tables
        small = lim["small_instance"]
        return small if max(t.n, t.J, t.NB, t.nu) <= small else lim["n"]

    def _check(self, tensors, shapes):
        first = tensors[0]
        if first.dtype not in _LIB_DTYPES:
            raise TypeError(f"megastep takes float32 or float64, not "
                            f"{first.dtype}")
        t = self.tables
        lim = limits()
        if (t.n > lim["n"] or t.J > lim["joints"] or t.NB > lim["bodies"]
                or t.nu > lim["controls"] or len(t.segments) > lim["segments"]
                or len(t.params) > lim["param_rows"]):
            raise ValueError(f"megastep: scene larger than the kernels' "
                             f"limits {lim}")
        for name, a, want in zip(shapes, tensors, shapes.values()):
            if a.device != first.device or a.dtype != first.dtype:
                raise ValueError(f"{name}: {a.device} {a.dtype}, expected "
                                 f"{first.device} {first.dtype}")
            if not a.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
            if tuple(a.shape) != want:
                raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                                 f"expected {want}")

    def run_fwd(self, q, qd, u):
        """Launch K2: (q_K, qd_K, vs) for CUDA tensors q, qd (n, B), u
        (nu, B) of one dtype."""
        n, nu, K = self.tables.n, self.tables.nu, self.frame_skip
        B = q.shape[-1]
        self._check((q, qd, u), {"q": (n, B), "qdot": (n, B), "u": (nu, B)})
        ints, floats = self.tables.packed(q.device, q.dtype)
        qo, qdo = torch.empty_like(q), torch.empty_like(q)
        vs = torch.empty((K, n, B), dtype=q.dtype, device=q.device)
        nres = torch.empty(B, dtype=torch.int32, device=q.device)
        if B:
            tag = _LIB_DTYPES[q.dtype][0]
            err = getattr(_library(), f"megastep_fwd_m_{tag}")(
                self.instance(), ints.data_ptr(), floats.data_ptr(), K,
                self.max_iter, self.tol, q.data_ptr(), qd.data_ptr(),
                u.data_ptr(), B, qo.data_ptr(), qdo.data_ptr(),
                vs.data_ptr(), nres.data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"K2 launch failed: CUDA error {err}")
            self.fwd_launches += 1
        self.last_residuals = nres
        return qo, qdo, vs

    def run_bwd(self, q, qd, u, vs, gq, gqd, gqp, gqdp):
        """Launch K3: (g_q0, g_qd0, g_u)."""
        n, nu, K = self.tables.n, self.tables.nu, self.frame_skip
        B = q.shape[-1]
        self._check((q, qd, u, vs, gq, gqd, gqp, gqdp),
                    {"q": (n, B), "qdot": (n, B), "u": (nu, B),
                     "vs": (K, n, B), "g_q": (n, B), "g_qdot": (n, B),
                     "g_q_prev": (n, B), "g_qdot_prev": (n, B)})
        ints, floats = self.tables.packed(q.device, q.dtype)
        gq0, gqd0 = torch.empty_like(q), torch.empty_like(q)
        gu = torch.empty_like(u)
        if B:
            tag = _LIB_DTYPES[q.dtype][0]
            err = getattr(_library(), f"megastep_bwd_m_{tag}")(
                self.instance(), ints.data_ptr(), floats.data_ptr(), K,
                *(a.data_ptr() for a in (q, qd, u, vs, gq, gqd, gqp, gqdp)),
                B, gq0.data_ptr(), gqd0.data_ptr(), gu.data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"K3 launch failed: CUDA error {err}")
            self.bwd_launches += 1
        return gq0, gqd0, gu

    # -- routing -------------------------------------------------------------
    def forward(self, q, qd, u):
        if q.is_cuda:
            return self.run_fwd(q, qd, u)
        if q.device.type != "cpu":
            raise ValueError(f"megastep: no route for {q.device}")
        return self.fwd_ref(q, qd, u)

    def backward(self, q, qd, u, vs, gq, gqd, gqp, gqdp):
        if q.is_cuda:
            return self.run_bwd(q, qd, u, vs, gq, gqd, gqp, gqdp)
        if q.device.type != "cpu":
            raise ValueError(f"megastep: no route for {q.device}")
        return self.bwd_ref(q, qd, u, vs, gq, gqd, gqp, gqdp)


class _MegaStepFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, q, qd, u):
        q, qd, u = (a.contiguous() for a in (q, qd, u))
        qo, qdo, vs = op.forward(q, qd, u)
        K = op.frame_skip
        h = op.model.h.to(q.dtype)
        q_prev = qo - h * vs[K - 1]
        qd_prev = (vs[K - 2] if K >= 2 else qd).clone()
        ctx.op = op
        ctx.save_for_backward(q, qd, u, vs)
        return qo, qdo, q_prev, qd_prev

    @staticmethod
    def backward(ctx, gqo, gqdo, gqp, gqdp):
        q, qd, u, vs = ctx.saved_tensors
        g = [torch.zeros_like(q) if x is None else x.contiguous()
             for x in (gqo, gqdo, gqp, gqdp)]
        gq0, gqd0, gu = ctx.op.backward(q, qd, u, vs, *g)
        return None, gq0, gqd0, gu


def build_env_step_mega(struct, model, frame_skip: int, *, max_iter: int = 8):
    """env_step(model, state, u) -> state' through K2/K3, a drop-in for
    ``lanes.build_env_step(struct, frame_skip, max_iter=max_iter,
    moving_point=True)`` with the megastep's tolerance floor. ``model`` is
    baked in: the step raises if it is handed another model object (checked
    by identity, no device sync)."""
    op = MegaStep(struct, model, frame_skip, max_iter)

    def env_step(model_arg, state: lanes.LaneSimState, u):
        if model_arg is not model:
            raise ValueError("megastep: the env step was built for another "
                             "model (its model is baked in)")
        q, qd, qp, qdp = _MegaStepFn.apply(op, state.q, state.qdot,
                                           u.to(state.q.dtype))
        return lanes.LaneSimState(q=q, qdot=qd, q_prev=qp, qdot_prev=qdp,
                                  t=state.t + frame_skip)

    env_step.op = op
    return env_step
