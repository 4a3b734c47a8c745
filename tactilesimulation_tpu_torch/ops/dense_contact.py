"""K4: dense point-vs-primitive penalty contact, and the tactile read.

Port of ``tactilesimulation_tpu/ops/dense_contact.py``: the force on N world
points from ONE primitive body (sphere, cuboid, cylinder) or the ground
half-space, forward only. Per point: world to local, SDF and normal,
relative velocity (``v + w x d`` for the primitive), the normal force
``kn pen + damping pen pdot`` and the smooth Coulomb cap
``scale = cap / max(cap, kt |vt| + eps)``, with the tie rules of the JAX
kernel (cuboid: the normal averages the tied axes, sign(0) = 0; cylinder:
the radial face wins a tie).

Two entries of the hand-written kernel ``csrc/dense_contact.cu`` (nvcc at
first use, ctypes; float32 and float64 instances):

- ``dense_point_contact``, the JAX package's public function: CUDA tensors
  go to the points entry, CPU tensors to the plain PyTorch version
  ``dense_point_contact_ref``;
- ``tactile_read(plan, q, v)``: the whole sensor-frame tactile field of a
  scene in one launch, from a ``ReadPlan`` (the scene's tables on the
  card), for one state (n,) or a batch (B, n) of them (the grid's second
  dimension); ``ops/tactile_query.tactile_field`` takes it for CUDA
  tensors and keeps the plain version for CPU ones.

What a kernel does not take (dtype, shape, layout, device) raises, and so
does a failed build or launch; nothing falls back. ``launches`` counts the
points entry's launches and ``read_launches`` the read's, and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..model.schema import GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE
from ..sim.contact import GROUND

_EPS = 1e-9           # keep identical to sim/contact._EPS
N_SCALARS = 32        # packed primitive scalars (layout in the .cu file)
GTYPES = (GROUND, GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE)

launches = 0
read_launches = 0
MAX_READ_BATCH = 65535   # the grid's y dimension


def reset_counts():
    global launches, read_launches
    launches = 0
    read_launches = 0


def supported(gtype, x) -> bool:
    """True if K4 takes points ``x`` against primitive type ``gtype``."""
    return (int(gtype) in GTYPES and x.dtype in (torch.float32, torch.float64)
            and x.ndim == 2 and x.shape[1] == 3)


def pack_scalars(prim_pose, prim_vel, size, params, ground):
    """The kernel's (32,) scalar array, on the points' device: [p(3),
    R(9 row-major), v(3), w(3), size(3), kn, kt, mu, damping, gn(3),
    gn . ground_pos, 0, 0, 0]."""
    (p, R), (v, w) = prim_pose, prim_vel
    gpos, gn = ground
    return torch.cat([p.reshape(3), R.reshape(9), v.reshape(3), w.reshape(3),
                      size.reshape(3), params.reshape(4), gn.reshape(3),
                      torch.sum(gn * gpos).reshape(1),
                      p.new_zeros(3)])


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU route and the card's comparison)
# ---------------------------------------------------------------------------

def dense_point_contact_ref(gtype, x, xdot, prim_pose, prim_vel, size,
                            params, ground):
    """The kernel's arithmetic over (..., N, 3) rows, column by column in
    the kernel's order. The primitive's pose, velocity, size and parameters
    are shared or carry the points' leading batch axes."""
    (p, R), (v, w) = prim_pose, prim_vel
    gpos, gn = ground
    # a component of a primitive quantity, against the points' axis
    c = lambda a, *i: a[(Ellipsis,) + i + (None,)]
    kn, kt, mu, damping = (c(params, k) for k in range(4))
    xs = [x[..., i] for i in range(3)]
    xd = [xdot[..., i] for i in range(3)]
    gtype = int(gtype)
    if gtype == GROUND:
        off = c(torch.sum(gn * gpos, dim=-1))
        phi = xs[0] * c(gn, 0) + xs[1] * c(gn, 1) + xs[2] * c(gn, 2) - off
        n = [c(gn, i).expand(phi.shape) for i in range(3)]
        v_rel = xd
    else:
        d = [xs[i] - c(p, i) for i in range(3)]
        xl = [c(R, 0, i) * d[0] + c(R, 1, i) * d[1] + c(R, 2, i) * d[2]
              for i in range(3)]
        if gtype == GEOM_SPHERE:
            r = torch.sqrt(xl[0] ** 2 + xl[1] ** 2 + xl[2] ** 2 + _EPS ** 2)
            phi = r - c(size, 0)
            gl = [xl[i] / r for i in range(3)]
        elif gtype == GEOM_CUBOID:
            dd = [torch.abs(xl[i]) - c(size, i) * 0.5 for i in range(3)]
            dmax = torch.maximum(torch.maximum(dd[0], dd[1]), dd[2])
            outs = [torch.clamp(dd[i], min=0.0) for i in range(3)]
            out_norm = torch.sqrt(outs[0] ** 2 + outs[1] ** 2 + outs[2] ** 2
                                  + _EPS ** 2)
            phi = torch.where(dmax > 0, out_norm, dmax)
            hit = [(dd[i] == dmax).to(x.dtype) for i in range(3)]
            hit_sum = hit[0] + hit[1] + hit[2]
            gl = [torch.where(dmax > 0, outs[i] / out_norm, hit[i] / hit_sum)
                  * torch.sign(xl[i]) for i in range(3)]
        elif gtype == GEOM_CYLINDER:
            r2 = torch.sqrt(xl[0] ** 2 + xl[1] ** 2 + _EPS ** 2)
            dr = r2 - c(size, 0)
            dz = torch.abs(xl[2]) - c(size, 1)
            dmax = torch.maximum(dr, dz)
            o_r = torch.clamp(dr, min=0.0)
            o_z = torch.clamp(dz, min=0.0)
            out_norm = torch.sqrt(o_r ** 2 + o_z ** 2 + _EPS ** 2)
            phi = torch.where(dmax > 0, out_norm, dmax)
            pick_r = (dr >= dz).to(x.dtype)
            c_r = torch.where(dmax > 0, o_r / out_norm, pick_r)
            c_z = torch.where(dmax > 0, o_z / out_norm, 1.0 - pick_r)
            gl = [c_r * xl[0] / r2, c_r * xl[1] / r2,
                  c_z * torch.sign(xl[2])]
        else:
            raise ValueError(f"primitive type {gtype}")
        n = [c(R, i, 0) * gl[0] + c(R, i, 1) * gl[1] + c(R, i, 2) * gl[2]
             for i in range(3)]
        v_prim = [c(v, 0) + c(w, 1) * d[2] - c(w, 2) * d[1],
                  c(v, 1) + c(w, 2) * d[0] - c(w, 0) * d[2],
                  c(v, 2) + c(w, 0) * d[1] - c(w, 1) * d[0]]
        v_rel = [xd[i] - v_prim[i] for i in range(3)]

    pen = torch.clamp(-phi, min=0.0)
    vn = v_rel[0] * n[0] + v_rel[1] * n[1] + v_rel[2] * n[2]
    pdot = torch.clamp(-vn, min=0.0)
    fn_mag = kn * pen + damping * pen * pdot
    vt = [v_rel[i] - vn * n[i] for i in range(3)]
    vt_norm = torch.sqrt(vt[0] ** 2 + vt[1] ** 2 + vt[2] ** 2 + _EPS ** 2)
    cap = mu * fn_mag
    scale = cap / torch.maximum(cap, kt * vt_norm + _EPS)
    return torch.stack([fn_mag * n[i] - (kt * scale) * vt[i]
                        for i in range(3)], dim=-1)


# ---------------------------------------------------------------------------
# the op: kernel on the card, plain version on the CPU
# ---------------------------------------------------------------------------

def dense_point_contact(gtype, x, xdot, prim_pose, prim_vel, size, params,
                        ground):
    """Contact force on N points from one primitive (or the ground).

    Args:
      gtype: GROUND or GEOM_{CUBOID,CYLINDER,SPHERE}.
      x, xdot: (N, 3) world point positions and velocities.
      prim_pose: (p (3,), R (3, 3)) world pose of the primitive body.
      prim_vel: (v (3,), w (3,)) its linear and angular world velocity.
      size: (3,) primitive size row (``body_size`` semantics).
      params: (4,) [kn, kt, mu, damping].
      ground: (ground_pos (3,), ground_normal (3,)).

    Returns f (N, 3), the world-frame force on each point.
    """
    if x.is_cuda:
        return _run_kernel(gtype, x, xdot,
                           pack_scalars(prim_pose, prim_vel, size, params,
                                        ground))
    if x.device.type != "cpu":
        raise ValueError(f"dense_point_contact: no route for {x.device}")
    return dense_point_contact_ref(gtype, x, xdot, prim_pose, prim_vel,
                                   size, params, ground)


def _run_kernel(gtype, x, xdot, scal):
    """Launch K4 on the current stream; raises on what it does not take."""
    global launches
    gtype = int(gtype)
    if gtype not in GTYPES:
        raise ValueError(f"K4: primitive type {gtype} not in {GTYPES}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K4 takes float32 or float64; x is {x.dtype}")
    for name, a, shape in (("x", x, None), ("xdot", xdot, None),
                           ("scalars", scal, (N_SCALARS,))):
        if a.device != x.device:
            raise ValueError(f"{name} on {a.device}, x on {x.device}")
        if a.dtype != x.dtype:
            raise TypeError(f"{name} is {a.dtype}, x is {x.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        want = shape or (x.shape[0], 3)
        if a.ndim != len(want) or tuple(a.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{tuple(want)}")
    n = x.shape[0]
    f = torch.empty_like(x)
    if n == 0:
        return f
    lib = _library()
    fn = (lib.dense_contact_launch_f32 if x.dtype == torch.float32
          else lib.dense_contact_launch_f64)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(gtype, x.data_ptr(), xdot.data_ptr(), scal.data_ptr(), n,
             f.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    launches += 1
    return f


# ---------------------------------------------------------------------------
# the tactile read: one launch for the whole field
# ---------------------------------------------------------------------------

PAIR_INTS, PAIR_FLOATS = 4, 14
# the model leaves a plan packs; an edit of any of them (a new tensor or an
# in-place change) makes the plan stale
READ_LEAVES = ("joint_pos", "joint_quat", "joint_axis0", "body_pos",
               "body_quat", "body_size", "tac_pos", "tac_normal",
               "tac_axis0", "tac_axis1", "tac_kn", "tac_kt", "tac_mu",
               "tac_damping", "ground_pos", "ground_normal")


class ReadPlan:
    """A scene's tables for the read kernel, on the model's device and in
    its dtype (layout in ``csrc/dense_contact.cu``, ``load_read_scene``):
    the FK tables with each joint's depth in the tree, each tactile pair's
    rows, primitive type, body joint and constants (body pose in its joint,
    size, the pair's parameter row), and the markers as structure of
    arrays. The kernel sizes its shared memory from the plan's counts.
    ``fresh()`` is False once a model leaf it packed was replaced or
    changed in place.

    One plan serves a scene: a batched read takes shared scene leaves
    only, so a Model whose packed leaf carries a batch axis (a leading
    per-instance axis) raises."""

    def __init__(self, struct, model):
        from ..sim.types import LEAF_NDIM
        for k in READ_LEAVES:
            if getattr(model, k).ndim != LEAF_NDIM[k]:
                raise ValueError(
                    f"tactile read: the Model leaf {k} has shape "
                    f"{tuple(getattr(model, k).shape)}; the read takes "
                    "shared scene leaves only, not per-instance ones")
        n, J, N = struct.ndof_q, struct.njoints, len(struct.tac_joint)
        pairs = struct.tactile_pairs
        P = len(pairs)
        if min(n, J, P, N) < 1:
            raise ValueError(f"tactile read: {n} coordinates, {J} joints, "
                             f"{P} pairs, {N} rows; the kernel takes at "
                             "least 1 of each")
        parents = np.asarray(struct.joint_parents, np.int64)
        if np.any(parents >= np.arange(J)):
            raise ValueError("tactile read: a joint precedes its parent")
        depth = np.zeros(J, np.int64)
        for j, par in enumerate(parents):
            depth[j] = 0 if par < 0 else depth[par] + 1
        self.struct, self.model = struct, model
        self.n, self.J, self.P, self.N = n, J, P, N
        self.device, self.dtype = model.device, model.dtype
        f64 = lambda t: np.asarray(t.detach().cpu().numpy(), np.float64)
        tb = struct.fk_tables
        mflags = np.concatenate([np.asarray(tb[k], np.int64).reshape(J, 1)
                                 for k in ("m_rev", "m_exp", "m_eul")],
                                axis=1)
        prow, pint = [], []
        for pr in pairs:
            if pr.general_is_sphere:
                raise ValueError("tactile read: an analytic sphere pair")
            b = pr.primitive_body
            k = pr.param_index
            params = [f64(getattr(model, f"tac_{x}"))[k]
                      for x in ("kn", "kt", "mu", "damping")]
            if b < 0:
                pint.append([pr.point_start, pr.point_count, GROUND, 0])
                prow.append(np.concatenate([np.zeros(10), params]))
            else:
                gt = int(struct.body_gtype[b])
                if gt not in GTYPES:
                    raise ValueError(f"tactile read: primitive type {gt}")
                pint.append([pr.point_start, pr.point_count, gt,
                             struct.body_joint[b]])
                prow.append(np.concatenate([
                    f64(model.body_pos)[b], f64(model.body_quat)[b],
                    f64(model.body_size)[b], params]))
        ints = np.concatenate([
            parents, depth, np.asarray(tb["trans_idx"], np.int64).ravel(),
            np.asarray(tb["rot_idx"], np.int64).ravel(), mflags.ravel(),
            np.asarray(pint, np.int64).ravel(),
            np.asarray(struct.tac_joint, np.int64)])
        floats = np.concatenate([
            f64(model.ground_pos), f64(model.ground_normal),
            f64(model.joint_pos).ravel(), f64(model.joint_quat).ravel(),
            f64(model.joint_axis0).ravel(),
            np.asarray(tb["basis"], np.float64).ravel(),
            np.asarray(prow).ravel()]
            + [f64(getattr(model, k)).T.ravel()
               for k in ("tac_pos", "tac_normal", "tac_axis0",
                         "tac_axis1")])
        self.ints = torch.as_tensor(ints.astype(np.int32),
                                    device=self.device)
        self.floats = torch.as_tensor(floats, dtype=self.dtype,
                                      device=self.device)
        self._stamp = [(getattr(model, k), getattr(model, k)._version)
                       for k in READ_LEAVES]

    def fresh(self, model=None) -> bool:
        """True if ``model`` (default: the one the plan was made from)
        holds the very leaves the plan packed, unedited."""
        model = self.model if model is None else model
        return all(getattr(model, k) is t and t._version == ver
                   for k, (t, ver) in zip(READ_LEAVES, self._stamp))


def tactile_read(plan, q, v):
    """(N, 3) sensor-frame [shear0, shear1, normal] field of ``plan``'s
    scene at (q, v), or (B, N, 3) at a batch q, v (B, n): one launch of the
    read kernel on the current stream either way. Raises on what it does
    not take (q, v off the plan's device or dtype, not contiguous (n,) or
    (B, n) arrays of one shape, more than MAX_READ_BATCH states) without
    launching."""
    global read_launches
    for name, a in (("q", q), ("v", v)):
        if a.device != plan.device:
            raise ValueError(f"tactile read: {name} on {a.device}, the plan "
                             f"on {plan.device}")
        if a.dtype != plan.dtype:
            raise TypeError(f"tactile read: {name} is {a.dtype}, the plan "
                            f"{plan.dtype}")
        if (a.ndim not in (1, 2) or a.shape[-1] != plan.n
                or a.shape != q.shape or not a.is_contiguous()):
            raise ValueError(f"tactile read: {name} has shape "
                             f"{tuple(a.shape)}, expected a contiguous "
                             f"({plan.n},) or (B, {plan.n}) as q "
                             f"{tuple(q.shape)}")
    B = q.shape[0] if q.ndim == 2 else 1
    if not 1 <= B <= MAX_READ_BATCH:
        raise ValueError(f"tactile read: a batch of {B} states; the kernel "
                         f"takes 1 to {MAX_READ_BATCH}")
    out = torch.empty(q.shape[:-1] + (plan.N, 3), dtype=q.dtype,
                      device=q.device)
    lib = _library()
    fn = (lib.tactile_read_launch_f32 if q.dtype == torch.float32
          else lib.tactile_read_launch_f64)
    err = fn(plan.ints.data_ptr(), plan.floats.data_ptr(), q.data_ptr(),
             v.data_ptr(), plan.n, plan.J, plan.P, plan.N, B, out.data_ptr(),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        smem = lib.tactile_read_shared_bytes(plan.n, plan.J, plan.P,
                                             int(q.dtype == torch.float64))
        raise RuntimeError(f"tactile read launch failed: CUDA error {err} "
                           f"({plan.n} coordinates, {plan.J} joints and "
                           f"{plan.P} pairs ask for {smem} B of shared "
                           "memory a block)")
    read_launches += 1
    return out


def _library():
    from . import _build
    lib = _build.load("dense_contact")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dense_contact_launch_f32, lib.dense_contact_launch_f64):
            fn.argtypes = [i, p, p, p, i, p, p]
            fn.restype = ctypes.c_int
        for fn in (lib.tactile_read_launch_f32, lib.tactile_read_launch_f64):
            fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
            fn.restype = ctypes.c_int
        lib.dense_contact_scalars.restype = ctypes.c_int
        lib.tactile_read_shared_bytes.argtypes = [i, i, i, i]
        lib.tactile_read_shared_bytes.restype = ctypes.c_longlong
        lay = (ctypes.c_int * 2)()
        lib.tactile_read_layout(lay)
        if lib.dense_contact_scalars() != N_SCALARS or tuple(lay) != (
                PAIR_INTS, PAIR_FLOATS):
            raise RuntimeError("K4: the library's table layout differs")
        lib._typed = True
    return lib
