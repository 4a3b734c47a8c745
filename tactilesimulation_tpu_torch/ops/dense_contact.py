"""K4: dense point-vs-primitive penalty contact (the tactile query's kernel).

Port of ``tactilesimulation_tpu/ops/dense_contact.py``: the force on N world
points from ONE primitive body (sphere, cuboid, cylinder) or the ground
half-space, forward only. Per point: world to local, SDF and normal,
relative velocity (``v + w x d`` for the primitive), the normal force
``kn pen + damping pen pdot`` and the smooth Coulomb cap
``scale = cap / max(cap, kt |vt| + eps)``, with the tie rules of the JAX
kernel (cuboid: the normal averages the tied axes, sign(0) = 0; cylinder:
the radial face wins a tie).

Routes:
- CUDA tensors go to the hand-written kernel ``csrc/dense_contact.cu``
  (nvcc at first use, ctypes; float32 and float64 instances); what it does
  not take (dtype, shape, layout, device) raises, and so does a failed
  build or launch;
- CPU tensors go to the plain PyTorch version ``dense_point_contact_ref``.

``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from ..model.schema import GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE
from ..sim.contact import GROUND

_EPS = 1e-9           # keep identical to sim/contact._EPS
N_SCALARS = 32        # packed primitive scalars (layout in the .cu file)
GTYPES = (GROUND, GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE)

launches = 0


def reset_counts():
    global launches
    launches = 0


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
    """The kernel's arithmetic over (N, 3) rows, column by column in the
    kernel's order."""
    (p, R), (v, w) = prim_pose, prim_vel
    gpos, gn = ground
    kn, kt, mu, damping = params[0], params[1], params[2], params[3]
    xs = [x[:, i] for i in range(3)]
    xd = [xdot[:, i] for i in range(3)]
    gtype = int(gtype)
    if gtype == GROUND:
        off = torch.sum(gn * gpos)
        phi = xs[0] * gn[0] + xs[1] * gn[1] + xs[2] * gn[2] - off
        n = [gn[i].expand(phi.shape) for i in range(3)]
        v_rel = xd
    else:
        d = [xs[i] - p[i] for i in range(3)]
        xl = [R[0, i] * d[0] + R[1, i] * d[1] + R[2, i] * d[2]
              for i in range(3)]
        if gtype == GEOM_SPHERE:
            r = torch.sqrt(xl[0] ** 2 + xl[1] ** 2 + xl[2] ** 2 + _EPS ** 2)
            phi = r - size[0]
            gl = [xl[i] / r for i in range(3)]
        elif gtype == GEOM_CUBOID:
            dd = [torch.abs(xl[i]) - size[i] * 0.5 for i in range(3)]
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
            dr = r2 - size[0]
            dz = torch.abs(xl[2]) - size[1]
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
        n = [R[i, 0] * gl[0] + R[i, 1] * gl[1] + R[i, 2] * gl[2]
             for i in range(3)]
        v_prim = [v[0] + w[1] * d[2] - w[2] * d[1],
                  v[1] + w[2] * d[0] - w[0] * d[2],
                  v[2] + w[0] * d[1] - w[1] * d[0]]
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
                        for i in range(3)], dim=1)


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


def _library():
    from . import _build
    lib = _build.load("dense_contact")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dense_contact_launch_f32, lib.dense_contact_launch_f64):
            fn.argtypes = [i, p, p, p, i, p, p]
            fn.restype = ctypes.c_int
        lib.dense_contact_scalars.restype = ctypes.c_int
        if lib.dense_contact_scalars() != N_SCALARS:
            raise RuntimeError("K4: scalar layout of the library differs")
        lib._typed = True
    return lib
