"""K1: the fused lane-major contact pair-wrench op (the residual hot path).

Port of ``tactilesimulation_tpu/ops/lane_contact.py``. The op fuses, per
contact point and tactile marker,

    point FK              (owner-joint frame -> world)
    point velocity        (owner-joint twist)
    SDF vs primitive      (ground / cuboid / cylinder / sphere)
    relative velocity     (primitive-joint twist)
    penalty force         (sim/contact.py force law)
    per-joint wrenches    (F_j = sum f, T_j = sum x x f)

so that only the small per-joint arrays ((., J|NB, B)) and the dense tactile
rows cross device memory.

Routes:
- a CUDA tensor goes to the hand-written kernel ``csrc/lane_contact.cu``
  (built with nvcc at first use, bound with ctypes); anything else the
  kernel does not take (dtype, shape, device) raises;
- a CPU tensor goes to the plain PyTorch version ``wrenches_ref``.

Differentiation: ``_PairWrenchesFn`` is an ``autograd.Function`` whose
backward recomputes the plain twin once and pulls every cotangent through
that one graph, as the JAX package's ``custom_vjp`` does. There is no
backward kernel: the chord Jacobian's n pullbacks are the only place the
twin runs on the card's path (``PairWrenches.twin_vjps`` counts them).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..model.schema import GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE
from ..sim import lanes
from ..sim.contact import GROUND


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of contact points sharing (owner joint, primitive, params)."""
    row0: int          # 8-aligned row offset in the padded point table
    n: int             # actual number of points
    n_pad: int         # padded to a multiple of 8
    src0: int          # first index into the combined [cp; tac] point array
    joint: int         # owning joint of the general side
    prim_body: int     # primitive body index (-1 = ground)
    prim_joint: int    # owning joint of the primitive body (-1 = ground)
    gtype: int         # GROUND or GEOM_*
    param_row: int     # row into combined [pair; tactile] params
    tac0: int          # first tactile marker row, or -1


def build_segments(struct) -> Tuple[Tuple[Segment, ...], int, np.ndarray,
                                    np.ndarray]:
    """Split non-sphere contact groups into constant-metadata runs.

    Returns (segments, n_rows_padded, src_idx (Nsum,), packed_rows (Nsum,)):
    ``src_idx`` gathers the combined [cp_pos; tac_pos] table (segment by
    segment, so segment k's points are a contiguous run of the gathered
    table), ``packed_rows`` scatters the gathered rows into the padded
    point table of the plain twin.
    """
    pts_joint = np.concatenate([
        np.asarray(struct.cp_joint, np.int64),
        np.asarray(struct.tac_joint, np.int64)]) if (
            len(struct.cp_joint) + len(struct.tac_joint)) else \
        np.zeros(0, np.int64)
    body_joint = np.asarray(struct.body_joint, np.int64)

    segments = []
    src_idx, packed_rows = [], []
    row = 0
    for g in struct.contact_groups:
        if g.sphere_general:
            continue
        pidx = np.asarray(g.point_idx)
        prim = np.asarray(g.prim_body)
        par = np.asarray(g.param_idx)
        tac = np.asarray(g.tac_row)
        joints = pts_joint[pidx]
        k = 0
        N = len(pidx)
        while k < N:
            j0, pb0, pr0 = joints[k], prim[k], par[k]
            e = k + 1
            while e < N and joints[e] == j0 and prim[e] == pb0 \
                    and par[e] == pr0 \
                    and ((tac[e] < 0 and tac[k] < 0)
                         or (tac[e] >= 0 and tac[e] == tac[e - 1] + 1)):
                e += 1
            n = e - k
            n_pad = ((n + 7) // 8) * 8
            gt = int(g.gtype)
            segments.append(Segment(
                row0=row, n=n, n_pad=n_pad, src0=int(pidx[k]),
                joint=int(j0), prim_body=int(pb0) if gt != GROUND else -1,
                prim_joint=int(body_joint[pb0]) if gt != GROUND else -1,
                gtype=gt, param_row=int(pr0), tac0=int(tac[k])))
            src_idx.extend(pidx[k:e].tolist())
            packed_rows.extend(range(row, row + n))
            row += n_pad
            k = e
    n_rows = max(row, 8)
    return (tuple(segments), n_rows, np.asarray(src_idx, np.int64),
            np.asarray(packed_rows, np.int64))


def pack_points(struct, model, src_idx):
    """Gather the combined [cp_pos; tac_pos] rows in segment order
    (differentiable w.r.t. the model's point tables). ``src_idx`` is the
    host array from ``build_segments`` or its copy on the model's device."""
    if len(struct.cp_joint) == 0:
        all_pts = model.tac_pos
    elif len(struct.tac_joint) == 0:
        all_pts = model.cp_pos
    else:
        all_pts = torch.cat([model.cp_pos, model.tac_pos], dim=0)
    return all_pts[torch.as_tensor(src_idx, device=all_pts.device)]


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU route, backward, and the card's comparison)
# ---------------------------------------------------------------------------

def wrenches_ref(segments, J, ntac, jp, jq, Om, be, bp, bquat, sizes,
                 params, gpos, gn, xi_rows):
    """Lane-major plain twin of the kernel (the JAX package's
    ``_wrenches_ref``): (F (3,J,B), Tau (3,J,B), tac (3,ntac,B)).

    ``xi_rows`` is the padded (n_rows, 3) point table (segment s at
    ``s.row0``). Differentiable, with the material-point conventions of
    ``lanes.contact_terms``: the primitive-side application point is held
    fixed in the primitive's frame (``.detach()`` on its local coords)."""
    dtype = jp.dtype
    B = jp.shape[-1]
    F_cols = [jp.new_zeros((3, B))] * J
    T_cols = [jp.new_zeros((3, B))] * J
    tac = jp.new_zeros((3, max(ntac, 1), B))
    gpos, gn = gpos.to(dtype), gn.to(dtype)
    for s in segments:
        xi = xi_rows[s.row0:s.row0 + s.n].T[:, :, None]       # (3, n, 1)
        jqs = jq[:, s.joint][:, None]                          # (4, 1, B)
        prm_sel = params[s.param_row].to(dtype)                # (4,) | (4, B)
        x = jp[:, s.joint][:, None] + lanes.quat_rotate(jqs, xi)
        v_pt = lanes.cross(Om[:, s.joint][:, None], x) + be[:, s.joint][:, None]
        if s.gtype == GROUND:
            phi = torch.sum((x - gpos[:, None, None]) * gn[:, None, None],
                            dim=0)
            nrm = gn[:, None, None].expand(x.shape)
            v_rel = v_pt
        else:
            pb = s.prim_body
            bR = lanes.quat_to_mat(bquat[:, pb])               # (3, 3, B)
            d = x - bp[:, pb][:, None]
            xl = torch.stack([bR[0, i][None] * d[0] + bR[1, i][None] * d[1]
                              + bR[2, i][None] * d[2] for i in range(3)])
            size = sizes[pb].to(dtype)
            if s.gtype == GEOM_CUBOID:
                phi, gl = lanes._sdf_box(xl, (size / 2.0)[:, None, None])
            elif s.gtype == GEOM_CYLINDER:
                phi, gl = lanes._sdf_cylinder(xl, size[0], size[1])
            elif s.gtype == GEOM_SPHERE:
                phi, gl = lanes._sdf_sphere(xl, size[0])
            else:
                raise ValueError(s.gtype)
            nrm = torch.stack([bR[i, 0][None] * gl[0] + bR[i, 1][None] * gl[1]
                               + bR[i, 2][None] * gl[2] for i in range(3)])
            v_prim = (lanes.cross(Om[:, s.prim_joint][:, None], x)
                      + be[:, s.prim_joint][:, None])
            v_rel = v_pt - v_prim
        prm = (prm_sel[:, None, None] if prm_sel.ndim == 1
               else prm_sel[:, None, :])
        f = lanes._penalty_force(phi, nrm, v_rel, prm)
        fs = torch.sum(f, dim=1)
        F_cols[s.joint] = F_cols[s.joint] + fs
        T_cols[s.joint] = T_cols[s.joint] + torch.sum(lanes.cross(x, f), dim=1)
        if s.gtype != GROUND:
            pb = s.prim_body
            qp = bquat[:, pb][:, None]
            xi_p = lanes.quat_rotate(lanes.quat_conj(qp),
                                     x - bp[:, pb][:, None]).detach()
            x_app_p = bp[:, pb][:, None] + lanes.quat_rotate(qp, xi_p)
            F_cols[s.prim_joint] = F_cols[s.prim_joint] - fs
            T_cols[s.prim_joint] = T_cols[s.prim_joint] - torch.sum(
                lanes.cross(x_app_p, f), dim=1)
        if s.tac0 >= 0:
            rows = torch.arange(s.tac0, s.tac0 + s.n, device=f.device)
            tac = tac.index_add(1, rows, f)
    return (torch.stack(F_cols, dim=1), torch.stack(T_cols, dim=1),
            tac[:, :ntac])


# ---------------------------------------------------------------------------
# the op: kernel on the card, plain version on the CPU
# ---------------------------------------------------------------------------

_ARG_NAMES = ("jp", "jq", "Om", "be", "bp", "bquat", "sizes", "params",
              "gpos", "gn", "xi_packed")


class _PairWrenchesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *args):
        ctx.op = op
        ctx.twin = None
        ctx.save_for_backward(*args)
        if args[0].is_cuda:
            return op.run_kernel(*args)
        if args[0].device.type != "cpu":
            raise ValueError(f"pair wrenches: no route for {args[0].device}")
        return op.reference(*args)

    @staticmethod
    def backward(ctx, gF, gT, gtac):
        """Pull the cotangent through the plain twin, recomputed once per
        forward and reused by every backward call on the same graph (the
        chord Jacobian makes n of them)."""
        op = ctx.op
        need = ctx.needs_input_grad[1:]
        if ctx.twin is None:
            with torch.enable_grad():
                ins = [a.detach().requires_grad_(nd)
                       for a, nd in zip(ctx.saved_tensors, need)]
                outs = op.reference(*ins)
            ctx.twin = (ins, outs)
            op.twin_recomputes += 1
        ins, outs = ctx.twin
        op.twin_vjps += 1
        wrt = [x for x, nd in zip(ins, need) if nd]
        live = [(o, g) for o, g in zip(outs, (gF, gT, gtac))
                if o.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in live],
                                         wrt, [g for _, g in live],
                                         retain_graph=True,
                                         allow_unused=True))
        return (None,) + tuple(next(grads) if nd else None for nd in need)


class PairWrenches:
    """K1 for one scene: ``op(jp, jq, Om, be, bp, bquat, sizes, params,
    gpos, gn, xi_packed) -> (F (3,J,B), Tau (3,J,B), tac (3,ntac,B))``.

    ``xi_packed`` is the compact point table from ``pack_points``.
    ``launches`` counts kernel launches (and nothing else); ``twin_vjps``
    counts backward calls through the plain twin, ``twin_recomputes`` the
    twin forwards those calls needed."""

    def __init__(self, struct):
        (self.segments, self.n_rows, self.src_idx,
         self.packed_rows) = build_segments(struct)
        self.J = struct.njoints
        self.NB = struct.nbodies
        self.ntac = len(struct.tac_joint)
        self.nsum = len(self.src_idx)
        self.launches = 0
        self.twin_vjps = 0
        self.twin_recomputes = 0
        # compact per-segment table for the kernel: offsets into xi_packed
        seg = []
        off = 0
        for s in self.segments:
            seg.append([off, s.n, s.joint, s.prim_body, s.prim_joint,
                        s.gtype, s.param_row, s.tac0])
            off += s.n
        self._seg_np = np.asarray(seg, np.int32).reshape(-1, 8)
        self._dev = {}

    def _on(self, name, host, device):
        """A host table's copy on ``device``, made once."""
        key = (name, device)
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(host, device=device)
            self._dev[key] = t
        return t

    def reset_counts(self):
        self.launches = self.twin_vjps = self.twin_recomputes = 0

    def __call__(self, *args):
        if len(args) != len(_ARG_NAMES):
            raise TypeError(f"expected {len(_ARG_NAMES)} tensors")
        if args[0].is_cuda:
            args = tuple(a.contiguous() for a in args)
        return _PairWrenchesFn.apply(self, *args)

    def reference(self, jp, jq, Om, be, bp, bquat, sizes, params, gpos, gn,
                  xi_packed):
        """The plain twin on the compact point table."""
        rows = self._on("packed_rows", self.packed_rows, xi_packed.device)
        xi_rows = xi_packed.new_zeros((self.n_rows, 3)).index_copy(
            0, rows, xi_packed)
        return wrenches_ref(self.segments, self.J, self.ntac, jp, jq, Om, be,
                            bp, bquat, sizes, params, gpos, gn, xi_rows)

    def _check(self, args):
        jp = args[0]
        B = jp.shape[-1]
        J, NB = self.J, self.NB
        K = args[7].shape[0]
        shapes = {"jp": (3, J, B), "jq": (4, J, B), "Om": (3, J, B),
                  "be": (3, J, B), "bp": (3, NB, B), "bquat": (4, NB, B),
                  "sizes": (NB, 3), "gpos": (3,), "gn": (3,),
                  "xi_packed": (self.nsum, 3)}
        for name, a in zip(_ARG_NAMES, args):
            if a.device != jp.device:
                raise ValueError(f"{name} on {a.device}, jp on {jp.device}")
            if a.dtype != torch.float32:
                raise TypeError(f"K1 takes float32 only; {name} is {a.dtype}")
            if not a.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
            want = shapes.get(name)
            if want is not None and tuple(a.shape) != want:
                raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                                 f"expected {want}")
        params = args[7]
        if tuple(params.shape) not in ((K, 4), (K, 4, B)):
            raise ValueError(f"params has shape {tuple(params.shape)}")
        if self.segments and max(s.param_row for s in self.segments) >= K:
            raise ValueError("params has fewer rows than the segments use")
        return B

    def run_kernel(self, jp, jq, Om, be, bp, bquat, sizes, params, gpos, gn,
                   xi_packed):
        """Launch K1 on the current stream (CUDA float32 tensors only)."""
        args = (jp, jq, Om, be, bp, bquat, sizes, params, gpos, gn, xi_packed)
        B = self._check(args)
        F = torch.empty((3, self.J, B), dtype=torch.float32, device=jp.device)
        T = torch.empty_like(F)
        tac = torch.empty((3, self.ntac, B), dtype=torch.float32,
                          device=jp.device)
        if B == 0:
            return F, T, tac
        seg = self._on("segments", self._seg_np, jp.device)
        batched = params.ndim == 3
        row_stride, lane_stride = (B, 1) if batched else (1, 0)
        lib = _library()
        stream = torch.cuda.current_stream(jp.device).cuda_stream
        err = lib.lane_contact_launch(
            *(a.data_ptr() for a in args[:8]), row_stride, lane_stride,
            gpos.data_ptr(), gn.data_ptr(), xi_packed.data_ptr(),
            seg.data_ptr(), len(self.segments), self.J, self.NB, self.ntac,
            B, F.data_ptr(), T.data_ptr(), tac.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")
        self.launches += 1
        return F, T, tac


def _library():
    from . import _build
    lib = _build.load("lane_contact")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lane_contact_launch.argtypes = (
            [p] * 8 + [i, i] + [p] * 4 + [i] * 5 + [p] * 3 + [p])
        lib.lane_contact_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def make_pair_wrenches(struct):
    """(op, meta) for a scene, as the JAX package's ``make_pair_wrenches``:
    ``op`` is a ``PairWrenches`` (None when the scene has no point
    segments), ``meta = (segments, n_rows, src_idx, packed_rows)``."""
    op = PairWrenches(struct)
    meta = (op.segments, op.n_rows, op.src_idx, op.packed_rows)
    return (op if op.segments else None), meta
