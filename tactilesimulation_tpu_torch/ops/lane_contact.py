"""K1 and K1T: the fused lane-major contact pair-wrench op and its adjoint
(the residual hot path).

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
- a CUDA tensor goes to the hand-written kernels ``csrc/lane_contact.cu``
  (built with nvcc at first use, bound with ctypes): K1 forward, K1T for
  the backward; anything the kernels do not take (dtype, shape, device)
  raises;
- a CPU tensor goes to the plain PyTorch version ``wrenches_ref`` and, for
  the backward, its VJP.

Both kernels split a 32-lane tile's points into pieces dealt to the warps
of a thread-block cluster (``build_plan``; the layout is argued in the
``.cu``). ``megastep_host.py`` builds their per-tile routines as host C++,
so the CPU tests hold the CUDA source itself to the JAX package.

Differentiation: ``_PairWrenchesFn`` is an ``autograd.Function``. On the
card its backward launches K1T once per call (a chord Jacobian's n
pullbacks are n launches; the tactile observation's BPTT pullback is one),
computing only the cotangents autograd asks for; the plain twin never runs
there. On the CPU the backward recomputes the twin once per forward and
pulls every cotangent through that one graph, as the JAX package's
``custom_vjp`` does (``twin_recomputes``, ``twin_vjps`` count that route).
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
# the kernels' plan: pieces dealt in rounds (csrc/lane_contact.cu)
# ---------------------------------------------------------------------------

TILE = 32             # lanes per block (kTile)
WARPS = 4             # warps per block (kWarps)
CH = 8                # points per piece (kCH)
MAX_SPLIT = 8         # blocks per tile: the portable cluster size
HEADER = 16


def build_plan(segments):
    """The int32 plan K1 and K1T read (``csrc/lane_contact.cu``).

    Header (``HEADER`` ints): [segments S, pieces NP, blocks per tile NS,
    rounds, most segments a block stages in a round, repeated tactile rows,
    their points, offsets of the segment, piece, round, stage, repeated-row
    and repeated-point tables, total]. Tables: segments (S, 8) as
    ``build_segments`` gives them (offset into ``xi_packed``, n, joint,
    prim_body, prim_joint, gtype, param_row, tac0); pieces (NP, 6): segment,
    first point, n <= CH, first tactile row or -1, first scratch point or -1
    (rows that several segments write), staging slot; per (round, block):
    first staged segment, count; the staged segment ids; per repeated row:
    row, first entry, count; the entries: scratch points in segment order.

    A piece is at most CH points of one segment, cut where a tactile row
    starts or stops being shared with another segment. NS is the smallest
    power of two (at most MAX_SPLIT) whose NS x WARPS warps take every
    piece in one round, so it depends on the scene alone."""
    offs = np.cumsum([0] + [s.n for s in segments])
    owners = {}
    for si, s in enumerate(segments):
        if s.tac0 >= 0:
            for k in range(s.n):
                owners.setdefault(s.tac0 + k, []).append((si, k))
    shared_row = {r for r, o in owners.items() if len(o) > 1}
    pieces, scratch, nrep_pts = [], {}, 0
    for si, s in enumerate(segments):
        k0 = 0
        while k0 < s.n:
            rep = s.tac0 >= 0 and s.tac0 + k0 in shared_row
            n = 1
            while (n < CH and k0 + n < s.n
                   and (s.tac0 >= 0 and s.tac0 + k0 + n in shared_row) == rep):
                n += 1
            if rep:
                for k in range(k0, k0 + n):
                    scratch[(si, k)] = nrep_pts + k - k0
            pieces.append([si, int(offs[si]) + k0, n,
                           s.tac0 + k0 if s.tac0 >= 0 else -1,
                           nrep_pts if rep else -1, 0])
            nrep_pts += n if rep else 0
            k0 += n
    NP = len(pieces)
    ns = 1
    while ns < MAX_SPLIT and ns * WARPS < NP:
        ns *= 2
    per_round = ns * WARPS
    rounds = (NP + per_round - 1) // per_round
    round_tab, stage = [], []
    for r in range(rounds):
        for y in range(ns):
            p0 = (r * ns + y) * WARPS
            segs = []
            for p in range(p0, min(p0 + WARPS, NP)):
                if pieces[p][0] not in segs:
                    segs.append(pieces[p][0])
                pieces[p][5] = segs.index(pieces[p][0])
            round_tab.append([len(stage), len(segs)])
            stage += segs
    rep, rep_idx = [], []
    for r in sorted(shared_row):
        rep.append([r, len(rep_idx), len(owners[r])])
        rep_idx += [scratch[o] for o in owners[r]]
    seg = [[int(offs[i]), s.n, s.joint, s.prim_body, s.prim_joint, s.gtype,
            s.param_row, s.tac0] for i, s in enumerate(segments)]
    tables = [np.asarray(t, np.int64).reshape(-1, w) for t, w in (
        (seg, 8), (pieces, 6), (round_tab, 2), (stage, 1), (rep, 3),
        (rep_idx, 1))]
    hdr = np.zeros(HEADER, np.int64)
    hdr[:7] = [len(segments), NP, ns, rounds,
               max(c for _, c in round_tab), len(rep), nrep_pts]
    o = HEADER
    for i, t in enumerate(tables):
        hdr[7 + i] = o
        o += t.size
    hdr[13] = o
    return np.concatenate([hdr] + [t.ravel() for t in tables]).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the op: kernels on the card, plain version on the CPU
# ---------------------------------------------------------------------------

_ARG_NAMES = ("jp", "jq", "Om", "be", "bp", "bquat", "sizes", "params",
              "gpos", "gn", "xi_packed")
# K1T's per-tile partials: which shared leaf each bit of `want` asks for
_WANT = {6: 1, 7: 2, 8: 4, 9: 8, 10: 16}


class _PairWrenchesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *args):
        ctx.op = op
        ctx.twin = None
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*args)
        if args[0].is_cuda:
            return op.run_kernel(*args)
        if args[0].device.type != "cpu":
            raise ValueError(f"pair wrenches: no route for {args[0].device}")
        return op.reference(*args)

    @staticmethod
    def backward(ctx, gF, gT, gtac):
        """On the card: one K1T launch. On the CPU: pull the cotangent
        through the plain twin, recomputed once per forward and reused by
        every backward call on the same graph (the chord Jacobian makes n of
        them)."""
        op = ctx.op
        need = ctx.needs_input_grad[1:]
        args = ctx.saved_tensors
        cots = (gF, gT, gtac)
        if all(g is None for g in cots) or not any(need):
            return (None,) * (1 + len(need))
        if args[0].is_cuda:
            return (None,) + op.run_adjoint(args, cots, need)
        if ctx.twin is None:
            with torch.enable_grad():
                ins = [a.detach().requires_grad_(nd)
                       for a, nd in zip(args, need)]
                outs = op.reference(*ins)
            ctx.twin = (ins, outs)
            op.twin_recomputes += 1
        ins, outs = ctx.twin
        op.twin_vjps += 1
        wrt = [x for x, nd in zip(ins, need) if nd]
        live = [(o, g) for o, g in zip(outs, cots)
                if o.requires_grad and g is not None]
        if not live:
            return (None,) * (1 + len(need))
        grads = iter(torch.autograd.grad([o for o, _ in live],
                                         wrt, [g for _, g in live],
                                         retain_graph=True,
                                         allow_unused=True))
        return (None,) + tuple(next(grads) if nd else None for nd in need)


class PairWrenches:
    """K1 for one scene: ``op(jp, jq, Om, be, bp, bquat, sizes, params,
    gpos, gn, xi_packed) -> (F (3,J,B), Tau (3,J,B), tac (3,ntac,B))``.

    ``xi_packed`` is the compact point table from ``pack_points``.
    ``launches`` counts K1 launches and ``bwd_launches`` K1T launches (and
    nothing else); ``twin_vjps`` counts backward calls through the plain
    twin (the CPU route), ``twin_recomputes`` the twin forwards those calls
    needed."""

    def __init__(self, struct):
        (self.segments, self.n_rows, self.src_idx,
         self.packed_rows) = build_segments(struct)
        self.J = struct.njoints
        self.NB = struct.nbodies
        self.ntac = len(struct.tac_joint)
        self.nsum = len(self.src_idx)
        self.launches = 0
        self.bwd_launches = 0
        self.twin_vjps = 0
        self.twin_recomputes = 0
        self.plan = (build_plan(self.segments) if self.segments
                     else np.zeros(HEADER, np.int32))   # K1 and K1T
        self.header = self.plan[:HEADER].copy()
        covered = {s.tac0 + k for s in self.segments if s.tac0 >= 0
                   for k in range(s.n)}
        self._tac_full = covered == set(range(self.ntac))
        self._max_row = max((s.param_row for s in self.segments), default=-1)
        self._shapes = {}
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
        self.launches = self.bwd_launches = 0
        self.twin_vjps = self.twin_recomputes = 0

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

    def _check(self, args, dtype=torch.float32):
        jp, params = args[0], args[7]
        B, K = jp.shape[-1], params.shape[0]
        shapes = self._shapes.get((B, K, params.dim()))
        if shapes is None:
            J, NB = self.J, self.NB
            if params.dim() not in (2, 3) or (
                    tuple(params.shape[1:]) != ((4,) if params.dim() == 2
                                                else (4, B))):
                raise ValueError(f"params has shape {tuple(params.shape)}")
            if self.segments and self._max_row >= K:
                raise ValueError("params has fewer rows than the segments "
                                 "use")
            shapes = ((3, J, B), (4, J, B), (3, J, B), (3, J, B),
                      (3, NB, B), (4, NB, B), (NB, 3), tuple(params.shape),
                      (3,), (3,), (self.nsum, 3))
            self._shapes[(B, K, params.dim())] = shapes
        dev = jp.device
        for name, a, shape in zip(_ARG_NAMES, args, shapes):
            if (a.dtype != dtype or a.shape != shape or a.device != dev
                    or not a.is_contiguous()):
                _check_tensor(name, a, dev, shape, dtype)
        return B

    def run_kernel(self, jp, jq, Om, be, bp, bquat, sizes, params, gpos, gn,
                   xi_packed):
        """Launch K1 on the current stream (CUDA float32 tensors only)."""
        return self.forward_with(
            (jp, jq, Om, be, bp, bquat, sizes, params, gpos, gn, xi_packed),
            self._cuda_launch)

    def run_adjoint(self, args, cots, need):
        """Launch K1T on the current stream: the cotangents of the 11 inputs
        (None where ``need`` is False) from those of (F, Tau, tac), any of
        which may be None (zero). CUDA float32 tensors only."""
        return self.adjoint_with(args, cots, need, self._cuda_launch)

    def forward_with(self, args, launch, dtype=torch.float32):
        """K1 through ``launch(adjoint, args, cots, outs, want)``: the
        card's (``run_kernel``) or ``megastep_host``'s host build
        (float64)."""
        B = self._check(args, dtype)
        new = lambda *shape: torch.empty(shape, dtype=dtype,
                                         device=args[0].device)
        F, T = new(3, self.J, B), new(3, self.J, B)
        tac = new(3, self.ntac, B)
        if not self._tac_full:          # rows no segment writes
            tac.zero_()
        if B == 0 or not self.segments:
            return F.zero_(), T.zero_(), tac.zero_()
        nrep = int(self.header[6])
        outs = (F, T, tac, new(nrep, 3, B) if nrep else None)
        launch(False, args, (None,) * 3, outs, 0)
        return F, T, tac

    def adjoint_with(self, args, cots, need, launch, dtype=torch.float32):
        """K1T through ``launch`` (see ``forward_with``); the per-tile
        partials of the shared leaves are summed over tiles here."""
        B = self._check(args, dtype)
        dev = args[0].device
        shapes = ((3, self.J, B), (3, self.J, B), (3, self.ntac, B))
        cots = tuple(None if g is None else g.contiguous() for g in cots)
        for name, g, shape in zip(("gF", "gT", "gtac"), cots, shapes):
            if g is not None:
                _check_tensor(name, g, dev, shape, dtype)
        params = args[7]
        per_lane = params.ndim == 3
        grads = [torch.empty_like(a) if nd else None
                 for a, nd in zip(args, need)]
        want = sum(bit for i, bit in _WANT.items()
                   if need[i] and not (i == 7 and per_lane))
        for i in _WANT:
            if not (i == 7 and per_lane):
                grads[i] = None
        K = params.shape[0]
        NB, nsum = self.NB, self.nsum
        width = 3 * NB + 4 * K + 6 + 3 * nsum
        if B == 0 or not self.segments:
            sh = torch.zeros(width, dtype=dtype, device=dev)
            grads = [None if g is None else g.zero_() for g in grads]
        else:
            ntiles = (B + TILE - 1) // TILE
            shared = (torch.empty((ntiles, width), dtype=dtype, device=dev)
                      if want else None)
            launch(True, args, cots, (*grads[:6], grads[7], shared), want)
            sh = shared.sum(0) if want else None     # over tiles, in order
        views = {6: (0, (NB, 3)), 7: (3 * NB, (K, 4)), 8: (3 * NB + 4 * K, (3,)),
                 9: (3 * NB + 4 * K + 3, (3,)),
                 10: (3 * NB + 4 * K + 6, (nsum, 3))}
        for i, (o, shape) in views.items():
            if need[i] and not (i == 7 and per_lane):
                n = int(np.prod(shape))
                grads[i] = sh[o:o + n].view(shape)
        return tuple(grads)

    def _cuda_launch(self, adjoint, args, cots, outs, want):
        jp, params = args[0], args[7]
        B, K = jp.shape[-1], params.shape[0]
        row_stride, lane_stride = (B, 1) if params.ndim == 3 else (1, 0)
        plan = self._on("plan", self.plan, jp.device)
        ptr = lambda t: 0 if t is None else t.data_ptr()
        head = (self.header.ctypes.data, plan.data_ptr(),
                *(a.data_ptr() for a in args[:8]), row_stride, lane_stride,
                *(a.data_ptr() for a in args[8:]), self.J, self.NB, K,
                self.ntac, self.nsum, B)
        stream = torch.cuda.current_stream(jp.device).cuda_stream
        lib = _library()
        if adjoint:
            err = lib.lane_contact_adjoint_launch(
                *head, *(ptr(t) for t in cots + outs), want, stream)
        else:
            err = lib.lane_contact_launch(*head, *(ptr(t) for t in outs),
                                          stream)
        if err != 0:
            raise RuntimeError(f"K1{'T' if adjoint else ''} launch failed: "
                               f"CUDA error {err}")
        if adjoint:
            self.bwd_launches += 1
        else:
            self.launches += 1


def _check_tensor(name, a, device, shape, dtype):
    """Raise on what the kernels do not take."""
    if a.device != device:
        raise ValueError(f"{name} on {a.device}, jp on {device}")
    if a.dtype != dtype:
        raise TypeError(f"K1 takes {str(dtype)[6:]} only; {name} is "
                        f"{a.dtype}")
    if tuple(a.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                         f"expected {shape}")
    if not a.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _library():
    from . import _build
    lib = _build.load("lane_contact")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p, p] + [p] * 8 + [i, i] + [p] * 3 + [i] * 6
        lib.lane_contact_launch.argtypes = head + [p] * 4 + [p]
        lib.lane_contact_launch.restype = i
        lib.lane_contact_adjoint_launch.argtypes = (
            head + [p] * 3 + [p] * 8 + [i, p])
        lib.lane_contact_adjoint_launch.restype = i
        lib.lane_contact_kernel_info.argtypes = [p, i, i, i, i, p]
        lib.lane_contact_kernel_info.restype = i
        lib._typed = True
    return lib


def kernel_info(op, K, B):
    """{"K1": ..., "K1T": ...}: registers, local bytes per thread, dynamic
    shared bytes per block and resident clusters on the device, at op's
    plan with K parameter rows and B lanes (needs the card)."""
    out = np.zeros(8, np.int32)
    err = _library().lane_contact_kernel_info(
        op.header.ctypes.data, op.J, op.NB, K, B, out.ctypes.data)
    if err != 0:
        raise RuntimeError(f"lane_contact_kernel_info: CUDA error {err}")
    keys = ("registers", "local_bytes", "dynamic_shared_bytes", "clusters")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4].tolist()))
            for i, name in enumerate(("K1", "K1T"))}


def make_pair_wrenches(struct):
    """(op, meta) for a scene, as the JAX package's ``make_pair_wrenches``:
    ``op`` is a ``PairWrenches`` (None when the scene has no point
    segments), ``meta = (segments, n_rows, src_idx, packed_rows)``."""
    op = PairWrenches(struct)
    meta = (op.segments, op.n_rows, op.src_idx, op.packed_rows)
    return (op if op.segments else None), meta
