"""The kernels' device code built as host C++ with ``g++``.

The kernels' device code compiles as plain C++ when the CUDA qualifiers are
stubbed out; the launches are compiled only by nvcc. For K2/K3
(``csrc/megastep.cu``) this tool builds it twice, on the CPU:

- ``HostMegastep``: the kernels' lane routines (``fwd_lane``, ``bwd_lane``)
  in float64, run lane by lane with a team of one thread that deals each
  phase's tasks as a warp of ``width`` threads would, so a CPU test holds
  the CUDA source to the plain version and the team's widths to each
  other (tests/test_torch_megastep.py);
- ``Counter``, ``needed`` and ``k2_k3_ops``: the arithmetic K2 and K3 need
  per lane, for their operation bound (``chip_smoke.py`` counts it at its
  own run's inputs).

How it counts. The device code runs on a scalar that counts every +,
-, *, / and every sqrt, sin, cos, abs, max and min (comparisons and branches
are free), at every dual level. The kernels get each derivative from sweeps
of one-direction duals, and every sweep recomputes the primal part (the
Lagrangian, FK, contact) that is the same in all directions. The function
itself needs that part once, so the count is that of a multi-tangent jet:
the primal once per evaluation, each direction's tangent work once, and for
nested sweeps each pair's mixed work. From the executed counts of
``lagrangian`` and ``residual`` on the scalar C, on Dual<C> and on
Dual<Dual<C>> (L0, L1, L2; R0, R1), with n coordinates:

  momentum          L0 + n (L1 - L0)                      (n sweeps of L)
  residual value    R0 - (2n - 1) L0          (el_pair's 2n sweeps of L)
  residual column   R1 - R0 - (2n - 1)(L1 - L0)     (one direction's work)
  momentum column   (L1 - L0) + n (L2 - 2 L1 + L0)  (primal shared with
                                                     the momentum)

``Counter.units(..., executed=True)`` also returns the executed counts of the
sweeping functions, whose structure these formulas assume (el_pair = 2n
Lagrangians, momentum = n, residual_columns = n residuals on Dual<C> plus
2n, the momentum pullback's column = n Lagrangians on Dual<Dual<C>>);
tests/test_torch_megastep.py pins them, so a change of that structure in
the CUDA source fails a test instead of leaving the bound stale.

For K1 and K1T (``csrc/lane_contact.cu``), ``HostLaneContact`` builds
their per-tile routines once (a few seconds): in float64 it runs a tile's
cluster of blocks with the kernels' phases in their order (staging, each
round's pieces warp by warp and lane by lane, each round's task
accumulation, the tasks' outputs) through the op's own wrapper
(``PairWrenches.forward_with`` / ``adjoint_with``), so the CPU tests hold
the CUDA source to the JAX package; on the counting scalar it counts the
operations K1 and K1T need on a run's inputs (``chip_smoke.py``'s bounds):
what the kernels do, less what their decomposition repeats (a segment's
rotations staged in every block that takes one of its pieces, counted once
per lane instead) or spends on zeros (the quaternion reverse of a joint
or body no segment rotates).

For the tactile read (``csrc/dense_contact.cu``), ``HostTactileRead``
builds the kernel's prologue and per-row routine (a second or two): in
float64 it runs them on one thread in the kernel's order from the plan the
wrapper packs, so a CPU test holds the CUDA source to the JAX package's
``dynamics.tactile_field``; on the counting scalar it counts the
operations one read needs, the prologue once (``chip_smoke.py``'s bound).

    python megastep_host.py      # the per-lane units on a contact state
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "tactilesimulation_tpu_torch", "csrc")

_STUB = """#pragma once
#include <math.h>
#include <stddef.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
struct dim3 { unsigned x, y, z; };
extern dim3 blockIdx, threadIdx, blockDim;
typedef int cudaError_t;
"""

# the counting scalar: every +, -, *, / and every sqrt, sin, cos, abs, max
# and min adds one to g_ops; comparisons are free
_SCALAR_C = r"""
#include <math.h>
long long g_ops = 0;
struct C {
  double x;
  C() : x(0) {}
  C(double v) : x(v) {}
};
inline C operator+(C a, C b) { ++g_ops; return C(a.x + b.x); }
inline C operator-(C a, C b) { ++g_ops; return C(a.x - b.x); }
inline C operator*(C a, C b) { ++g_ops; return C(a.x * b.x); }
inline C operator/(C a, C b) { ++g_ops; return C(a.x / b.x); }
inline C operator-(C a) { return C(-a.x); }
inline bool operator<(C a, C b) { return a.x < b.x; }
inline bool operator>(C a, C b) { return a.x > b.x; }
inline bool operator<=(C a, C b) { return a.x <= b.x; }
inline bool operator>=(C a, C b) { return a.x >= b.x; }
inline bool operator==(C a, C b) { return a.x == b.x; }
inline C pv(C x) { return x; }
inline C ssin(C a) { ++g_ops; return C(sin(a.x)); }
inline C scos(C a) { ++g_ops; return C(cos(a.x)); }
inline C ssqrt(C a) { ++g_ops; return C(sqrt(a.x)); }
inline C sabs(C a) { ++g_ops; return C(fabs(a.x)); }
inline C smax2(C a, C b) { ++g_ops; return a.x > b.x ? a : b; }
inline C smin2(C a, C b) { ++g_ops; return a.x < b.x ? a : b; }
inline C with_primal(C, C p) { return p; }
"""

_COUNT_SRC = _SCALAR_C + r"""
#include "cuda_runtime.h"
dim3 blockIdx, threadIdx, blockDim;
#include "megastep.cu"
namespace {
template <>
C ridge_eps<C>() { return C(1e-12); }

using D1 = Dual<C>;
using D2 = Dual<D1>;

// executed count of lagrangian on S at (q, v)
template <class S>
long long lag_ops(const Scene<C>& sc, const C* q, const C* v) {
  S qs[kMaxN], vs[kMaxN];
  for (int i = 0; i < sc.n; ++i) {
    qs[i] = cst<S>(q[i]);
    vs[i] = cst<S>(v[i]);
  }
  g_ops = 0;
  lagrangian(sc, qs, vs);
  return g_ops;
}
}  // namespace

// Per lane b of (q, qd, u) (n, B): out[b * 16 + k] for the units
//   0-2 L0, L1, L2 at the momentum's point (q, qd)
//   3-5 L0, L1, L2 at the residual's point (q + h qd, qd)
//   6 R0, 7 R1 (residual on C, on Dual<C> along (qn: h e_0, v: e_0))
//   8 ridged factor, 9 one solve
// and, if `executed`: 10 momentum, 11 el_pair at the residual's point,
//   12 residual_columns (J only), 13 one momentum-pullback column
extern "C" void count_units(const int* itab, const double* ftab, int nf,
                            const double* q0, const double* qd0,
                            const double* u0, int B, int executed,
                            long long* out) {
  C* ft = new C[nf];
  for (int i = 0; i < nf; ++i) ft[i] = C(ftab[i]);
  const Scene<C> sc = load_scene(itab, ft);
  const int n = sc.n;
  for (int b = 0; b < B; ++b) {
    long long* o = out + 16 * b;
    C q[kMaxN], qd[kMaxN], u[kMaxN], pb[kMaxN], qn[kMaxN], r[kMaxN];
    for (int i = 0; i < n; ++i) {
      q[i] = C(q0[i * B + b]);
      qd[i] = C(qd0[i * B + b]);
      qn[i] = C(q[i].x + sc.h.x * qd[i].x);
    }
    for (int i = 0; i < sc.nu; ++i) u[i] = C(u0[i * B + b]);
    o[0] = lag_ops<C>(sc, q, qd);
    o[1] = lag_ops<D1>(sc, q, qd);
    o[2] = lag_ops<D2>(sc, q, qd);
    o[3] = lag_ops<C>(sc, qn, qd);
    o[4] = lag_ops<D1>(sc, qn, qd);
    o[5] = lag_ops<D2>(sc, qn, qd);
    g_ops = 0; momentum(sc, q, qd, pb); const long long mom = g_ops;
    g_ops = 0; residual(sc, qn, qd, u, pb, r); o[6] = g_ops;
    {
      D1 qd1[kMaxN], vd1[kMaxN], rd[kMaxN];
      for (int i = 0; i < n; ++i) {
        qd1[i] = D1{qn[i], C(0)};
        vd1[i] = D1{qd[i], C(0)};
      }
      qd1[0].d = sc.h;
      vd1[0].d = C(1);
      g_ops = 0; residual(sc, qd1, vd1, u, pb, rd); o[7] = g_ops;
    }
    C J[kMaxN][kMaxN];
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) J[i][j] = C(i == j ? 1.0 : 0.0);
    g_ops = 0; ridge_factor(J, n); o[8] = g_ops;
    C rhs[kMaxN], x[kMaxN];
    for (int i = 0; i < n; ++i) rhs[i] = C(1);
    g_ops = 0; lu_solve(J, n, rhs, x); o[9] = g_ops;
    if (!executed) continue;
    o[10] = mom;
    C dLdq[kMaxN], p[kMaxN];
    g_ops = 0; el_pair(sc, qn, qd, dLdq, p); o[11] = g_ops;
    g_ops = 0;
    residual_columns(sc, q, qd, u, pb, J, static_cast<C(*)[kMaxN]>(nullptr));
    o[12] = g_ops;
    D1 qq[kMaxN], vv[kMaxN], pp[kMaxN];
    for (int i = 0; i < n; ++i) {
      qq[i] = D1{q[i], C(0)};
      vv[i] = D1{qd[i], C(0)};
    }
    qq[0].d = C(1);
    g_ops = 0; el_pair(sc, qq, vv, static_cast<D1*>(nullptr), pp);
    o[13] = g_ops;
  }
  delete[] ft;
}
"""

_RUN_SRC = r"""
#include <algorithm>
#include "cuda_runtime.h"
dim3 blockIdx, threadIdx, blockDim;
#include "megastep.cu"
// every lane of the batch through one lane's routine, with a team of one
// thread that runs a width of `width` (Team), the lane's state on the heap
template <int M>
void fwd_all(const Scene<double>& sc, int width, int K, int mi, double tol,
             const double* q0, const double* qd0, const double* u, int B,
             double* qo, double* qdo, double* vs, int* nres) {
  auto* lane = new FwdLane<double, M>();
  for (int b = 0; b < B; ++b)
    fwd_lane(Team{0, width}, sc, *lane, K, mi, tol, q0, qd0, u, B, b, qo,
             qdo, vs, nres);
  delete lane;
}
template <int M>
void bwd_all(const Scene<double>& sc, int width, int K, const double* q0,
             const double* qd0, const double* u, const double* vs,
             const double* gq, const double* gqd, const double* gqp,
             const double* gqdp, int B, double* gq0, double* gqd0,
             double* gu) {
  auto* lane = new BwdLane<double, M>();
  for (int b = 0; b < B; ++b)
    bwd_lane(Team{0, width}, sc, *lane, K, q0, qd0, u, vs, gq, gqd, gqp,
             gqdp, B, b, gq0, gqd0, gu);
  delete lane;
}
static int maxdim(const Scene<double>& sc) {
  return std::max(std::max(sc.n, sc.J), std::max(sc.NB, sc.nu));
}
extern "C" int host_fwd(const int* it, const double* ft, int K, int mi,
                        double tol, const double* q0, const double* qd0,
                        const double* u, int B, double* qo, double* qdo,
                        double* vs, int* nres, int width) {
  const Scene<double> sc = load_scene(it, ft);
  if (maxdim(sc) <= kSmallN)
    fwd_all<kSmallN>(sc, width, K, mi, tol, q0, qd0, u, B, qo, qdo, vs, nres);
  else if (maxdim(sc) <= kMaxN)
    fwd_all<kMaxN>(sc, width, K, mi, tol, q0, qd0, u, B, qo, qdo, vs, nres);
  else
    return 1;
  return 0;
}
extern "C" int host_bwd(const int* it, const double* ft, int K,
                        const double* q0, const double* qd0, const double* u,
                        const double* vs, const double* gq,
                        const double* gqd, const double* gqp,
                        const double* gqdp, int B, double* gq0,
                        double* gqd0, double* gu, int width) {
  const Scene<double> sc = load_scene(it, ft);
  if (maxdim(sc) <= kSmallN)
    bwd_all<kSmallN>(sc, width, K, q0, qd0, u, vs, gq, gqd, gqp, gqdp, B,
                     gq0, gqd0, gu);
  else if (maxdim(sc) <= kMaxN)
    bwd_all<kMaxN>(sc, width, K, q0, qd0, u, vs, gq, gqd, gqp, gqdp, B, gq0,
                   gqd0, gu);
  else
    return 1;
  return 0;
}
"""

_LC_SRC = r"""
#include <math.h>
#include <algorithm>
#include <vector>
long long g_ops = 0;
struct C {
  double x;
  C() : x(0) {}
  C(double v) : x(v) {}
};
inline C operator+(C a, C b) { ++g_ops; return C(a.x + b.x); }
inline C operator-(C a, C b) { ++g_ops; return C(a.x - b.x); }
inline C operator*(C a, C b) { ++g_ops; return C(a.x * b.x); }
inline C operator/(C a, C b) { ++g_ops; return C(a.x / b.x); }
inline C operator-(C a) { return C(-a.x); }
inline C& operator+=(C& a, C b) { a = a + b; return a; }
inline C& operator-=(C& a, C b) { a = a - b; return a; }
inline bool operator<(C a, C b) { return a.x < b.x; }
inline bool operator>(C a, C b) { return a.x > b.x; }
inline bool operator<=(C a, C b) { return a.x <= b.x; }
inline bool operator>=(C a, C b) { return a.x >= b.x; }
inline bool operator==(C a, C b) { return a.x == b.x; }
inline C pv(C x) { return x; }
inline C ssqrt(C a) { ++g_ops; return C(sqrt(a.x)); }
inline C sabs(C a) { ++g_ops; return C(fabs(a.x)); }
inline C smax2(C a, C b) { ++g_ops; return a.x > b.x ? a : b; }
inline C smin2(C a, C b) { ++g_ops; return a.x < b.x ? a : b; }
inline C with_primal(C, C p) { return p; }
#include "cuda_runtime.h"
dim3 blockIdx, threadIdx, blockDim;
#include "lane_contact.cu"

// the joints (0..J-1) and bodies (J..J+NB-1) whose rotation a segment
// uses: its owner joint's and its primitive body's
static std::vector<char> rotated(const int* plan, int J, int NB) {
  std::vector<char> used(J + NB, 0);
  const int* seg = plan + plan[kHOffSeg];
  for (int s = 0; s < plan[kHS]; ++s) {
    const int* sg = seg + kSegCols * s;
    used[sg[2]] = 1;
    if (sg[5] != kGround) used[J + sg[3]] = 1;
  }
  return used;
}

// A tile's cluster, block by block, in the kernels' phases; the threads of
// a phase one after another. `counting`: only the live lanes run a piece
// or a task (the card runs 32), and the counting scalar leaves out what
// the function does not need: the staging, which computes a segment's
// rotations once in every block that takes one of its pieces (the caller
// counts them once per lane), and the quaternion reverse of a joint or
// body whose rotation no segment uses (a zero cotangent).
template <class T>
void run(bool adj, const int* plan, const Args<T>& a, const Outs<T>& o,
         bool counting) {
  const int NS = plan[kHNS], R = plan[kHRounds];
  const int ntasks = n_tasks(plan, adj, a.J, a.NB, a.K);
  const Layout L = layout<T>(plan, adj, ntasks);
  const std::vector<char> used = rotated(plan, a.J, a.NB);
  auto unneeded = [&](int task) {
    return counting && task < a.J + a.NB && !used[task];
  };
  std::vector<std::vector<unsigned char>> mem(NS);
  for (int t = 0; t * kTile < a.B; ++t) {
    std::vector<Block<T>> blk;
    for (int y = 0; y < NS; ++y) {
      mem[y].assign(L.total, 0);
      blk.push_back(carve<T>(plan, mem[y].data(), t, y, adj, ntasks));
    }
    for (auto& k : blk)
      for (int y = 0; y < NS; ++y) k.remote[y] = blk[y].slots;
    const int lanes = counting ? std::min(kTile, a.B - t * kTile) : kTile;
    for (auto& k : blk) stage_tables(k, ntasks, 0, 1);
    for (int r = 0; r < R; ++r) {
      const long long before = g_ops;
      for (auto& k : blk) stage_round(k, a, o, r, 0, 1);
      if (counting) g_ops = before;
      for (auto& k : blk)
        for (int w = 0; w < kWarps; ++w) {
          for (int l = 0; l < lanes; ++l) {
            if (adj) bwd_piece(k, a, o, r, w, l);
            else fwd_piece(k, a, o, r, w, l);
          }
          if (adj)
            for (int l = 0; l < kTile; ++l) bwd_piece_reduce(k, a, o, r, w, l);
        }
      for (int y = 0; y < NS; ++y)
        for (int w = 0; w < kWarps; ++w)
          for (int task = y * kWarps + w; task < ntasks; task += NS * kWarps)
            for (int l = 0; l < lanes; ++l) {
              if (adj) bwd_accumulate(blk[y], a, o, r, l, task);
              else fwd_accumulate(blk[y], a, r, l, task);
            }
    }
    for (int y = 0; y < NS; ++y)
      for (int w = 0; w < kWarps; ++w)
        for (int task = y * kWarps + w; task < ntasks; task += NS * kWarps) {
          const long long before = g_ops;
          for (int l = 0; l < lanes; ++l) {
            if (adj) bwd_finish(blk[y], a, o, w, l, task);
            else fwd_finish(blk[y], a, o, l, task);
          }
          if (adj && unneeded(task)) g_ops = before;
          if (adj)
            for (int l = 0; l < kTile; ++l)
              bwd_finish_reduce(blk[y], a, o, w, l, task);
        }
  }
}

// in: jp, jq, om, be, bp, bq, sizes, params, gpos, gn, xi, gF, gT, gtac;
// dims: row_stride, lane_stride, J, NB, K, ntac, nsum, B;
// out: K1 F, T, tac, scratch; K1T jp, jq, om, be, bp, bq, params, shared
template <class T>
void unpack(const T* const* in, const int* d, T* const* out, int want,
            bool adj, Args<T>& a, Outs<T>& o) {
  a = Args<T>{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], d[0],
              d[1], in[8], in[9], in[10], d[2], d[3], d[4], d[5], d[6], d[7]};
  o = Outs<T>{};
  if (!adj) {
    o.F = out[0]; o.T_ = out[1]; o.tac = out[2]; o.scratch = out[3];
    return;
  }
  o.gF = in[11]; o.gT = in[12]; o.gtac = in[13];
  o.jp = out[0]; o.jq = out[1]; o.om = out[2]; o.be = out[3];
  o.bp = out[4]; o.bq = out[5]; o.params = out[6]; o.shared = out[7];
  o.want = want;
}

extern "C" void host_lane_contact(int adj, const int* plan,
                                  const double* const* in, const int* dims,
                                  double* const* out, int want) {
  Args<double> a;
  Outs<double> o;
  unpack(in, dims, out, want, adj, a, o);
  run(adj, plan, a, o, false);
}

// the same on the counting scalar, the live lanes only: the operations
// the function needs (run's `counting`), with one rotation per lane for
// each joint and body a segment uses; sizes: each in[] and out[] array's
// length (0 = null)
extern "C" long long count_lane_contact(int adj, const int* plan,
                                        const double* const* in,
                                        const int* in_sizes, const int* dims,
                                        const int* out_sizes, int want) {
  std::vector<std::vector<C>> ins(14), outs(8);
  const C* ip[14];
  C* op[8];
  for (int i = 0; i < 14; ++i) {
    ins[i].resize(in_sizes[i]);
    for (int e = 0; e < in_sizes[i]; ++e) ins[i][e] = C(in[i][e]);
    ip[i] = in_sizes[i] ? ins[i].data() : nullptr;
  }
  for (int i = 0; i < 8; ++i) {
    outs[i].resize(out_sizes[i]);
    op[i] = out_sizes[i] ? outs[i].data() : nullptr;
  }
  Args<C> a;
  Outs<C> o;
  unpack(ip, dims, op, want, adj, a, o);
  g_ops = 0;
  C q[4] = {C(1), C(0), C(0), C(0)}, M[3][3];
  quat_to_mat(q, M);
  const long long per_rotation = g_ops;
  g_ops = 0;
  run(adj, plan, a, o, true);
  long long rotations = 0;
  for (char u : rotated(plan, a.J, a.NB)) rotations += u;
  return g_ops + per_rotation * rotations * a.B;
}
"""


_TR_SRC = _SCALAR_C + r"""
#include <algorithm>
#include <vector>
#include "cuda_runtime.h"
dim3 blockIdx, threadIdx, blockDim;
#include "dense_contact.cu"

// the read kernel's phases in their order, on one thread: the prologue once
// (FK and its JVP: every joint's local frame, then the joints depth by
// depth; each joint's twist, each pair's scalars), then every row
template <class T>
void run_read(const int* it, const T* ft, const T* q, const T* v, int n,
              int J, int P, int N, T* out) {
  const ReadScene<T> sc = load_read_scene(it, ft, n, J, P, N);
  std::vector<double> box(read_shared_bytes<T>(n, J, P) / 8 + 1);
  const ReadShared<T> sh = carve_read_shared<T>(box.data(), n, J, P);
  for (int i = 0; i < n; ++i) sh.qd[i] = Dual<T>{q[i], v[i]};
  for (int j = 0; j < J; ++j) read_fk_local(sc, sh, j);
  int deepest = 0;
  for (int j = 0; j < J; ++j) deepest = std::max(deepest, sc.depth[j]);
  for (int d = 1; d <= deepest; ++d)
    for (int j = 0; j < J; ++j)
      if (sc.depth[j] == d) read_fk_attach(sc, sh, j);
  for (int j = 0; j < J; ++j) read_twist(sh, j);
  for (int k = 0; k < P; ++k) read_pair(sc, sh, k);
  for (int i = 0; i < N; ++i) read_row(sc, sh, i, out + 3 * i);
}

extern "C" void host_tactile_read(const int* it, const double* ft,
                                  const double* q, const double* v, int n,
                                  int J, int P, int N, double* out) {
  run_read<double>(it, ft, q, v, n, J, P, N, out);
}

// the same on the counting scalar: the operations of one read (the
// prologue counted once: every block repeats it)
extern "C" long long count_tactile_read(const int* it, const double* ft,
                                        int nf, const double* q,
                                        const double* v, int n, int J, int P,
                                        int N) {
  std::vector<C> f(ft, ft + nf), qc(q, q + n), vc(v, v + n), out(3 * N);
  g_ops = 0;
  run_read<C>(it, f.data(), qc.data(), vc.data(), n, J, P, N, out.data());
  return g_ops;
}
"""

class HostLaneContact:
    """K1 and K1T's per-tile routines (``csrc/lane_contact.cu``) on the
    CPU, for the scene of ``op`` (a ``PairWrenches``): ``forward(*args)``
    and ``adjoint(args, cots, need)`` take and give what ``run_kernel`` and
    ``run_adjoint`` do, on float64 CPU tensors; ``count(args, cots)`` gives
    the operations (K1, K1T) the function needs on the live lanes."""

    _built = None          # (directory, library): one build per process

    def __init__(self, op):
        self.op = op
        if HostLaneContact._built is None:
            workdir = tempfile.TemporaryDirectory()
            lib = build(workdir.name, _LC_SRC)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.host_lane_contact.argtypes = [i, p, p, p, p, i]
            lib.host_lane_contact.restype = None
            lib.count_lane_contact.argtypes = [i, p, p, p, p, p, i]
            lib.count_lane_contact.restype = ctypes.c_longlong
            HostLaneContact._built = (workdir, lib)
        self.lib = HostLaneContact._built[1]

    def _tables(self, args, cots, outs):
        params = args[7]
        B = args[0].shape[-1]
        row_stride, lane_stride = (B, 1) if params.ndim == 3 else (1, 0)
        op = self.op
        dims = np.asarray([row_stride, lane_stride, op.J, op.NB,
                           params.shape[0], op.ntac, op.nsum, B], np.int32)
        ins = list(args) + list(cots)
        ptrs = lambda ts: np.asarray([0 if t is None else t.data_ptr()
                                      for t in ts], np.uint64)
        return dims, ptrs(ins), ptrs(outs), ins

    def _launch(self, adjoint, args, cots, outs, want):
        dims, ins, outp, _ = self._tables(args, cots, outs)
        plan = np.ascontiguousarray(self.op.plan)
        self.lib.host_lane_contact(int(adjoint), plan.ctypes.data,
                                   ins.ctypes.data, dims.ctypes.data,
                                   outp.ctypes.data, want)

    def forward(self, *args):
        return self.op.forward_with(args, self._launch, torch.float64)

    def adjoint(self, args, cots, need=(True,) * 11):
        return self.op.adjoint_with(args, cots, need, self._launch,
                                    torch.float64)

    def count(self, args, cots, need=(True,) * 11):
        """(K1, K1T) operations at these inputs (float64 CPU tensors), K1T
        asked for the cotangents ``need`` names: what the function needs,
        not what the kernels' decomposition repeats (``run``'s
        ``counting`` in the host source)."""
        counts = []

        def launch(adj, a, cots, outs, want):
            outs = tuple(outs) + (None,) * (8 - len(outs))   # K1 has 4
            dims, ins, outp, tensors = self._tables(a, cots, outs)
            sizes = lambda ts: np.asarray([0 if t is None else t.numel()
                                           for t in ts], np.int32)
            plan = np.ascontiguousarray(self.op.plan)
            counts.append(self.lib.count_lane_contact(
                int(adj), plan.ctypes.data, ins.ctypes.data,
                sizes(tensors).ctypes.data, dims.ctypes.data,
                sizes(outs).ctypes.data, want))

        self.op.forward_with(args, launch, torch.float64)
        self.op.adjoint_with(args, cots, need, launch, torch.float64)
        return tuple(counts)


class HostTactileRead:
    """The tactile read kernel's prologue and per-row routine
    (``csrc/dense_contact.cu``) on the CPU, on one thread in the kernel's
    order: ``field(struct, model, q, v)`` gives the (Mtot, 3) sensor-frame
    field in float64 from the plan the wrapper packs
    (``dense_contact.ReadPlan``); ``count(...)`` the operations one read
    needs (the prologue once), for the read's bound."""

    _built = None          # (directory, library): one build per process

    def __init__(self):
        if HostTactileRead._built is None:
            workdir = tempfile.TemporaryDirectory()
            lib = build(workdir.name, _TR_SRC)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.host_tactile_read.argtypes = [p, p, p, p, i, i, i, i, p]
            lib.host_tactile_read.restype = None
            lib.count_tactile_read.argtypes = [p, p, i, p, p, i, i, i, i]
            lib.count_tactile_read.restype = ctypes.c_longlong
            HostTactileRead._built = (workdir, lib)
        self.lib = HostTactileRead._built[1]

    @staticmethod
    def _inputs(struct, model, q, v):
        from tactilesimulation_tpu_torch.ops import dense_contact
        plan = dense_contact.ReadPlan(struct, model.to("cpu", torch.float64))
        vec = lambda a: torch.as_tensor(np.asarray(a, np.float64)).contiguous()
        return plan, vec(q), vec(v)

    def field(self, struct, model, q, v) -> torch.Tensor:
        plan, q, v = self._inputs(struct, model, q, v)
        out = torch.empty((plan.N, 3), dtype=torch.float64)
        self.lib.host_tactile_read(
            plan.ints.data_ptr(), plan.floats.data_ptr(), q.data_ptr(),
            v.data_ptr(), plan.n, plan.J, plan.P, plan.N, out.data_ptr())
        return out

    def count(self, struct, model, q, v) -> int:
        plan, q, v = self._inputs(struct, model, q, v)
        return int(self.lib.count_tactile_read(
            plan.ints.data_ptr(), plan.floats.data_ptr(),
            plan.floats.numel(), q.data_ptr(), v.data_ptr(), plan.n, plan.J,
            plan.P, plan.N))


UNITS = ("Lq0", "Lq1", "Lq2", "Lr0", "Lr1", "Lr2", "R0", "R1", "factor",
         "solve", "momentum_exec", "el_pair_exec", "columns_exec",
         "momentum_column_exec")


def available() -> bool:
    return shutil.which("g++") is not None


def build(workdir: str, source: str) -> ctypes.CDLL:
    """Compile ``source`` (which includes a kernel source of csrc/) into
    ``workdir``."""
    with open(os.path.join(workdir, "cuda_runtime.h"), "w") as fp:
        fp.write(_STUB)
    src = os.path.join(workdir, "host.cpp")
    with open(src, "w") as fp:
        fp.write(source)
    lib = os.path.join(workdir, "libhost.so")
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w",
                    "-I", workdir, "-I", _CSRC, "-o", lib, src], check=True)
    return ctypes.CDLL(lib)


class HostMegastep:
    """K2/K3's lane routines in float64 on the CPU, one lane after another,
    with ``MegaStep.run_fwd`` / ``run_bwd``'s signature (CPU float64
    tensors). ``width`` is the team's: 32 deals each phase's tasks as a
    warp does (task i to thread i mod 32, thread by thread), 1 runs them in
    order; the two give equal results, bit for bit."""

    def __init__(self, op, width: int = 32):
        self.op = op
        self.width = width
        self._dir = tempfile.TemporaryDirectory()
        self.lib = build(self._dir.name, _RUN_SRC)
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        self.lib.host_fwd.argtypes = [p, p, i, i, d, p, p, p, i, p, p, p, p,
                                      i]
        self.lib.host_fwd.restype = i
        self.lib.host_bwd.argtypes = [p, p, i] + [p] * 8 + [i, p, p, p, i]
        self.lib.host_bwd.restype = i

    def run_fwd(self, q, qd, u):
        op = self.op
        n, K, B = op.tables.n, op.frame_skip, q.shape[-1]
        ints, floats = op.tables.packed("cpu", torch.float64)
        qo, qdo = torch.empty_like(q), torch.empty_like(q)
        vs = torch.empty((K, n, B), dtype=torch.float64)
        nres = torch.empty(B, dtype=torch.int32)
        p = ctypes.c_void_p
        err = self.lib.host_fwd(*(p(t.data_ptr()) for t in (ints, floats)),
                                K, op.max_iter, op.tol,
                                *(p(t.data_ptr()) for t in (q, qd, u)), B,
                                *(p(t.data_ptr()) for t in
                                  (qo, qdo, vs, nres)), self.width)
        if err:
            raise ValueError("megastep_host: scene larger than the kernels' "
                             "largest instance")
        self.last_residuals = nres
        return qo, qdo, vs

    def run_bwd(self, q, qd, u, vs, gq, gqd, gqp, gqdp):
        op = self.op
        ints, floats = op.tables.packed("cpu", torch.float64)
        out = (torch.empty_like(q), torch.empty_like(q), torch.empty_like(u))
        p = ctypes.c_void_p
        err = self.lib.host_bwd(*(p(t.data_ptr()) for t in (ints, floats)),
                                op.frame_skip,
                                *(p(t.data_ptr()) for t in
                                  (q, qd, u, vs, gq, gqd, gqp, gqdp)),
                                q.shape[-1],
                                *(p(t.data_ptr()) for t in out), self.width)
        if err:
            raise ValueError("megastep_host: scene larger than the kernels' "
                             "largest instance")
        return out


class Counter:
    """The counting build, compiled once (``g++``, about 10 s)."""

    def __init__(self):
        self._dir = tempfile.TemporaryDirectory()
        self.lib = build(self._dir.name, _COUNT_SRC)
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.count_units.argtypes = [p, p, i, p, p, p, i, i, p]
        self.lib.count_units.restype = None

    def units(self, tables, q, qd, u, executed: bool = False) -> np.ndarray:
        """(B, len(UNITS)) executed counts per lane of the (n, B) state;
        the ``*_exec`` columns are 0 unless ``executed``."""
        ints = np.ascontiguousarray(tables._ints, np.int32)
        floats = np.ascontiguousarray(tables._floats, np.float64)
        q, qd, u = (np.ascontiguousarray(np.asarray(a, np.float64))
                    for a in (q, qd, u))
        B = q.shape[1]
        out = np.zeros((B, 16), np.int64)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        self.lib.count_units(ptr(ints), ptr(floats), len(floats), ptr(q),
                             ptr(qd), ptr(u), B, int(executed), ptr(out))
        return out[:, :len(UNITS)]


def needed(units: np.ndarray, n: int) -> dict:
    """Per-lane operations each unit of K2/K3 needs (the jet counts of the
    module docstring), from ``Counter.units`` rows; arrays of length B."""
    c = {k: units[:, i].astype(np.float64) for i, k in enumerate(UNITS)}
    mixed = c["Lq2"] - 2 * c["Lq1"] + c["Lq0"]
    return {
        "momentum": c["Lq0"] + n * (c["Lq1"] - c["Lq0"]),
        "residual": c["R0"] - (2 * n - 1) * c["Lr0"],
        "column": c["R1"] - c["R0"] - (2 * n - 1) * (c["Lr1"] - c["Lr0"]),
        "momentum_column": (c["Lq1"] - c["Lq0"]) + n * mixed,
        "factor": c["factor"], "solve": c["solve"]}


def k2_k3_ops(need: dict, n: int, K: int, evals: np.ndarray):
    """(K2, K3) operations summed over lanes. K2: the Jacobian's n columns
    at the entry state (their primal is substep 0's first residual), one
    factor, K momenta, every residual evaluation the run made (``evals``
    per lane, from the kernel) and a solve for each but the first of each
    substep. K3, per substep: the momentum, the residual at v* with 2n
    columns (J and dr/dq_base), a factor and a solve, and 2n momentum
    columns. Terms of O(n) operations per sweep (norms, updates) are left
    out, so both stay lower bounds."""
    evals = np.asarray(evals, np.float64)
    k2 = (K * need["momentum"] + n * need["column"] + need["factor"]
          + evals * need["residual"] + (evals - K) * need["solve"])
    k3 = K * (need["momentum"] + need["residual"] + 2 * n * need["column"]
              + need["factor"] + need["solve"]
              + 2 * n * need["momentum_column"])
    return float(k2.sum()), float(k3.sum())


def main() -> int:
    from chip_smoke import contact_state
    from tactilesimulation_tpu_torch.model import task_scenes
    from tactilesimulation_tpu_torch.ops.megastep import SceneTables
    struct, model = task_scenes.tactile_push()
    q, qd = contact_state("tactile_push", model.q_init.numpy(), 4, seed=0)
    u = 0.5 * np.random.RandomState(1).randn(struct.ndof_u, 4)
    units = Counter().units(SceneTables(struct, model), q, qd, u, True)
    for i, k in enumerate(UNITS):
        print(f"{k:22s}", units[:, i].tolist())
    for k, v in needed(units, struct.ndof_q).items():
        print(f"needed {k:15s}", v.tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
