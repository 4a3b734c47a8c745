"""K2/K3's device code (``csrc/megastep.cu``) built as host C++ with ``g++``.

The kernels' device code compiles as plain C++ when the CUDA qualifiers are
stubbed out; the launches are compiled only by nvcc. This tool builds it
twice, on the CPU:

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

_COUNT_SRC = r"""
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

UNITS = ("Lq0", "Lq1", "Lq2", "Lr0", "Lr1", "Lr2", "R0", "R1", "factor",
         "solve", "momentum_exec", "el_pair_exec", "columns_exec",
         "momentum_column_exec")


def available() -> bool:
    return shutil.which("g++") is not None


def build(workdir: str, source: str) -> ctypes.CDLL:
    """Compile ``source`` (which includes megastep.cu) into ``workdir``."""
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
