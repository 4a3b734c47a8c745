// K2 and K3: one whole BDF1 env step and its exact IFT adjoint, per lane,
// for Hopper (sm_90a), in float and double.
//
// Replaces the Pallas TPU kernels of tactilesimulation_tpu/ops/megastep.py:
//   K2 `_fwd_kernel` (pallas_call at megastep.py:799): the chord Jacobian J
//      at the entry state, a ridged no-pivot LU, then frame_skip substeps of
//      chord iteration (r0 + up to max_iter sweeps, best iterate kept);
//   K3 `_bwd_kernel` (pallas_call at megastep.py:831): in reverse over the
//      substeps, J rebuilt at each solution v*, lambda = J^{-T} g, -lambda
//      pulled back into (u, q_base, p_base), p_base through momentum(q, qd);
//      the q_prev / qdot_prev cotangents folded in at the last substep.
// Semantics are the port's plain version (ops/megastep.py: fwd_ref,
// bwd_ref), i.e. sim/lanes.py's residual, chord and exact adjoint.
//
// Derivatives. The JAX kernels trace AD inside the kernel; here the
// residual is written once, templated on its scalar, and every derivative
// comes from forward-mode dual numbers (dual.cuh), nested:
//   body velocities   FK on Dual<S> with tangent v (the JVP of FK);
//   dL/dq, dL/dv      2n sweeps of the Lagrangian, one dual level above;
//   J, dr/dq_base     n + n columns of the residual on Dual<T>: direction
//                     (qn: h e_k, v: e_k) gives J[:, k], (qn: e_k) gives
//                     dr/dqn[:, k] = dr/dq_base[:, k];
//   dr/du             the motor rows through the clip; dr/dp_base = -I;
//   momentum pullback 2n columns of p(q, qd) on Dual<T>.
// The contact law is contact_point.cuh (shared with K1); the primitive
// side's torque is taken at the contact point x itself, which moves with
// both bodies under differentiation, as in the JAX megastep
// (_SceneConst.contact_wrenches) and the plain version
// (sim/lanes.contact_terms(moving_point=True)): J and the adjoint are then
// the derivatives of the residual's value.
//
// Layout. One warp per lane, 2 lanes (warps) per block (kLanes; the choice
// is argued at the end of this note). Per-lane arrays in device memory
// are batch-last, (rows, B) row-major. The scene's small tables (FK tables,
// joint/body constants, mass and inertia, springs, motors, ground, segment
// table, contact parameters, ancestor mask; ops/megastep.py
// SceneTables.packed) are staged in shared memory once per block; the
// contact points stay in device memory. A lane's state (q, qd, u, v, p_base,
// J or its LU, dr/dq_base, lambda, the residual) and every partial result
// live in shared memory, in one struct per lane (FwdLane, BwdLane).
//
// Work decomposition. A lane's work is a list of independent tasks that its
// warp deals round-robin to its 32 threads (Team::for_each), with a
// __syncwarp() between phases. Each task writes its own slot; one task per
// result combines the slots in a fixed order, so the answer does not depend
// on which thread ran which task (megastep_host.py runs the same routines on
// the CPU at widths 1, 7 and 32, equal bit for bit). A residual evaluation
// (residual_batch) is three phases: (1) the kinematics (FK, dof frames,
// joint twists) and el_pair's 2n Lagrangian sweeps, one task each; (2) the
// contact points in chunks of at most 16 (columns) or 8 (values) points of
// one segment; (3) the chunk sums in segment order, Q and r.
//   K3, per substep in reverse: J's n columns on Dual<T> (n kinematics and
//   n x 2n sweep tasks), with the momentum (n sweeps) and its 2n columns
//   (2n x n sweeps on Dual<Dual<T>>) riding along phase 1: 210 tasks on
//   TactilePush; then dr/dq_base's n columns (105 tasks); then one thread
//   factors J^T, solves for lambda and pulls it back (~10^3 operations).
//   K2: the entry J's n columns with the momentum riding along; one thread
//   factors; then per substep the chord, each residual value 2n sweeps and
//   one kinematics task, then 27 contact chunks, then one assembly. The stop
//   test is computed alike on every thread from the shared residual, so a
//   converged lane's warp leaves the chord at once.
// Every array is sized by the instance's bound M (8 or 16), so the nested
// duals' stack frame is that of M. The wrapper picks M from the scene's
// counts and names it at launch (megastep_fwd_m_f32, ...).
//
// Work and bound on TactilePush (n = 7, J = NB = 7, 204 contact points,
// frame_skip K = 5, max_iter 8), per lane. The operations the function
// needs, counted by running this code on the host with an
// operation-counting scalar (megastep_host.py; every +, -, *, /, sqrt, sin,
// cos, abs, max, min), as a multi-tangent jet would do them: the primal
// once per evaluation, each direction's tangent work once. The sweeps
// below recompute the primal in every direction; that repeated work is not
// counted. On contact_state's states:
//   momentum 42,067; residual value 117,787; residual column 194,300;
//   momentum column 70,320; ridged factor 234; solve 91;
//   K2 = 7 columns + K momenta + (K + sweeps run) values and solves:
//        6.9e6 at 8 sweeps per substep (fewer where the chord converges);
//   K3 = K x (momentum + value + 14 columns + 14 momentum columns + factor
//        + solve): 1.9e7.
// In and out (f32): K2 reads q, qd, u (20 values) and writes q, qd, vs and
// its residual count (50), 280 B per lane; K3 reads q, qd, u, vs and four
// cotangents (83) and writes 20, 412 B. At B = 1024 that is ~0.3-0.4 MB
// (~0.1 us at 3.35 TB/s) against 7.0e9 operations for K2 (0.104 ms at
// 67 TFLOP/s fp32) and 2.0e10 for K3 (0.295 ms): both are bound by
// operations (chip_smoke.py computes each bound from its run's inputs).
//
// What bounds them now (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W,
// f32, B = 1024: K2 6.7 ms, K3 9.4 ms, 1.6 % and 3.1 % of the bound; at
// B = 16, 2.5 / 3.4 ms). The f32 instance holds 8 lanes per SM (4 blocks of
// 2 lanes, 47.6 KB of shared memory each; 168 registers a thread), so
// B = 1024 runs in one wave on 128 of the 132 SMs. Each thread's sweep is a
// serial chain of nested dual operations on stack arrays (3.2 KB a
// thread, 820 KB for an SM's 256 threads, more than the L1 that the shared
// memory leaves; how much that costs is not measured: no profiler of the
// SM runs there); the sweeps repeat the
// primal in every direction (the bound counts it once); phase 1 of a K3
// batch deals 210 tasks in 7 rounds where 6.6 would do; K2's chord is 5 x 9
// residual values in series, each at least one Lagrangian sweep long.
// Block shape: 1, 2 and 4 lanes per block ran within 3.3 % of each other
// at B = 1024 (K2 6.84 / 6.64 / 6.62 ms, K3 9.24 / 9.52 / 9.47 ms) and
// within 5.4 % at the GD width, B = 16 (K2 2.64 / 2.53 / 2.67 ms, K3
// 3.50 / 3.36 / 3.54 ms): the scene's staging is small and the SM holds
// the same 8 lanes either way. 2 lanes per block is the fastest at B = 16
// and within 0.2 % (K2) and 3.1 % (K3) of the fastest at B = 1024
// (chip_smoke.py's timings, with the lanes per block then a launch
// parameter; f32). Every instance holds 2 lanes in the card's 227 KB of
// shared memory per block (the f64 M = 16 adjoint takes 171 KB).

#include <cuda_runtime.h>

#include "contact_point.cuh"
#include "kinematics.cuh"

namespace {

using namespace tsim;

// Two instances per kernel and dtype: every per-lane array is sized by a
// compile-time bound M on the coordinates, joints, bodies and controls.
// The launch takes the small one when the scene fits it.
constexpr int kMaxN = 16;     // the large instance's M (and the host tools')
constexpr int kSmallN = 8;    // the small one's (TactilePush: 7, 7, 7, 6)
constexpr int kMaxSeg = 16;   // contact segments
constexpr int kMaxParam = 16; // contact parameter rows
constexpr int kWarp = 32;     // threads of one lane's team
constexpr int kColBatch = 8;  // residual columns evaluated together
constexpr int kColChunks = 16;  // contact chunks per column (>= kMaxSeg)
constexpr int kValChunks = 32;  // contact chunks of a residual value
constexpr int kColChunkLen = 16;  // points per chunk, before doubling
constexpr int kValChunkLen = 8;
constexpr int kSegCols = 8;  // row0, n, joint, prim_body, prim_joint, gtype,
                             // param_row, tac0

// -- the scene, unpacked from the two tables ---------------------------------
template <class T>
struct Scene {
  int n, J, NB, nu, S;
  const int *jparent, *trans_idx, *rot_idx, *mflags, *body_joint, *motor_dof,
      *seg, *anc, *rotm;
  T h, grav[3], gpos[3], gn[3];
  const T *jpos, *jquat, *jaxis, *basis, *bpos, *bquat, *bmass, *binertia,
      *bsize, *damp, *lo, *hi, *stiff, *kp, *kd, *ulo, *uhi, *umask, *params,
      *xi;
};

// Table layout (ops/megastep.py SceneTables.packed):
//   ints:   n J NB nu S K npts | parent[J] | trans_idx[J*3] | rot_idx[J*3]
//           | (m_rev, m_exp, m_eul)[J*3] | body_joint[NB] | motor_dof[nu]
//           | seg[S*8] | anc[n*J] | rot_mask[n]
//   floats: h | gravity[3] | ground_pos[3] | ground_normal[3]
//           | joint_pos[J*3] | joint_quat[J*4] | joint_axis0[J*3]
//           | basis[J*9] | body_pos[NB*3] | body_quat[NB*4] | body_mass[NB]
//           | body_inertia[NB*3] | body_size[NB*3] | damping[n] | lim_lo[n]
//           | lim_hi[n] | lim_stiffness[n] | kp[nu] | kd[nu] | ctrl_lo[nu]
//           | ctrl_hi[nu] | pos_mask[nu] | params[K*4] | points[npts*3]
template <class T>
__device__ Scene<T> load_scene(const int* it, const T* ft) {
  Scene<T> s;
  s.n = it[0]; s.J = it[1]; s.NB = it[2]; s.nu = it[3]; s.S = it[4];
  const int K = it[5];
  const int* p = it + 7;
  s.jparent = p; p += s.J;
  s.trans_idx = p; p += 3 * s.J;
  s.rot_idx = p; p += 3 * s.J;
  s.mflags = p; p += 3 * s.J;
  s.body_joint = p; p += s.NB;
  s.motor_dof = p; p += s.nu;
  s.seg = p; p += kSegCols * s.S;
  s.anc = p; p += s.n * s.J;
  s.rotm = p;
  s.h = ft[0];
  for (int i = 0; i < 3; ++i) {
    s.grav[i] = ft[1 + i];
    s.gpos[i] = ft[4 + i];
    s.gn[i] = ft[7 + i];
  }
  const T* f = ft + 10;
  s.jpos = f; f += 3 * s.J;
  s.jquat = f; f += 4 * s.J;
  s.jaxis = f; f += 3 * s.J;
  s.basis = f; f += 9 * s.J;
  s.bpos = f; f += 3 * s.NB;
  s.bquat = f; f += 4 * s.NB;
  s.bmass = f; f += s.NB;
  s.binertia = f; f += 3 * s.NB;
  s.bsize = f; f += 3 * s.NB;
  s.damp = f; f += s.n;
  s.lo = f; f += s.n;
  s.hi = f; f += s.n;
  s.stiff = f; f += s.n;
  s.kp = f; f += s.nu;
  s.kd = f; f += s.nu;
  s.ulo = f; f += s.nu;
  s.uhi = f; f += s.nu;
  s.umask = f; f += s.nu;
  s.params = f; f += 4 * K;
  s.xi = f;
  return s;
}

// -- dynamics (sim/lanes.lagrangian, el_terms, momentum) ---------------------
// L(q, v) per lane; body velocities are the JVP of FK along v (Dual<D>).
template <class D, class T, int M = kMaxN>
__device__ __noinline__ D lagrangian(const Scene<T>& sc, const D* q,
                                     const D* v) {
  using E = Dual<D>;
  E qe[M];
  for (int i = 0; i < sc.n; ++i) qe[i] = E{q[i], v[i]};
  E jp[M][3], jq[M][4];
  fk_joints(sc, qe, jp, jq);
  D kin = cst<D>(T(0)), pot = cst<D>(T(0));
#pragma unroll 1
  for (int b = 0; b < sc.NB; ++b) {
    const int j = sc.body_joint[b];
    E r[3], bpe[3], bqe[4];
    qrot(jq[j], sc.bpos + 3 * b, r);
    for (int i = 0; i < 3; ++i) bpe[i] = jp[j][i] + r[i];
    qmul(jq[j], sc.bquat + 4 * b, bqe);
    D quat[4], quatd[4], qc[4];
    for (int i = 0; i < 4; ++i) {
      quat[i] = bqe[i].v;
      quatd[i] = bqe[i].d;
    }
    qc[0] = quat[0];
    for (int i = 1; i < 4; ++i) qc[i] = -quat[i];
    D w4[4], R[3][3];
    qmul(quatd, qc, w4);
    const D w[3] = {T(2) * w4[1], T(2) * w4[2], T(2) * w4[3]};
    quat_to_mat(quat, R);
    const T m = sc.bmass[b];
    const T* I3 = sc.binertia + 3 * b;
    D rot = cst<D>(T(0));
    for (int i = 0; i < 3; ++i) {
      const D wl = R[0][i] * w[0] + R[1][i] * w[1] + R[2][i] * w[2];
      rot = rot + I3[i] * (wl * wl);
    }
    const D lin = bpe[0].d * bpe[0].d + bpe[1].d * bpe[1].d +
                  bpe[2].d * bpe[2].d;
    kin = kin + T(0.5) * (m * lin) + T(0.5) * rot;
    pot = pot + m * (sc.grav[0] * bpe[0].v + sc.grav[1] * bpe[1].v +
                     sc.grav[2] * bpe[2].v);
  }
  return kin + pot;   // T - V, V = -sum m g.p
}

// One sweep of the Lagrangian: s < n gives dL/dq_s, s >= n gives dL/dv_{s-n}
template <class S, class T, int M = kMaxN>
__device__ S el_sweep(const Scene<T>& sc, const S* q, const S* v, int s) {
  using D = Dual<S>;
  const int n = sc.n;
  D qd[M], vd[M];
  for (int i = 0; i < n; ++i) {
    qd[i] = D{q[i], cst<S>(T(0))};
    vd[i] = D{v[i], cst<S>(T(0))};
  }
  if (s < n)
    qd[s].d = cst<S>(T(1));
  else
    vd[s - n].d = cst<S>(T(1));
  return lagrangian<D, T, M>(sc, qd, vd).d;
}

// (dL/dq, dL/dv) by 2n sweeps; dLdq may be null (momentum only)
template <class S, class T, int M = kMaxN>
__device__ void el_pair(const Scene<T>& sc, const S* q, const S* v, S* dLdq,
                        S* p) {
  const int n = sc.n;
  if (dLdq != nullptr) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) dLdq[i] = el_sweep<S, T, M>(sc, q, v, i);
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) p[i] = el_sweep<S, T, M>(sc, q, v, n + i);
}

// -- geometric velocity kinematics (sim/lanes.dof_frames, joint_twists,
//    wrench_to_Q) --------------------------------------------------------------
template <class S, class T>
__device__ __noinline__ void dof_frames(const Scene<T>& sc, const S* q,
                                        S (*jp)[3], S (*jq)[4],
                                        S (*w)[3], S (*c)[3]) {
  const int n = sc.n;
  const S zero = cst<S>(T(0)), one = cst<S>(T(1));
  for (int k = 0; k < n; ++k)
    for (int i = 0; i < 3; ++i) w[k][i] = c[k][i] = zero;
#pragma unroll 1
  for (int j = 0; j < sc.J; ++j) {
    const int par = sc.jparent[j];
    const int* ti = sc.trans_idx + 3 * j;
    const int* ri = sc.rot_idx + 3 * j;
    const int* mf = sc.mflags + 3 * j;
    const T* jqc = sc.jquat + 4 * j;
    S Fq[4];
    if (par >= 0) {
      qmul(jq[par], jqc, Fq);
    } else {
      const T id[4] = {T(1), T(0), T(0), T(0)};
      T f[4];
      qmul(id, jqc, f);
      for (int i = 0; i < 4; ++i) Fq[i] = cst<S>(f[i]);
    }
    const T* bs = sc.basis + 9 * j;
    for (int i = 0; i < 3; ++i) {
      if (ti[i] >= n) continue;
      const T col[3] = {bs[i], bs[3 + i], bs[6 + i]};   // basis[j][:, i]
      qrot(Fq, col, w[ti[i]]);
    }
    if (mf[0]) {
      const int d = ri[0];
      qrot(Fq, sc.jaxis + 3 * j, w[d]);
      for (int i = 0; i < 3; ++i) c[d][i] = jp[j][i];
    } else if (mf[1]) {     // columns of the SO(3) left Jacobian
      const S r[3] = {q[ri[0]], q[ri[1]], q[ri[2]]};
      const S th2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      const S th = ssqrt(th2 + T(1e-12));
      const bool small = pv(th2) < T(1e-8);
      const S safe2 = small ? one : th2;
      const S a = small ? T(0.5) - th2 / T(24) : (T(1) - scos(th)) / safe2;
      const S bb = small ? T(1) / T(6) - th2 / T(120)
                         : (th - ssin(th)) / (safe2 * th);
      for (int i = 0; i < 3; ++i) {
        S e[3] = {zero, zero, zero};
        e[i] = one;
        S rxe[3], rrxe[3], col[3];
        cross3(r, e, rxe);
        cross3(r, rxe, rrxe);
        for (int k = 0; k < 3; ++k) col[k] = e[k] + a * rxe[k] + bb * rrxe[k];
        qrot(Fq, col, w[ri[i]]);
        for (int k = 0; k < 3; ++k) c[ri[i]][k] = jp[j][k];
      }
    } else if (mf[2]) {     // x, Rx y, Rx Ry z
      const S ex = q[ri[0]], ey = q[ri[1]];
      const S cx = scos(ex), sx = ssin(ex), cy = scos(ey), sy = ssin(ey);
      const S l[3][3] = {{one, zero, zero},
                         {zero, cx, sx},
                         {sy, -(sx * cy), cx * cy}};
      for (int i = 0; i < 3; ++i) {
        qrot(Fq, l[i], w[ri[i]]);
        for (int k = 0; k < 3; ++k) c[ri[i]][k] = jp[j][k];
      }
    }
  }
}

template <class S, class T>
__device__ void joint_twists(const Scene<T>& sc, S (*w)[3],
                             S (*c)[3], const S* v, S (*om)[3],
                             S (*be)[3]) {
  const S zero = cst<S>(T(0));
  for (int j = 0; j < sc.J; ++j)
    for (int i = 0; i < 3; ++i) om[j][i] = be[j][i] = zero;
#pragma unroll 1
  for (int k = 0; k < sc.n; ++k) {
    const bool rot = sc.rotm[k] != 0;
    S wv[3], u[3];
    for (int i = 0; i < 3; ++i) wv[i] = w[k][i] * v[k];
    cross3(w[k], c[k], u);
    for (int j = 0; j < sc.J; ++j) {
      if (!sc.anc[k * sc.J + j]) continue;
      for (int i = 0; i < 3; ++i) {
        if (rot) {
          om[j][i] = om[j][i] + wv[i];
          be[j][i] = be[j][i] - u[i] * v[k];
        } else {
          be[j][i] = be[j][i] + wv[i];
        }
      }
    }
  }
}

// -- the kinematic state a residual evaluation shares -----------------------
// FK (joint and body frames), the per-dof geometric frames and the joints'
// world twists at (qn, v).
template <class S, int M>
struct Kin {
  S jp[M][3], jq[M][4], bp[M][3], bq[M][4], w[M][3], c[M][3], om[M][3],
      be[M][3];
};

template <class S, class T, int M>
__device__ __noinline__ void kinematics(const Scene<T>& sc, const S* qn,
                                        const S* v, Kin<S, M>& k) {
  fk_joints(sc, qn, k.jp, k.jq);
  fk_bodies(sc, k.jp, k.jq, k.bp, k.bq);
  dof_frames(sc, qn, k.jp, k.jq, k.w, k.c);
  joint_twists(sc, k.w, k.c, v, k.om, k.be);
}

// -- contact wrenches (K1's law per point; -f and -x x f on the primitive) ----
// points [k0, k1) of segment s, added into fs (force) and ts (torque)
template <class S, class T, int M>
__device__ __noinline__ void contact_chunk(const Scene<T>& sc,
                                           const Kin<S, M>& kn, int s, int k0,
                                           int k1, S* fs, S* ts) {
  const S zero = cst<S>(T(0));
  const int* sg = sc.seg + kSegCols * s;
  const int row0 = sg[0], j = sg[2], pb = sg[3], pj = sg[4];
  const int gt = sg[5];
  const T* prm = sc.params + 4 * sg[6];
  S R[3][3], cc[3];
  const T* sz = sc.bsize;
  if (gt != kGround) {
    quat_to_mat(kn.bq[pb], R);
    for (int i = 0; i < 3; ++i) cc[i] = kn.bp[pb][i];
    sz = sc.bsize + 3 * pb;
  } else {
    for (int a = 0; a < 3; ++a)
      for (int i = 0; i < 3; ++i) R[a][i] = zero;
    for (int i = 0; i < 3; ++i) cc[i] = zero;
  }
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    S x[3], vr[3], ox[3], phi, nrm[3], f[3], xf[3];
    point_world(kn.jp[j], kn.jq[j], sc.xi + 3 * (row0 + k), x);
    cross3(kn.om[j], x, ox);
    for (int i = 0; i < 3; ++i) vr[i] = ox[i] + kn.be[j][i];
    if (gt != kGround) {
      S op[3];
      cross3(kn.om[pj], x, op);
      for (int i = 0; i < 3; ++i) vr[i] = vr[i] - (op[i] + kn.be[pj][i]);
    }
    sdf_normal(gt, x, R, cc, sz, sc.gpos, sc.gn, phi, nrm);
    penalty_force(phi, nrm, vr, prm[0], prm[1], prm[2], prm[3], f);
    cross3(x, f, xf);
    for (int i = 0; i < 3; ++i) {
      fs[i] = fs[i] + f[i];
      ts[i] = ts[i] + xf[i];
    }
  }
}

// a segment's sums onto its two joints
template <class S, class T>
__device__ __forceinline__ void add_segment(const Scene<T>& sc, int s,
                                            const S* fs, const S* ts,
                                            S (*F)[3], S (*Tau)[3]) {
  const int* sg = sc.seg + kSegCols * s;
  const int j = sg[2], pj = sg[4];
  for (int i = 0; i < 3; ++i) {
    F[j][i] = F[j][i] + fs[i];
    Tau[j][i] = Tau[j][i] + ts[i];
    if (sg[5] != kGround) {
      F[pj][i] = F[pj][i] - fs[i];
      Tau[pj][i] = Tau[pj][i] - ts[i];
    }
  }
}

template <class S, class T, int M>
__device__ void contact_wrenches(const Scene<T>& sc, const Kin<S, M>& kn,
                                 S (*F)[3], S (*Tau)[3]) {
  const S zero = cst<S>(T(0));
  for (int j = 0; j < sc.J; ++j)
    for (int i = 0; i < 3; ++i) F[j][i] = Tau[j][i] = zero;
#pragma unroll 1
  for (int s = 0; s < sc.S; ++s) {
    S fs[3] = {zero, zero, zero}, ts[3] = {zero, zero, zero};
    contact_chunk(sc, kn, s, 0, sc.seg[kSegCols * s + 1], fs, ts);
    add_segment(sc, s, fs, ts, F, Tau);
  }
}

// -- the residual (sim/lanes.make_residual) ----------------------------------
// r = p(qn, v) - p_base - h (dL/dq(qn, v) + Q(qn, v, u)); Q from the
// springs, limits, motors and the contact wrenches F, Tau per joint
template <class S, class T, int M>
__device__ __noinline__ void assemble(const Scene<T>& sc, const S* qn,
                                      const S* v, const T* u,
                                      const T* pbase, const Kin<S, M>& kn,
                                      S (*F)[3], S (*Tau)[3], const S* dLdq,
                                      const S* p, S* r) {
  const int n = sc.n;
  S Q[M];
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    // springs and limits
    Q[k] = -sc.damp[k] * v[k] +
           sc.stiff[k] * (smax2(sc.lo[k] - qn[k], T(0)) -
                          smax2(qn[k] - sc.hi[k], T(0)));
  }
  for (int m = 0; m < sc.nu; ++m) {
    const int d = sc.motor_dof[m];
    const T uc = smin2(smax2(u[m], sc.ulo[m]), sc.uhi[m]);
    const S pd = sc.kp[m] * (uc - qn[d]) - sc.kd[m] * v[d];
    Q[d] = Q[d] + (sc.umask[m] * pd + (T(1) - sc.umask[m]) * uc);
  }
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const bool rot = sc.rotm[k] != 0;
    const S* w = kn.w[k];
    S u3[3];
    cross3(w, kn.c[k], u3);
    S acc = cst<S>(T(0));
    for (int j = 0; j < sc.J; ++j) {
      if (!sc.anc[k * sc.J + j]) continue;
      const S wF = w[0] * F[j][0] + w[1] * F[j][1] + w[2] * F[j][2];
      if (rot) {
        const S wT = w[0] * Tau[j][0] + w[1] * Tau[j][1] + w[2] * Tau[j][2];
        const S uF =
            u3[0] * F[j][0] + u3[1] * F[j][1] + u3[2] * F[j][2];
        acc = acc + (wT - uF);
      } else {
        acc = acc + wF;
      }
    }
    r[k] = p[k] - pbase[k] - sc.h * (dLdq[k] + (Q[k] + acc));
  }
}

// the whole residual in one thread (the host tools' unit of count)
template <class S, class T, int M = kMaxN>
__device__ __noinline__ void residual(const Scene<T>& sc, const S* qn,
                                      const S* v, const T* u,
                                      const T* pbase, S* r) {
  S dLdq[M], p[M];
  el_pair<S, T, M>(sc, qn, v, dLdq, p);
  Kin<S, M> kn;
  kinematics(sc, qn, v, kn);
  S F[M][3], Tau[M][3];
  contact_wrenches(sc, kn, F, Tau);
  assemble(sc, qn, v, u, pbase, kn, F, Tau, dLdq, p, r);
}

// -- per-lane dense linear algebra (sim/lanes.gauss_factor, gauss_solve,
//    _ridge) ---------------------------------------------------------------------
template <class T>
__device__ T ridge_eps();
template <>
__device__ float ridge_eps<float>() { return 1e-7f; }
template <>
__device__ double ridge_eps<double>() { return 1e-12; }

template <class T, int M>
__device__ void ridge_factor(T (*A)[M], int n) {
  T dm = T(0);
  for (int i = 0; i < n; ++i) dm = dm + sabs(A[i][i]);
  const T ridge = ridge_eps<T>() * (dm / T(n) + T(1));
  for (int i = 0; i < n; ++i) A[i][i] = A[i][i] + ridge;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const T inv = T(1) / A[k][k];
    for (int i = k + 1; i < n; ++i) {
      const T f = A[i][k] * inv;
      A[i][k] = f;
      for (int j = k + 1; j < n; ++j) A[i][j] = A[i][j] - f * A[k][j];
    }
  }
}

template <class T, int M>
__device__ void lu_solve(T (*lu)[M], int n, const T* b, T* x) {
  for (int i = 0; i < n; ++i) {
    T acc = b[i];
    for (int j = 0; j < i; ++j) acc = acc - lu[i][j] * x[j];
    x[i] = acc;
  }
  for (int i = n - 1; i >= 0; --i) {
    T acc = x[i];
    for (int j = i + 1; j < n; ++j) acc = acc - lu[i][j] * x[j];
    x[i] = acc / lu[i][i];
  }
}

template <class T>
__device__ T norm(const T* r, int n) {
  T s = T(0);
  for (int i = 0; i < n; ++i) s = s + r[i] * r[i];
  return ssqrt(s);
}

// columns of the residual's Jacobians at (qn = q_base + h v, v) in one
// thread (the host tools' unit of count): for each k, J[:, k] (direction
// qn: h e_k, v: e_k) and, if Cq, dr/dqn[:, k]
template <class T, int M>
__device__ void residual_columns(const Scene<T>& sc, const T* q_base,
                                 const T* v, const T* u, const T* pbase,
                                 T (*J)[M], T (*Cq)[M]) {
  using D = Dual<T>;
  const int n = sc.n;
  D qn[M], vv[M], r[M];
  for (int i = 0; i < n; ++i) {
    qn[i] = D{q_base[i] + sc.h * v[i], T(0)};
    vv[i] = D{v[i], T(0)};
  }
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    qn[k].d = sc.h;
    vv[k].d = T(1);
    residual<D, T, M>(sc, qn, vv, u, pbase, r);
    for (int i = 0; i < n; ++i) J[i][k] = r[i].d;
    vv[k].d = T(0);
    if (Cq != nullptr) {
      qn[k].d = T(1);
      residual<D, T, M>(sc, qn, vv, u, pbase, r);
      for (int i = 0; i < n; ++i) Cq[i][k] = r[i].d;
    }
    qn[k].d = T(0);
  }
}

template <class T, int M = kMaxN>
__device__ void momentum(const Scene<T>& sc, const T* q, const T* qd, T* p) {
  el_pair<T, T, M>(sc, q, qd, static_cast<T*>(nullptr), p);
}

// -- one lane's team ---------------------------------------------------------
// On the card a team is one warp: for_each deals tasks 0..n-1 to its 32
// threads in turn (task i to thread i mod 32) and sync() is __syncwarp().
// Built as host C++ (megastep_host.py) a team is one thread that runs a
// width of `size` in order: for each rank, that rank's tasks. Every task
// writes only its own slots, and every combine runs in a fixed order in one
// task, so the result does not depend on the width, nor on which thread
// ran which task. Code outside for_each runs on every thread of the team;
// it only reads the lane's shared state after a sync() and computes the same
// values on each thread (the chord's norms and its stop test).
struct Team {
  int rank, size;

  template <class F>
  __device__ __forceinline__ void for_each(int n, const F& f) const {
#ifdef __CUDA_ARCH__
#pragma unroll 1
    for (int i = rank; i < n; i += size) f(i);
#else
    for (int r = 0; r < size; ++r)
      for (int i = r; i < n; i += size) f(i);
#endif
  }

  __device__ __forceinline__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

// -- contact chunks: each segment cut into runs of at most P points ----------
template <class T>
__device__ int n_chunks(const Scene<T>& sc, int P) {
  int c = 0;
  for (int s = 0; s < sc.S; ++s) c += (sc.seg[kSegCols * s + 1] + P - 1) / P;
  return c;
}

// the shortest run length from P0 up (doubling) that keeps the chunks
// within cap (cap >= the number of segments)
template <class T>
__device__ int chunk_len(const Scene<T>& sc, int P0, int cap) {
  int P = P0;
  while (n_chunks(sc, P) > cap) P *= 2;
  return P;
}

template <class T>
__device__ void chunk_at(const Scene<T>& sc, int P, int idx, int& s, int& k0,
                         int& k1) {
  for (s = 0; s < sc.S; ++s) {
    const int np = sc.seg[kSegCols * s + 1];
    const int c = (np + P - 1) / P;
    if (idx < c) {
      k0 = idx * P;
      k1 = k0 + P < np ? k0 + P : np;
      return;
    }
    idx -= c;
  }
}

// -- a batch of residual evaluations, spread over the team --------------------
// S = T: residual values; S = Dual<T>: columns. NC evaluations at most.
template <class S, int M, int NC, int NCH>
struct ResidualWork {
  Kin<S, M> kin[NC];
  S lag[NC][2 * M];       // el_pair's sweeps: dL/dq (0..n-1), p (n..2n-1)
  S part[NC][NCH][6];     // contact chunk sums: force, torque
  S r[NC][M];
};

// (qn, v) lifted to the scalar S: as they are (S = T), or with the tangent
// (a e_k, b e_k) (S = Dual<T>: residual column k)
template <class T>
__device__ __forceinline__ void seed(const T* qn, const T* v, T, T, int,
                                     int n, T* x, T* y) {
  for (int i = 0; i < n; ++i) {
    x[i] = qn[i];
    y[i] = v[i];
  }
}
template <class T>
__device__ __forceinline__ void seed(const T* qn, const T* v, T a, T b,
                                     int k, int n, Dual<T>* x, Dual<T>* y) {
  for (int i = 0; i < n; ++i) {
    x[i] = Dual<T>{qn[i], i == k ? a : T(0)};
    y[i] = Dual<T>{v[i], i == k ? b : T(0)};
  }
}

struct NoExtra {
  __device__ void operator()(int) const {}
};

// The residual at (qn, v) for columns k0 .. k0 + nc - 1 (S = Dual<T>; nc = 1,
// k0 unused, for S = T) into w.r, in three phases:
//   1. nc kinematics tasks, nc x 2n Lagrangian sweeps, and `nextra` tasks of
//      the caller's (`extra(i)`), all independent;
//   2. nc x (contact chunks of at most P points);
//   3. nc assemblies: the chunk sums in segment order, then Q and r.
template <class S, class T, int M, int NC, int NCH, class Extra>
__device__ void residual_batch(const Team& tm, const Scene<T>& sc,
                               ResidualWork<S, M, NC, NCH>& w, int k0, int nc,
                               const T* qn, const T* v, T a, T b, const T* u,
                               const T* pbase, int P, int nextra,
                               const Extra& extra) {
  const int n = sc.n, ns = 2 * n;
  tm.for_each(nc + nc * ns + nextra, [&](int t) {
    S x[M], y[M];
    if (t < nc) {
      seed(qn, v, a, b, k0 + t, n, x, y);
      kinematics(sc, x, y, w.kin[t]);
    } else if (t < nc + nc * ns) {
      const int c = (t - nc) / ns, s = (t - nc) % ns;
      seed(qn, v, a, b, k0 + c, n, x, y);
      w.lag[c][s] = el_sweep<S, T, M>(sc, x, y, s);
    } else {
      extra(t - nc - nc * ns);
    }
  });
  tm.sync();
  const int nch = n_chunks(sc, P);
  tm.for_each(nc * nch, [&](int t) {
    const int c = t / nch, ch = t % nch;
    int s, p0, p1;
    chunk_at(sc, P, ch, s, p0, p1);
    S* o = w.part[c][ch];
    for (int i = 0; i < 6; ++i) o[i] = cst<S>(T(0));
    contact_chunk(sc, w.kin[c], s, p0, p1, o, o + 3);
  });
  tm.sync();
  tm.for_each(nc, [&](int c) {
    const S zero = cst<S>(T(0));
    S F[M][3], Tau[M][3];
    for (int j = 0; j < sc.J; ++j)
      for (int i = 0; i < 3; ++i) F[j][i] = Tau[j][i] = zero;
    int ch = 0;
    for (int s = 0; s < sc.S; ++s) {
      S fs[3] = {zero, zero, zero}, ts[3] = {zero, zero, zero};
      const int c_s = (sc.seg[kSegCols * s + 1] + P - 1) / P;
      for (int e = 0; e < c_s; ++e, ++ch)
        for (int i = 0; i < 3; ++i) {
          fs[i] = fs[i] + w.part[c][ch][i];
          ts[i] = ts[i] + w.part[c][ch][3 + i];
        }
      add_segment(sc, s, fs, ts, F, Tau);
    }
    S x[M], y[M];
    seed(qn, v, a, b, k0 + c, n, x, y);
    assemble(sc, x, y, u, pbase, w.kin[c], F, Tau, w.lag[c], w.lag[c] + n,
             w.r[c]);
  });
  tm.sync();
}

// -- the lane's state in shared memory --------------------------------------
template <class T, int M>
using ColumnWork = ResidualWork<Dual<T>, M, kColBatch, kColChunks>;
template <class T, int M>
using ValueWork = ResidualWork<T, M, 1, kValChunks>;

template <class T, int M>
struct FwdLane {
  T q[M], qd[M], u[M], pb[M], v[M], v_best[M], qn[M], dv[M];
  T lu[M][M];
  union {
    ColumnWork<T, M> col;   // the entry Jacobian
    ValueWork<T, M> val;    // then the chord's residual values
  } w;
};

template <class T, int M>
struct BwdLane {
  T qk[M], qdk[M], vst[M], qn[M], pb[M], u[M], g_q[M], g_v[M], g_u[M],
      gvs[M], lam[M];
  T JT[M][M], Cq[M][M];
  T pull[2 * M][M];   // p(q_k, qd_k)'s columns: d p_i along q_c, then qd_c
  ColumnWork<T, M> col;
};

// -- K2: one lane -----------------------------------------------------------
template <class T, int M>
__device__ void fwd_lane(const Team& tm, const Scene<T>& sc, FwdLane<T, M>& L,
                         int K, int max_iter, T tol, const T* q0,
                         const T* qd0, const T* u0, int B, int b, T* qo,
                         T* qdo, T* vs, int* nres) {
  const int n = sc.n;
  const T h = sc.h;
  tm.for_each(n, [&](int i) {
    L.q[i] = q0[i * B + b];
    L.qd[i] = qd0[i * B + b];
    L.qn[i] = L.q[i] + h * L.qd[i];
  });
  tm.for_each(sc.nu, [&](int m) { L.u[m] = u0[m * B + b]; });
  tm.sync();
  // the momentum at (q, qd): n sweeps, riding along a batch's first phase
  auto momentum_sweep = [&](int i) {
    L.pb[i] = el_sweep<T, T, M>(sc, L.q, L.qd, n + i);
  };
  // ONE chord factor per env step, at the entry state
  const int Pc = chunk_len(sc, kColChunkLen, kColChunks);
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += kColBatch) {
    const int nc = n - k0 < kColBatch ? n - k0 : kColBatch;
    residual_batch(tm, sc, L.w.col, k0, nc, L.qn, L.qd, h, T(1), L.u, L.pb,
                   Pc, k0 == 0 ? n : 0, momentum_sweep);
    tm.for_each(n * nc, [&](int t) {
      L.lu[t % n][k0 + t / n] = L.w.col.r[t / n][t % n].d;
    });
    tm.sync();
  }
  tm.for_each(1, [&](int) { ridge_factor(L.lu, n); });
  tm.sync();
  // frame_skip substeps of chord iteration, best iterate kept
  // (sim/lanes._chord). A lane whose residual norm is at or below tol_eff
  // stops: the sweeps that the plain version still runs change nothing.
  const int Pv = chunk_len(sc, kValChunkLen, kValChunks);
  const T rel = sizeof(T) == 4 ? T(1e-4) : T(1e-7);
  const T* r = L.w.val.r[0];
  int evals = 0;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    tm.for_each(n, [&](int i) {
      L.v[i] = L.v_best[i] = L.qd[i];
      L.qn[i] = L.q[i] + h * L.v[i];
    });
    tm.sync();
    residual_batch(tm, sc, L.w.val, 0, 1, L.qn, L.v, T(0), T(0), L.u, L.pb,
                   Pv, n, momentum_sweep);
    ++evals;
    T rn = norm(r, n);
    T rn_best = rn;
    const T tol_eff = smax2(rel * rn, tol);
#pragma unroll 1
    for (int it = 0; it < max_iter; ++it) {
      if (rn <= tol_eff) break;
      tm.for_each(1, [&](int) {
        lu_solve(L.lu, n, r, L.dv);
        for (int i = 0; i < n; ++i) {
          L.v[i] = L.v[i] - L.dv[i];
          L.qn[i] = L.q[i] + h * L.v[i];
        }
      });
      tm.sync();
      residual_batch(tm, sc, L.w.val, 0, 1, L.qn, L.v, T(0), T(0), L.u,
                     L.pb, Pv, 0, NoExtra());
      ++evals;
      rn = norm(r, n);
      if (rn < rn_best) {
        rn_best = rn;
        tm.for_each(n, [&](int i) { L.v_best[i] = L.v[i]; });
        tm.sync();
      }
    }
    tm.for_each(n, [&](int i) {
      const T vi = L.v_best[i];
      vs[(k * n + i) * B + b] = vi;
      L.q[i] = L.q[i] + h * vi;
      L.qd[i] = vi;
    });
    tm.sync();
  }
  tm.for_each(n, [&](int i) {
    qo[i * B + b] = L.q[i];
    qdo[i * B + b] = L.qd[i];
  });
  tm.for_each(1, [&](int) { nres[b] = evals; });
}

// -- K3: one lane -----------------------------------------------------------
template <class T, int M>
__device__ void bwd_lane(const Team& tm, const Scene<T>& sc, BwdLane<T, M>& L,
                         int K, const T* q0, const T* qd0, const T* u0,
                         const T* vs, const T* gq, const T* gqd,
                         const T* gqp, const T* gqdp, int B, int b, T* gq0,
                         T* gqd0, T* gu0) {
  const int n = sc.n, nu = sc.nu;
  const T h = sc.h;
  tm.for_each(n, [&](int i) {
    L.g_q[i] = gq[i * B + b];
    L.g_v[i] = gqd[i * B + b];
  });
  tm.for_each(nu, [&](int m) {
    L.u[m] = u0[m * B + b];
    L.g_u[m] = T(0);
  });
  tm.sync();
  // riding along the first batch of J's columns: the momentum
  // p_base = p(q_k, qd_k) (n sweeps) and its 2n columns (n sweeps each)
  auto momentum_sweeps = [&](int t) {
    if (t < n) {
      L.pb[t] = el_sweep<T, T, M>(sc, L.qk, L.qdk, n + t);
      return;
    }
    t -= n;
    const int c = t / n, i = t % n;
    Dual<T> qq[M], vv[M];
    for (int j = 0; j < n; ++j) {
      qq[j] = Dual<T>{L.qk[j], j == c ? T(1) : T(0)};
      vv[j] = Dual<T>{L.qdk[j], j == c - n ? T(1) : T(0)};
    }
    L.pull[c][i] = el_sweep<Dual<T>, T, M>(sc, qq, vv, n + i).d;
  };
  const int Pc = chunk_len(sc, kColChunkLen, kColChunks);
#pragma unroll 1
  for (int k = K - 1; k >= 0; --k) {
    // the substep's entry state (q_k, qd_k), rebuilt from q0 and vs
    tm.for_each(n, [&](int i) {
      T qi = q0[i * B + b], qdi = qd0[i * B + b];
      for (int s = 0; s < k; ++s) {
        const T vi = vs[(s * n + i) * B + b];
        qi = qi + h * vi;
        qdi = vi;
      }
      const T vk = vs[(k * n + i) * B + b];
      L.qk[i] = qi;
      L.qdk[i] = qdi;
      L.vst[i] = vk;
      L.qn[i] = qi + h * vk;
      L.gvs[i] = L.g_v[i] + h * L.g_q[i];
    });
    tm.sync();
    // exact J at v* (kept transposed), then dr/dq_base
#pragma unroll 1
    for (int k0 = 0; k0 < n; k0 += kColBatch) {
      const int nc = n - k0 < kColBatch ? n - k0 : kColBatch;
      residual_batch(tm, sc, L.col, k0, nc, L.qn, L.vst, h, T(1), L.u, L.pb,
                     Pc, k0 == 0 ? n + 2 * n * n : 0, momentum_sweeps);
      tm.for_each(n * nc, [&](int t) {
        L.JT[k0 + t / n][t % n] = L.col.r[t / n][t % n].d;
      });
      tm.sync();
    }
#pragma unroll 1
    for (int k0 = 0; k0 < n; k0 += kColBatch) {
      const int nc = n - k0 < kColBatch ? n - k0 : kColBatch;
      residual_batch(tm, sc, L.col, k0, nc, L.qn, L.vst, T(1), T(0), L.u,
                     L.pb, Pc, 0, NoExtra());
      tm.for_each(n * nc, [&](int t) {
        L.Cq[t % n][k0 + t / n] = L.col.r[t / n][t % n].d;
      });
      tm.sync();
    }
    // lambda = J^{-T} (g_v + h g_q); pull -lambda back: q_base through
    // dr/dqn, p_base (dr/dp_base = -I) through p(q_k, qd_k)'s columns, u
    // through the motor rows; fold in q_prev / qdot_prev at k = K - 1
    tm.for_each(1, [&](int) {
      ridge_factor(L.JT, n);
      lu_solve(L.JT, n, L.gvs, L.lam);
      for (int m = 0; m < nu; ++m) {
        const Dual<T> uc =
            smin2(smax2(Dual<T>{L.u[m], T(1)}, sc.ulo[m]), sc.uhi[m]);
        const T dQdu = (sc.umask[m] * sc.kp[m] + (T(1) - sc.umask[m])) * uc.d;
        L.g_u[m] = L.g_u[m] + h * dQdu * L.lam[sc.motor_dof[m]];
      }
      for (int j = 0; j < n; ++j) {
        T acc = T(0);
        for (int i = 0; i < n; ++i) acc = acc + L.Cq[i][j] * L.lam[i];
        const T bq = -acc;
        T mq = T(0), mv = T(0);
        for (int i = 0; i < n; ++i) mq = mq + L.lam[i] * L.pull[j][i];
        for (int i = 0; i < n; ++i) mv = mv + L.lam[i] * L.pull[n + j][i];
        L.g_q[j] = L.g_q[j] + bq + mq;
        L.g_v[j] = mv;
        if (k == K - 1) {   // q_prev = q_{K-1}, qdot_prev = qd_{K-1}
          L.g_q[j] = L.g_q[j] + gqp[j * B + b];
          L.g_v[j] = L.g_v[j] + gqdp[j * B + b];
        }
      }
    });
    tm.sync();
  }
  tm.for_each(n, [&](int i) {
    gq0[i * B + b] = L.g_q[i];
    gqd0[i * B + b] = L.g_v[i];
  });
  tm.for_each(nu, [&](int m) { gu0[m * B + b] = L.g_u[m]; });
}

}  // namespace

// Everything above is device code that also compiles as host C++ (with
// stand-ins for the CUDA qualifiers): megastep_host.py builds it so to
// run it against the plain version on a CPU and to count its arithmetic.
// The launches below need nvcc.
#ifdef __CUDACC__
namespace {

// -- the kernels: one warp per lane, blockDim.x / 32 lanes per block -------
// The scene's small tables are staged in shared memory once per block; the
// contact points stay in device memory (each chunk reads its own).
template <int M>
__host__ __device__ constexpr int int_cap() {
  return 7 + 13 * M + M * M + kSegCols * kMaxSeg;
}
template <int M>
__host__ __device__ constexpr int float_cap() {
  return 10 + 42 * M + 4 * kMaxParam;
}

template <class T, int M>
struct SceneSmem {
  int ints[int_cap<M>()];
  T floats[float_cap<M>()];
};

template <class T, int M>
__host__ __device__ constexpr size_t scene_bytes() {
  return (sizeof(SceneSmem<T, M>) + 15) / 16 * 16;
}

template <class T, int M>
__device__ Scene<T> stage_scene(const int* itab, const T* ftab,
                                SceneSmem<T, M>& sm) {
  const int n = itab[0], J = itab[1], NB = itab[2], nu = itab[3],
            S = itab[4], Kp = itab[5];
  const int ni = 7 + 10 * J + NB + nu + kSegCols * S + n * J + n;
  const int nf = 10 + 19 * J + 14 * NB + 4 * n + 5 * nu + 4 * Kp;
  for (int i = threadIdx.x; i < ni; i += blockDim.x) sm.ints[i] = itab[i];
  for (int i = threadIdx.x; i < nf; i += blockDim.x) sm.floats[i] = ftab[i];
  __syncthreads();
  Scene<T> sc = load_scene(sm.ints, sm.floats);
  sc.xi = ftab + nf;
  return sc;
}

template <class T, int M>
__global__ void __launch_bounds__(128)
fwd_kernel(const int* __restrict__ itab, const T* __restrict__ ftab, int K,
           int max_iter, T tol, const T* __restrict__ q0,
           const T* __restrict__ qd0, const T* __restrict__ u0, int B,
           T* __restrict__ qo, T* __restrict__ qdo, T* __restrict__ vs,
           int* __restrict__ nres) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lanes = blockDim.x / kWarp, wid = threadIdx.x / kWarp;
  const int b = blockIdx.x * lanes + wid;
  const Team tm{static_cast<int>(threadIdx.x % kWarp), kWarp};
  const Scene<T> sc =
      stage_scene(itab, ftab, *reinterpret_cast<SceneSmem<T, M>*>(smem));
  if (b >= B) return;   // the ragged last block
  auto* lane =
      reinterpret_cast<FwdLane<T, M>*>(smem + scene_bytes<T, M>()) + wid;
  fwd_lane(tm, sc, *lane, K, max_iter, tol, q0, qd0, u0, B, b, qo, qdo, vs,
           nres);
}

template <class T, int M>
__global__ void __launch_bounds__(128)
bwd_kernel(const int* __restrict__ itab, const T* __restrict__ ftab, int K,
           const T* __restrict__ q0, const T* __restrict__ qd0,
           const T* __restrict__ u0, const T* __restrict__ vs,
           const T* __restrict__ gq, const T* __restrict__ gqd,
           const T* __restrict__ gqp, const T* __restrict__ gqdp, int B,
           T* __restrict__ gq0, T* __restrict__ gqd0, T* __restrict__ gu0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lanes = blockDim.x / kWarp, wid = threadIdx.x / kWarp;
  const int b = blockIdx.x * lanes + wid;
  const Team tm{static_cast<int>(threadIdx.x % kWarp), kWarp};
  const Scene<T> sc =
      stage_scene(itab, ftab, *reinterpret_cast<SceneSmem<T, M>*>(smem));
  if (b >= B) return;
  auto* lane =
      reinterpret_cast<BwdLane<T, M>*>(smem + scene_bytes<T, M>()) + wid;
  bwd_lane(tm, sc, *lane, K, q0, qd0, u0, vs, gq, gqd, gqp, gqdp, B, b, gq0,
           gqd0, gu0);
}


// -- launches ---------------------------------------------------------------
constexpr int kLanes = 2;   // lanes (warps) per block; see the note on top

// Local memory: the nested duals need a deep per-thread stack; raise the
// device's stack limit to the kernel's frame (it holds for every resident
// thread, so the frame is kept small: arrays sized by the instance's M).
template <class F>
cudaError_t fit_stack(F* kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  size_t cur = 0;
  err = cudaDeviceGetLimit(&cur, cudaLimitStackSize);
  if (err != cudaSuccess) return err;
  if (cur < attr.localSizeBytes)
    err = cudaDeviceSetLimit(cudaLimitStackSize, attr.localSizeBytes);
  return err;
}

// the stack, and the dynamic shared memory above the 48 KB default
template <class F>
cudaError_t prepare(F* kernel, size_t smem) {
  cudaError_t err = fit_stack(kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <class T, int M>
int launch_fwd_m(const int* itab, const T* ftab, int K, int max_iter, T tol,
                 const T* q0, const T* qd0, const T* u, int B, T* qo, T* qdo,
                 T* vs, int* nres, cudaStream_t stream) {
  const size_t smem = scene_bytes<T, M>() + kLanes * sizeof(FwdLane<T, M>);
  cudaError_t err = prepare(fwd_kernel<T, M>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kLanes * kWarp), grid((B + kLanes - 1) / kLanes);
  fwd_kernel<T, M><<<grid, block, smem, stream>>>(
      itab, ftab, K, max_iter, tol, q0, qd0, u, B, qo, qdo, vs, nres);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int M>
int launch_bwd_m(const int* itab, const T* ftab, int K, const T* q0,
                 const T* qd0, const T* u, const T* vs, const T* gq,
                 const T* gqd, const T* gqp, const T* gqdp, int B, T* gq0,
                 T* gqd0, T* gu, cudaStream_t stream) {
  const size_t smem = scene_bytes<T, M>() + kLanes * sizeof(BwdLane<T, M>);
  cudaError_t err = prepare(bwd_kernel<T, M>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kLanes * kWarp), grid((B + kLanes - 1) / kLanes);
  bwd_kernel<T, M><<<grid, block, smem, stream>>>(
      itab, ftab, K, q0, qd0, u, vs, gq, gqd, gqp, gqdp, B, gq0, gqd0, gu);
  return static_cast<int>(cudaGetLastError());
}

// The instance of bound M (kSmallN or kMaxN). The caller has checked the
// scene's counts against it: the launch knows the scene only by its device
// tables (ops/megastep.py MegaStep.instance picks M).
template <class T>
int launch_fwd(int M, const int* itab, const T* ftab, int K, int max_iter,
               T tol, const T* q0, const T* qd0, const T* u, int B, T* qo,
               T* qdo, T* vs, int* nres, void* stream_) {
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (M == kSmallN)
    return launch_fwd_m<T, kSmallN>(itab, ftab, K, max_iter, tol, q0, qd0, u,
                                    B, qo, qdo, vs, nres, stream);
  if (M == kMaxN)
    return launch_fwd_m<T, kMaxN>(itab, ftab, K, max_iter, tol, q0, qd0, u, B,
                                  qo, qdo, vs, nres, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class T>
int launch_bwd(int M, const int* itab, const T* ftab, int K, const T* q0,
               const T* qd0, const T* u, const T* vs, const T* gq,
               const T* gqd, const T* gqp, const T* gqdp, int B, T* gq0,
               T* gqd0, T* gu, void* stream_) {
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (M == kSmallN)
    return launch_bwd_m<T, kSmallN>(itab, ftab, K, q0, qd0, u, vs, gq, gqd,
                                    gqp, gqdp, B, gq0, gqd0, gu, stream);
  if (M == kMaxN)
    return launch_bwd_m<T, kMaxN>(itab, ftab, K, q0, qd0, u, vs, gq, gqd, gqp,
                                  gqdp, B, gq0, gqd0, gu, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// what the compiler and the card make of one instance:
//   out = [M, bytes per scalar, registers per thread, local (stack) bytes
//          per thread, static shared bytes, dynamic shared bytes per block,
//          lanes per block, resident blocks per SM, the device's stack
//          limit per thread in bytes]
template <class Lane, class F>
int instance_info(F* kernel, int M, int tbytes, size_t scene, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = scene + kLanes * sizeof(Lane);
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kLanes * kWarp, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t stack = 0;
  err = cudaDeviceGetLimit(&stack, cudaLimitStackSize);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[9] = {M, tbytes, a.numRegs, static_cast<int>(a.localSizeBytes),
                    static_cast<int>(a.sharedSizeBytes),
                    static_cast<int>(smem), kLanes, blocks,
                    static_cast<int>(stack)};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

template <class T, int M>
int info_of(bool bwd, int* out) {
  return bwd ? instance_info<BwdLane<T, M>>(bwd_kernel<T, M>, M, sizeof(T),
                                            scene_bytes<T, M>(), out)
             : instance_info<FwdLane<T, M>>(fwd_kernel<T, M>, M, sizeof(T),
                                            scene_bytes<T, M>(), out);
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 = launched). The
// caller checks the scene against megastep_limits: a kernel handed a scene
// above its instance's bounds overruns its shared memory.
// out = [largest n, J, NB, nu (the large instance's M), threads per block,
//        largest number of contact segments, of contact parameter rows,
//        the small instance's M]
extern "C" int megastep_limits(int* out) {
  out[0] = out[1] = out[2] = out[3] = kMaxN;
  out[4] = kLanes * kWarp;
  out[5] = kMaxSeg;
  out[6] = kMaxParam;
  out[7] = kSmallN;
  return 0;
}

// which: bit 0 the adjoint (K3), bit 1 double, bit 2 the large instance
extern "C" int megastep_kernel_info(int which, int* out) {
  const bool bwd = which & 1;
  switch (which >> 1) {
    case 0: return info_of<float, kSmallN>(bwd, out);
    case 1: return info_of<double, kSmallN>(bwd, out);
    case 2: return info_of<float, kMaxN>(bwd, out);
    case 3: return info_of<double, kMaxN>(bwd, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instance named by its bound M: megastep_limits' out[7] (small) or
// out[0] (large).
extern "C" int megastep_fwd_m_f32(int M, const int* itab, const float* ftab,
                                  int K, int max_iter, float tol,
                                  const float* q0, const float* qd0,
                                  const float* u, int B, float* qo,
                                  float* qdo, float* vs, int* nres,
                                  void* stream) {
  return launch_fwd<float>(M, itab, ftab, K, max_iter, tol, q0, qd0, u, B,
                           qo, qdo, vs, nres, stream);
}

extern "C" int megastep_fwd_m_f64(int M, const int* itab, const double* ftab,
                                  int K, int max_iter, double tol,
                                  const double* q0, const double* qd0,
                                  const double* u, int B, double* qo,
                                  double* qdo, double* vs, int* nres,
                                  void* stream) {
  return launch_fwd<double>(M, itab, ftab, K, max_iter, tol, q0, qd0, u, B,
                            qo, qdo, vs, nres, stream);
}

extern "C" int megastep_bwd_m_f32(int M, const int* itab, const float* ftab,
                                  int K, const float* q0, const float* qd0,
                                  const float* u, const float* vs,
                                  const float* gq, const float* gqd,
                                  const float* gqp, const float* gqdp, int B,
                                  float* gq0, float* gqd0, float* gu,
                                  void* stream) {
  return launch_bwd<float>(M, itab, ftab, K, q0, qd0, u, vs, gq, gqd, gqp,
                           gqdp, B, gq0, gqd0, gu, stream);
}

extern "C" int megastep_bwd_m_f64(int M, const int* itab, const double* ftab,
                                  int K, const double* q0, const double* qd0,
                                  const double* u, const double* vs,
                                  const double* gq, const double* gqd,
                                  const double* gqp, const double* gqdp,
                                  int B, double* gq0, double* gqd0,
                                  double* gu, void* stream) {
  return launch_bwd<double>(M, itab, ftab, K, q0, qd0, u, vs, gq, gqd, gqp,
                            gqdp, B, gq0, gqd0, gu, stream);
}

// The large instance, which takes every scene within megastep_limits.
extern "C" int megastep_fwd_f32(const int* itab, const float* ftab, int K,
                                int max_iter, float tol, const float* q0,
                                const float* qd0, const float* u, int B,
                                float* qo, float* qdo, float* vs, int* nres,
                                void* stream) {
  return launch_fwd<float>(kMaxN, itab, ftab, K, max_iter, tol, q0, qd0, u, B,
                           qo, qdo, vs, nres, stream);
}

extern "C" int megastep_fwd_f64(const int* itab, const double* ftab, int K,
                                int max_iter, double tol, const double* q0,
                                const double* qd0, const double* u, int B,
                                double* qo, double* qdo, double* vs,
                                int* nres, void* stream) {
  return launch_fwd<double>(kMaxN, itab, ftab, K, max_iter, tol, q0, qd0, u,
                            B, qo, qdo, vs, nres, stream);
}

extern "C" int megastep_bwd_f32(const int* itab, const float* ftab, int K,
                                const float* q0, const float* qd0,
                                const float* u, const float* vs,
                                const float* gq, const float* gqd,
                                const float* gqp, const float* gqdp, int B,
                                float* gq0, float* gqd0, float* gu,
                                void* stream) {
  return launch_bwd<float>(kMaxN, itab, ftab, K, q0, qd0, u, vs, gq, gqd, gqp,
                           gqdp, B, gq0, gqd0, gu, stream);
}

extern "C" int megastep_bwd_f64(const int* itab, const double* ftab, int K,
                                const double* q0, const double* qd0,
                                const double* u, const double* vs,
                                const double* gq, const double* gqd,
                                const double* gqp, const double* gqdp, int B,
                                double* gq0, double* gqd0, double* gu,
                                void* stream) {
  return launch_bwd<double>(kMaxN, itab, ftab, K, q0, qd0, u, vs, gq, gqd,
                            gqp, gqdp, B, gq0, gqd0, gu, stream);
}
#endif  // __CUDACC__
