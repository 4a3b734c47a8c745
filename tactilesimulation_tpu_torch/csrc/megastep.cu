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
// Layout. Per-lane arrays are batch-last, (rows, B) row-major; one thread
// per lane; blocks of 32 threads, so B = 1024 spreads over 32 SMs instead
// of K1's 8 blocks. The scene (FK tables, joint/body constants, mass and
// inertia, springs, motors, ground, segment table, contact points and
// parameters, ancestor mask) is two small packed tables (ops/megastep.py
// SceneTables.packed) read by every thread at the same addresses
// (broadcast). All per-lane state lives in registers and local memory.
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
// (~0.1 us at 3.35 TB/s) against 7.0e9 operations for K2 (0.11 ms at
// 67 TFLOP/s fp32) and 2.0e10 for K3 (0.30 ms): both are bound by
// operations (chip_smoke.py computes each bound from its run's inputs).
// One thread per lane leaves most of the card idle at B = 1024 (32 warps
// on 132 SMs), keeps each thread's chain of dual operations serial, repeats
// the primal in every sweep, and the nested duals spill to local memory;
// spreading the Jacobian columns over threads is the first step towards
// that bound, and later work.

#include <cuda_runtime.h>

#include "contact_point.cuh"

namespace {

using namespace tsim;

constexpr int kMaxN = 16;    // generalized coordinates
constexpr int kMaxJ = 16;    // joints
constexpr int kMaxNB = 16;   // bodies
constexpr int kMaxU = 16;    // controls
constexpr int kBlock = 32;
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

// -- quaternion algebra, operands of mixed scalar types ----------------------
template <class S, class A, class B>
__device__ __forceinline__ void cross3(const A a[3], const B b[3], S o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <class S, class A, class B>
__device__ __forceinline__ void qmul(const A a[4], const B b[4], S o[4]) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// quat_rotate: v + w t + qv x t,  t = 2 qv x v
template <class S, class A, class B>
__device__ __forceinline__ void qrot(const A q[4], const B v[3], S o[3]) {
  using P = base_t<S>;
  S t[3];
  t[0] = P(2) * (q[2] * v[2] - q[3] * v[1]);
  t[1] = P(2) * (q[3] * v[0] - q[1] * v[2]);
  t[2] = P(2) * (q[1] * v[1] - q[2] * v[0]);
  o[0] = v[0] + q[0] * t[0] + (q[2] * t[2] - q[3] * t[1]);
  o[1] = v[1] + q[0] * t[1] + (q[3] * t[0] - q[1] * t[2]);
  o[2] = v[2] + q[0] * t[2] + (q[1] * t[1] - q[2] * t[0]);
}

// -- kinematics (sim/lanes.fk_joints, fk_bodies) -----------------------------
template <class S, class T>
__device__ void fk_joints(const Scene<T>& sc, const S* q, S (*jp)[3],
                          S (*jq)[4]) {
  const int n = sc.n;
  const S zero = cst<S>(T(0));
#pragma unroll 1
  for (int j = 0; j < sc.J; ++j) {
    const int* ti = sc.trans_idx + 3 * j;
    const int* ri = sc.rot_idx + 3 * j;
    const int* mf = sc.mflags + 3 * j;
    const T* bs = sc.basis + 9 * j;   // basis[j][i][k] = bs[3 i + k]
    S qt[3], r[3];
    for (int k = 0; k < 3; ++k) {
      qt[k] = ti[k] < n ? q[ti[k]] : zero;
      r[k] = ri[k] < n ? q[ri[k]] : zero;
    }
    S tl[3];
    for (int i = 0; i < 3; ++i)
      tl[i] = qt[0] * bs[3 * i] + qt[1] * bs[3 * i + 1] + qt[2] * bs[3 * i + 2];
    S ql[4];
    if (mf[0]) {            // revolute: axis_angle_quat(axis0, r0)
      const T* ax = sc.jaxis + 3 * j;
      const S half = T(0.5) * r[0];
      const S sh = ssin(half);
      ql[0] = scos(half);
      for (int i = 0; i < 3; ++i) ql[1 + i] = sh * ax[i];
    } else if (mf[1]) {     // rotvec_to_quat
      const S asq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      const S ang = ssqrt(asq + T(1e-12));
      const S half = T(0.5) * ang;
      const bool small = pv(asq) < T(1e-8);
      const S kk = small ? T(0.5) - asq / T(48) : ssin(half) / ang;
      ql[0] = small ? T(1) - asq / T(8) : scos(half);
      for (int i = 0; i < 3; ++i) ql[1 + i] = kk * r[i];
    } else if (mf[2]) {     // euler_xyz_to_quat
      const S hx = T(0.5) * r[0], hy = T(0.5) * r[1], hz = T(0.5) * r[2];
      const S cx = scos(hx), cy = scos(hy), cz = scos(hz);
      const S sx = ssin(hx), sy = ssin(hy), sz = ssin(hz);
      ql[0] = cx * cy * cz - sx * sy * sz;
      ql[1] = sx * cy * cz + cx * sy * sz;
      ql[2] = cx * sy * cz - sx * cy * sz;
      ql[3] = cx * cy * sz + sx * sy * cz;
    } else {
      ql[0] = cst<S>(T(1));
      ql[1] = ql[2] = ql[3] = zero;
    }
    const T* jpc = sc.jpos + 3 * j;
    const T* jqc = sc.jquat + 4 * j;
    S rt[3], pl[3], qlo[4];
    qrot(jqc, tl, rt);
    for (int i = 0; i < 3; ++i) pl[i] = jpc[i] + rt[i];
    qmul(jqc, ql, qlo);
    const int par = sc.jparent[j];
    if (par < 0) {
      for (int i = 0; i < 3; ++i) jp[j][i] = pl[i];
      for (int i = 0; i < 4; ++i) jq[j][i] = qlo[i];
    } else {
      S rp[3];
      qrot(jq[par], pl, rp);
      for (int i = 0; i < 3; ++i) jp[j][i] = jp[par][i] + rp[i];
      qmul(jq[par], qlo, jq[j]);
    }
  }
}

template <class S, class T>
__device__ void fk_bodies(const Scene<T>& sc, S (*jp)[3],
                          S (*jq)[4], S (*bp)[3], S (*bq)[4]) {
#pragma unroll 1
  for (int b = 0; b < sc.NB; ++b) {
    const int j = sc.body_joint[b];
    S r[3];
    qrot(jq[j], sc.bpos + 3 * b, r);
    for (int i = 0; i < 3; ++i) bp[b][i] = jp[j][i] + r[i];
    qmul(jq[j], sc.bquat + 4 * b, bq[b]);
  }
}

// -- dynamics (sim/lanes.lagrangian, el_terms, momentum) ---------------------
// L(q, v) per lane; body velocities are the JVP of FK along v (Dual<D>).
template <class D, class T>
__device__ __noinline__ D lagrangian(const Scene<T>& sc, const D* q,
                                     const D* v) {
  using E = Dual<D>;
  E qe[kMaxN];
  for (int i = 0; i < sc.n; ++i) qe[i] = E{q[i], v[i]};
  E jp[kMaxJ][3], jq[kMaxJ][4];
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

// (dL/dq, dL/dv) by 2n sweeps; dLdq may be null (momentum only)
template <class S, class T>
__device__ void el_pair(const Scene<T>& sc, const S* q, const S* v, S* dLdq,
                        S* p) {
  using D = Dual<S>;
  const int n = sc.n;
  D qd[kMaxN], vd[kMaxN];
  for (int i = 0; i < n; ++i) {
    qd[i] = D{q[i], cst<S>(T(0))};
    vd[i] = D{v[i], cst<S>(T(0))};
  }
  if (dLdq != nullptr) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      qd[i].d = cst<S>(T(1));
      dLdq[i] = lagrangian(sc, qd, vd).d;
      qd[i].d = cst<S>(T(0));
    }
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    vd[i].d = cst<S>(T(1));
    p[i] = lagrangian(sc, qd, vd).d;
    vd[i].d = cst<S>(T(0));
  }
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

// -- contact wrenches (K1's law per point; -f and -x x f on the primitive) ----
template <class S, class T>
__device__ __noinline__ void contact_wrenches(
    const Scene<T>& sc, S (*jp)[3], S (*jq)[4], S (*bp)[3],
    S (*bq)[4], S (*om)[3], S (*be)[3], S (*F)[3],
    S (*Tau)[3]) {
  const S zero = cst<S>(T(0));
  for (int j = 0; j < sc.J; ++j)
    for (int i = 0; i < 3; ++i) F[j][i] = Tau[j][i] = zero;
#pragma unroll 1
  for (int s = 0; s < sc.S; ++s) {
    const int* sg = sc.seg + kSegCols * s;
    const int row0 = sg[0], np = sg[1], j = sg[2], pb = sg[3], pj = sg[4];
    const int gt = sg[5];
    const T* prm = sc.params + 4 * sg[6];
    S R[3][3], cc[3];
    const T* sz = sc.bsize;
    if (gt != kGround) {
      quat_to_mat(bq[pb], R);
      for (int i = 0; i < 3; ++i) cc[i] = bp[pb][i];
      sz = sc.bsize + 3 * pb;
    } else {
      for (int a = 0; a < 3; ++a)
        for (int i = 0; i < 3; ++i) R[a][i] = zero;
      for (int i = 0; i < 3; ++i) cc[i] = zero;
    }
    S fs[3] = {zero, zero, zero}, ts[3] = {zero, zero, zero};
#pragma unroll 1
    for (int k = 0; k < np; ++k) {
      S x[3], vr[3], ox[3], phi, nrm[3], f[3], xf[3];
      point_world(jp[j], jq[j], sc.xi + 3 * (row0 + k), x);
      cross3(om[j], x, ox);
      for (int i = 0; i < 3; ++i) vr[i] = ox[i] + be[j][i];
      if (gt != kGround) {
        S op[3];
        cross3(om[pj], x, op);
        for (int i = 0; i < 3; ++i) vr[i] = vr[i] - (op[i] + be[pj][i]);
      }
      sdf_normal(gt, x, R, cc, sz, sc.gpos, sc.gn, phi, nrm);
      penalty_force(phi, nrm, vr, prm[0], prm[1], prm[2], prm[3], f);
      cross3(x, f, xf);
      for (int i = 0; i < 3; ++i) {
        fs[i] = fs[i] + f[i];
        ts[i] = ts[i] + xf[i];
      }
    }
    for (int i = 0; i < 3; ++i) {
      F[j][i] = F[j][i] + fs[i];
      Tau[j][i] = Tau[j][i] + ts[i];
      if (gt != kGround) {
        F[pj][i] = F[pj][i] - fs[i];
        Tau[pj][i] = Tau[pj][i] - ts[i];
      }
    }
  }
}

// -- the residual (sim/lanes.make_residual) ----------------------------------
// r = p(qn, v) - p_base - h (dL/dq(qn, v) + Q(qn, v, u))
template <class S, class T>
__device__ __noinline__ void residual(const Scene<T>& sc, const S* qn,
                                      const S* v, const T* u,
                                      const T* pbase, S* r) {
  const int n = sc.n;
  S dLdq[kMaxN], p[kMaxN];
  el_pair(sc, qn, v, dLdq, p);
  S jp[kMaxJ][3], jq[kMaxJ][4], bp[kMaxNB][3], bq[kMaxNB][4];
  fk_joints(sc, qn, jp, jq);
  fk_bodies(sc, jp, jq, bp, bq);
  S w[kMaxN][3], c[kMaxN][3], om[kMaxJ][3], be[kMaxJ][3];
  dof_frames(sc, qn, jp, jq, w, c);
  joint_twists(sc, w, c, v, om, be);
  S F[kMaxJ][3], Tau[kMaxJ][3];
  contact_wrenches(sc, jp, jq, bp, bq, om, be, F, Tau);
  S Q[kMaxN];
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
    S u3[3];
    cross3(w[k], c[k], u3);
    S acc = cst<S>(T(0));
    for (int j = 0; j < sc.J; ++j) {
      if (!sc.anc[k * sc.J + j]) continue;
      const S wF = w[k][0] * F[j][0] + w[k][1] * F[j][1] + w[k][2] * F[j][2];
      if (rot) {
        const S wT =
            w[k][0] * Tau[j][0] + w[k][1] * Tau[j][1] + w[k][2] * Tau[j][2];
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

// -- per-lane dense linear algebra (sim/lanes.gauss_factor, gauss_solve,
//    _ridge) ---------------------------------------------------------------------
template <class T>
__device__ T ridge_eps();
template <>
__device__ float ridge_eps<float>() { return 1e-7f; }
template <>
__device__ double ridge_eps<double>() { return 1e-12; }

template <class T>
__device__ void ridge_factor(T (*A)[kMaxN], int n) {
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

template <class T>
__device__ void lu_solve(T (*lu)[kMaxN], int n, const T* b, T* x) {
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

// columns of the residual's Jacobians at (qn = q_base + h v, v): for each k,
// J[:, k] (direction qn: h e_k, v: e_k) and, if Cq, dr/dqn[:, k]
template <class T>
__device__ void residual_columns(const Scene<T>& sc, const T* q_base,
                                 const T* v, const T* u, const T* pbase,
                                 T (*J)[kMaxN], T (*Cq)[kMaxN]) {
  using D = Dual<T>;
  const int n = sc.n;
  D qn[kMaxN], vv[kMaxN], r[kMaxN];
  for (int i = 0; i < n; ++i) {
    qn[i] = D{q_base[i] + sc.h * v[i], T(0)};
    vv[i] = D{v[i], T(0)};
  }
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    qn[k].d = sc.h;
    vv[k].d = T(1);
    residual(sc, qn, vv, u, pbase, r);
    for (int i = 0; i < n; ++i) J[i][k] = r[i].d;
    vv[k].d = T(0);
    if (Cq != nullptr) {
      qn[k].d = T(1);
      residual(sc, qn, vv, u, pbase, r);
      for (int i = 0; i < n; ++i) Cq[i][k] = r[i].d;
    }
    qn[k].d = T(0);
  }
}

// chord iteration with a given factor, best iterate kept (sim/lanes._chord).
// A lane whose residual norm is at or below tol_eff is frozen: its iterate
// and residual never change again, so the sweeps that the plain version
// still runs are skipped. Returns the residual evaluations made.
template <class T>
__device__ int chord(const Scene<T>& sc, T (*lu)[kMaxN], const T* q_base,
                     const T* pbase, const T* u, const T* v0, int max_iter,
                     T tol, T* v_best) {
  const int n = sc.n;
  const T rel = sizeof(T) == 4 ? T(1e-4) : T(1e-7);
  T qn[kMaxN], v[kMaxN], r[kMaxN], dv[kMaxN];
  for (int i = 0; i < n; ++i) {
    v[i] = v_best[i] = v0[i];
    qn[i] = q_base[i] + sc.h * v[i];
  }
  residual(sc, qn, v, u, pbase, r);
  int evals = 1;
  T rn = norm(r, n);
  T rn_best = rn;
  const T tol_eff = smax2(rel * rn, tol);
#pragma unroll 1
  for (int it = 0; it < max_iter; ++it) {
    if (rn <= tol_eff) break;
    lu_solve(lu, n, r, dv);
    for (int i = 0; i < n; ++i) {
      v[i] = v[i] - dv[i];
      qn[i] = q_base[i] + sc.h * v[i];
    }
    residual(sc, qn, v, u, pbase, r);
    ++evals;
    rn = norm(r, n);
    if (rn < rn_best) {
      rn_best = rn;
      for (int i = 0; i < n; ++i) v_best[i] = v[i];
    }
  }
  return evals;
}

template <class T>
__device__ void momentum(const Scene<T>& sc, const T* q, const T* qd, T* p) {
  el_pair(sc, q, qd, static_cast<T*>(nullptr), p);
}

// -- K2 ---------------------------------------------------------------------
template <class T>
__global__ void __launch_bounds__(kBlock)
fwd_kernel(const int* __restrict__ itab, const T* __restrict__ ftab, int K,
           int max_iter, T tol, const T* __restrict__ q0,
           const T* __restrict__ qd0, const T* __restrict__ u0, int B,
           T* __restrict__ qo, T* __restrict__ qdo, T* __restrict__ vs,
           int* __restrict__ nres) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Scene<T> sc = load_scene(itab, ftab);
  const int n = sc.n;
  T q[kMaxN], qd[kMaxN], u[kMaxU], pb[kMaxN], v[kMaxN];
  for (int i = 0; i < n; ++i) {
    q[i] = q0[i * B + b];
    qd[i] = qd0[i * B + b];
  }
  for (int i = 0; i < sc.nu; ++i) u[i] = u0[i * B + b];
  // ONE chord factor per env step, at the entry state
  T lu[kMaxN][kMaxN];
  momentum(sc, q, qd, pb);
  residual_columns(sc, q, qd, u, pb, lu, static_cast<T(*)[kMaxN]>(nullptr));
  ridge_factor(lu, n);
  int evals = 0;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    momentum(sc, q, qd, pb);
    evals += chord(sc, lu, q, pb, u, qd, max_iter, tol, v);
    for (int i = 0; i < n; ++i) {
      vs[(k * n + i) * B + b] = v[i];
      q[i] = q[i] + sc.h * v[i];
      qd[i] = v[i];
    }
  }
  for (int i = 0; i < n; ++i) {
    qo[i * B + b] = q[i];
    qdo[i * B + b] = qd[i];
  }
  nres[b] = evals;
}

// -- K3 ---------------------------------------------------------------------
template <class T>
__global__ void __launch_bounds__(kBlock)
bwd_kernel(const int* __restrict__ itab, const T* __restrict__ ftab, int K,
           const T* __restrict__ q0, const T* __restrict__ qd0,
           const T* __restrict__ u0, const T* __restrict__ vs,
           const T* __restrict__ gq, const T* __restrict__ gqd,
           const T* __restrict__ gqp, const T* __restrict__ gqdp, int B,
           T* __restrict__ gq0, T* __restrict__ gqd0, T* __restrict__ gu0) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Scene<T> sc = load_scene(itab, ftab);
  const int n = sc.n, nu = sc.nu;
  const T h = sc.h;
  T u[kMaxU], g_q[kMaxN], g_v[kMaxN], g_u[kMaxU];
  for (int i = 0; i < nu; ++i) {
    u[i] = u0[i * B + b];
    g_u[i] = T(0);
  }
  for (int i = 0; i < n; ++i) {
    g_q[i] = gq[i * B + b];
    g_v[i] = gqd[i * B + b];
  }
#pragma unroll 1
  for (int k = K - 1; k >= 0; --k) {
    // the substep's entry state (q_k, qd_k), rebuilt from q0 and vs
    T qk[kMaxN], qdk[kMaxN], vst[kMaxN];
    for (int i = 0; i < n; ++i) {
      qk[i] = q0[i * B + b];
      qdk[i] = qd0[i * B + b];
    }
    for (int s = 0; s < k; ++s)
      for (int i = 0; i < n; ++i) {
        const T vi = vs[(s * n + i) * B + b];
        qk[i] = qk[i] + h * vi;
        qdk[i] = vi;
      }
    for (int i = 0; i < n; ++i) vst[i] = vs[(k * n + i) * B + b];
    T gvs[kMaxN], pb[kMaxN];
    for (int i = 0; i < n; ++i) gvs[i] = g_v[i] + h * g_q[i];
    momentum(sc, qk, qdk, pb);
    // exact J at v*, and dr/dq_base
    T Jm[kMaxN][kMaxN], Cq[kMaxN][kMaxN], JT[kMaxN][kMaxN];
    residual_columns(sc, qk, vst, u, pb, Jm, Cq);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) JT[i][j] = Jm[j][i];
    ridge_factor(JT, n);
    T lam[kMaxN];
    lu_solve(JT, n, gvs, lam);
    // pull -lambda back: q_base through dr/dqn, p_base (dr/dp_base = -I),
    // u through the motor rows
    T bq[kMaxN];
    for (int j = 0; j < n; ++j) {
      T acc = T(0);
      for (int i = 0; i < n; ++i) acc = acc + Cq[i][j] * lam[i];
      bq[j] = -acc;
    }
    for (int m = 0; m < nu; ++m) {
      const Dual<T> uc =
          smin2(smax2(Dual<T>{u[m], T(1)}, sc.ulo[m]), sc.uhi[m]);
      const T dQdu = (sc.umask[m] * sc.kp[m] + (T(1) - sc.umask[m])) * uc.d;
      g_u[m] = g_u[m] + h * dQdu * lam[sc.motor_dof[m]];
    }
    // p_base = momentum(q_k, qd_k): its pullback of lambda, by columns
    T mq[kMaxN], mv[kMaxN];
    {
      using D = Dual<T>;
      D qq[kMaxN], vv[kMaxN], pp[kMaxN];
      for (int i = 0; i < n; ++i) {
        qq[i] = D{qk[i], T(0)};
        vv[i] = D{qdk[i], T(0)};
      }
#pragma unroll 1
      for (int c = 0; c < n; ++c) {
        qq[c].d = T(1);
        el_pair(sc, qq, vv, static_cast<D*>(nullptr), pp);
        T acc = T(0);
        for (int i = 0; i < n; ++i) acc = acc + lam[i] * pp[i].d;
        mq[c] = acc;
        qq[c].d = T(0);
        vv[c].d = T(1);
        el_pair(sc, qq, vv, static_cast<D*>(nullptr), pp);
        acc = T(0);
        for (int i = 0; i < n; ++i) acc = acc + lam[i] * pp[i].d;
        mv[c] = acc;
        vv[c].d = T(0);
      }
    }
    for (int i = 0; i < n; ++i) {
      g_q[i] = g_q[i] + bq[i] + mq[i];
      g_v[i] = mv[i];
      if (k == K - 1) {   // q_prev = q_{K-1}, qdot_prev = qd_{K-1}
        g_q[i] = g_q[i] + gqp[i * B + b];
        g_v[i] = g_v[i] + gqdp[i * B + b];
      }
    }
  }
  for (int i = 0; i < n; ++i) {
    gq0[i * B + b] = g_q[i];
    gqd0[i * B + b] = g_v[i];
  }
  for (int i = 0; i < nu; ++i) gu0[i * B + b] = g_u[i];
}

}  // namespace

// Everything above is device code that also compiles as host C++ (with
// stand-ins for the CUDA qualifiers): megastep_host.py builds it so to
// run it against the plain version on a CPU and to count its arithmetic.
// The launches below need nvcc.
#ifdef __CUDACC__
namespace {

// Local memory: the nested duals need a deep per-thread stack; raise the
// device's stack limit to the kernel's frame once.
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

template <class T>
int launch_fwd(const int* itab, const T* ftab, int K, int max_iter, T tol,
               const T* q0, const T* qd0, const T* u, int B, T* qo, T* qdo,
               T* vs, int* nres, void* stream) {
  cudaError_t err = fit_stack(fwd_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlock), grid((B + kBlock - 1) / kBlock);
  fwd_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      itab, ftab, K, max_iter, tol, q0, qd0, u, B, qo, qdo, vs, nres);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_bwd(const int* itab, const T* ftab, int K, const T* q0,
               const T* qd0, const T* u, const T* vs, const T* gq,
               const T* gqd, const T* gqp, const T* gqdp, int B, T* gq0,
               T* gqd0, T* gu, void* stream) {
  cudaError_t err = fit_stack(bwd_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlock), grid((B + kBlock - 1) / kBlock);
  bwd_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      itab, ftab, K, q0, qd0, u, vs, gq, gqd, gqp, gqdp, B, gq0, gqd0, gu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 = launched).
extern "C" int megastep_limits(int* out) {
  out[0] = kMaxN; out[1] = kMaxJ; out[2] = kMaxNB; out[3] = kMaxU;
  out[4] = kBlock;
  return 0;
}

extern "C" int megastep_fwd_f32(const int* itab, const float* ftab, int K,
                                int max_iter, float tol, const float* q0,
                                const float* qd0, const float* u, int B,
                                float* qo, float* qdo, float* vs, int* nres,
                                void* stream) {
  return launch_fwd<float>(itab, ftab, K, max_iter, tol, q0, qd0, u, B, qo,
                           qdo, vs, nres, stream);
}

extern "C" int megastep_fwd_f64(const int* itab, const double* ftab, int K,
                                int max_iter, double tol, const double* q0,
                                const double* qd0, const double* u, int B,
                                double* qo, double* qdo, double* vs,
                                int* nres, void* stream) {
  return launch_fwd<double>(itab, ftab, K, max_iter, tol, q0, qd0, u, B, qo,
                            qdo, vs, nres, stream);
}

extern "C" int megastep_bwd_f32(const int* itab, const float* ftab, int K,
                                const float* q0, const float* qd0,
                                const float* u, const float* vs,
                                const float* gq, const float* gqd,
                                const float* gqp, const float* gqdp, int B,
                                float* gq0, float* gqd0, float* gu,
                                void* stream) {
  return launch_bwd<float>(itab, ftab, K, q0, qd0, u, vs, gq, gqd, gqp, gqdp,
                           B, gq0, gqd0, gu, stream);
}

extern "C" int megastep_bwd_f64(const int* itab, const double* ftab, int K,
                                const double* q0, const double* qd0,
                                const double* u, const double* vs,
                                const double* gq, const double* gqd,
                                const double* gqp, const double* gqdp, int B,
                                double* gq0, double* gqd0, double* gu,
                                void* stream) {
  return launch_bwd<double>(itab, ftab, K, q0, qd0, u, vs, gq, gqd, gqp,
                            gqdp, B, gq0, gqd0, gu, stream);
}
#endif  // __CUDACC__
