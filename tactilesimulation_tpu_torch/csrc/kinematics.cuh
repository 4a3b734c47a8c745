// Quaternion algebra and forward kinematics on the card, shared by K2/K3
// (megastep.cu) and the tactile read (dense_contact.cu). Templated on the
// scalar S (float, double or a dual of them, dual.cuh) and on the scene
// table Sc<T> the caller keeps its joint and body constants in: any struct
// with the fields fk_local, fk_joints and fk_bodies read (n, J, NB, jparent,
// trans_idx, rot_idx, mflags, basis, jaxis, jpos, jquat, body_joint, bpos,
// bquat; layouts as in megastep.cu's Scene). Joints come in an order where
// a parent precedes its children (model/builder.py builds them so).
#pragma once

#include "dual.cuh"

namespace tsim {

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
// joint j's frame in its parent's: (pl, ql)
template <class S, template <class> class Sc, class T>
__device__ __forceinline__ void fk_local(const Sc<T>& sc, const S* q, int j,
                                         S pl[3], S qlo[4]) {
  const int n = sc.n;
  const S zero = cst<S>(T(0));
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
  S rt[3];
  qrot(jqc, tl, rt);
  for (int i = 0; i < 3; ++i) pl[i] = jpc[i] + rt[i];
  qmul(jqc, ql, qlo);
}

// a joint's world frame (p, qo) from its parent's (pp, pq) and its own
// local frame (pl, qlo)
template <class S>
__device__ __forceinline__ void fk_attach(const S pp[3], const S pq[4],
                                          const S pl[3], const S qlo[4],
                                          S p[3], S qo[4]) {
  S rp[3];
  qrot(pq, pl, rp);
  for (int i = 0; i < 3; ++i) p[i] = pp[i] + rp[i];
  qmul(pq, qlo, qo);
}

template <class S, template <class> class Sc, class T>
__device__ void fk_joints(const Sc<T>& sc, const S* q, S (*jp)[3],
                          S (*jq)[4]) {
#pragma unroll 1
  for (int j = 0; j < sc.J; ++j) {
    S pl[3], qlo[4];
    fk_local(sc, q, j, pl, qlo);
    const int par = sc.jparent[j];
    if (par < 0) {
      for (int i = 0; i < 3; ++i) jp[j][i] = pl[i];
      for (int i = 0; i < 4; ++i) jq[j][i] = qlo[i];
    } else {
      fk_attach(jp[par], jq[par], pl, qlo, jp[j], jq[j]);
    }
  }
}

template <class S, template <class> class Sc, class T>
__device__ void fk_bodies(const Sc<T>& sc, S (*jp)[3],
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

}  // namespace tsim
