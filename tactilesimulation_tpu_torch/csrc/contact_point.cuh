// The per-point contact law, shared by K1 (lane_contact.cu, float) and by
// K2/K3 (megastep.cu, float or double, plain or dual): point position from
// its owner joint's frame, signed distance and normal against the ground or
// a primitive body (cuboid, cylinder, sphere), and the penalty force of
// sim/contact.py. Templated on the scalar S (float, double or a dual of
// them, dual.cuh) and its base type P; every non-smooth step follows the
// plain PyTorch version's tie rules (dual.cuh), so a dual S gives the
// derivative autograd gives there.
#pragma once

#include "dual.cuh"

namespace tsim {

constexpr int kGround = -1;    // sim/contact.py GROUND
constexpr int kCuboid = 0;     // model/schema.py GEOM_CUBOID
constexpr int kCylinder = 1;   // GEOM_CYLINDER
constexpr int kSphere = 2;     // GEOM_SPHERE
constexpr double kContactEps = 1e-9;   // sim/contact.py _EPS

// x = p + xi + w t + qv x t,  t = 2 qv x xi  (quat_rotate of the local
// point xi by the owner joint's quaternion q = [w, qv], plus its origin p)
template <class S, class P>
__device__ __forceinline__ void point_world(const S p[3], const S q[4],
                                            const P xi[3], S x[3]) {
  const S tx = P(2) * (q[2] * xi[2] - q[3] * xi[1]);
  const S ty = P(2) * (q[3] * xi[0] - q[1] * xi[2]);
  const S tz = P(2) * (q[1] * xi[1] - q[2] * xi[0]);
  x[0] = p[0] + xi[0] + q[0] * tx + (q[2] * tz - q[3] * ty);
  x[1] = p[1] + xi[1] + q[0] * ty + (q[3] * tx - q[1] * tz);
  x[2] = p[2] + xi[2] + q[0] * tz + (q[1] * ty - q[2] * tx);
}

// world-from-local rotation matrix of a quaternion [w, x, y, z]
template <class S>
__device__ __forceinline__ void quat_to_mat(const S q[4], S R[3][3]) {
  using P = base_t<S>;
  const S xx = q[1] * q[1], yy = q[2] * q[2], zz = q[3] * q[3];
  const S wx = q[0] * q[1], wy = q[0] * q[2], wz = q[0] * q[3];
  const S xy = q[1] * q[2], xz = q[1] * q[3], yz = q[2] * q[3];
  R[0][0] = P(1) - P(2) * (yy + zz);
  R[0][1] = P(2) * (xy - wz);
  R[0][2] = P(2) * (xz + wy);
  R[1][0] = P(2) * (xy + wz);
  R[1][1] = P(1) - P(2) * (xx + zz);
  R[1][2] = P(2) * (yz - wx);
  R[2][0] = P(2) * (xz - wy);
  R[2][1] = P(2) * (yz + wx);
  R[2][2] = P(1) - P(2) * (xx + yy);
}

// Signed distance phi and world normal n of the world point x against the
// ground half-space (gpos, gn) or a primitive of type gt with rotation R,
// origin c and size s (cuboid: edge lengths; cylinder: radius, half
// length; sphere: radius).
template <class S, class P>
__device__ __forceinline__ void sdf_normal(int gt, const S x[3],
                                           S R[3][3], const S c[3],
                                           const P s[3], const P gpos[3],
                                           const P gn[3], S& phi, S n[3]) {
  const P eps2 = P(kContactEps * kContactEps);
  if (gt == kGround) {
    phi = (x[0] - gpos[0]) * gn[0] + (x[1] - gpos[1]) * gn[1] +
          (x[2] - gpos[2]) * gn[2];
    for (int i = 0; i < 3; ++i) n[i] = cst<S>(gn[i]);
    return;
  }
  const S d0 = x[0] - c[0], d1 = x[1] - c[1], d2 = x[2] - c[2];
  S xl[3];
  for (int i = 0; i < 3; ++i) xl[i] = R[0][i] * d0 + R[1][i] * d1 + R[2][i] * d2;
  S gl[3];
  if (gt == kCuboid) {
    const S dd[3] = {sabs(xl[0]) - P(0.5) * s[0], sabs(xl[1]) - P(0.5) * s[1],
                     sabs(xl[2]) - P(0.5) * s[2]};
    const S dmax = max3_even(dd[0], dd[1], dd[2]);
    const S o[3] = {smax2(dd[0], P(0)), smax2(dd[1], P(0)),
                    smax2(dd[2], P(0))};
    const S onorm = ssqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + eps2);
    const bool out = pv(dmax) > P(0);
    phi = out ? onorm : dmax;
    const P hit[3] = {P(pv(dd[0]) == pv(dmax)), P(pv(dd[1]) == pv(dmax)),
                      P(pv(dd[2]) == pv(dmax))};
    const P hs = hit[0] + hit[1] + hit[2];
    for (int i = 0; i < 3; ++i)
      gl[i] = (out ? o[i] / onorm : cst<S>(hit[i] / hs)) * ssgn(xl[i]);
  } else if (gt == kCylinder) {
    const S r2 = ssqrt(xl[0] * xl[0] + xl[1] * xl[1] + eps2);
    const S dr = r2 - s[0];
    const S dz = sabs(xl[2]) - s[1];
    const S dmax = smax2(dr, dz);
    const S o_r = smax2(dr, P(0)), o_z = smax2(dz, P(0));
    const S onorm = ssqrt(o_r * o_r + o_z * o_z + eps2);
    const bool out = pv(dmax) > P(0);
    phi = out ? onorm : dmax;
    const P pick_r = P(pv(dr) >= pv(dz));
    const S c_r = out ? o_r / onorm : cst<S>(pick_r);
    const S c_z = out ? o_z / onorm : cst<S>(P(1) - pick_r);
    gl[0] = c_r * xl[0] / r2;
    gl[1] = c_r * xl[1] / r2;
    gl[2] = c_z * ssgn(xl[2]);
  } else {  // kSphere
    const S r = ssqrt(xl[0] * xl[0] + xl[1] * xl[1] + xl[2] * xl[2] + eps2);
    phi = r - s[0];
    for (int i = 0; i < 3; ++i) gl[i] = xl[i] / r;
  }
  for (int i = 0; i < 3; ++i)
    n[i] = R[i][0] * gl[0] + R[i][1] * gl[1] + R[i][2] * gl[2];
}

// penalty force on the general side: normal spring-damper plus regularised
// Coulomb friction (sim/contact.py):
//   f = (kn p + d p max(0, -vn)) n - kt s v_t,
//   s = mu f_n / max(mu f_n, kt |v_t| + eps),   p = max(-phi, 0)
template <class S, class P>
__device__ __forceinline__ void penalty_force(const S& phi, const S n[3],
                                              const S vr[3], P kn, P kt, P mu,
                                              P dmp, S f[3]) {
  const S pen = smax2(-phi, P(0));
  const S vn = vr[0] * n[0] + vr[1] * n[1] + vr[2] * n[2];
  const S pdot = smax2(-vn, P(0));
  const S fn = kn * pen + dmp * pen * pdot;
  const S vt0 = vr[0] - vn * n[0], vt1 = vr[1] - vn * n[1],
          vt2 = vr[2] - vn * n[2];
  const S vtn =
      ssqrt(vt0 * vt0 + vt1 * vt1 + vt2 * vt2 + P(kContactEps * kContactEps));
  const S cap = mu * fn;
  const S ks = kt * (cap / smax2(cap, kt * vtn + P(kContactEps)));
  f[0] = fn * n[0] - ks * vt0;
  f[1] = fn * n[1] - ks * vt1;
  f[2] = fn * n[2] - ks * vt2;
}

}  // namespace tsim
