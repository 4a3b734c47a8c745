// The per-point contact law, shared by K1 (lane_contact.cu, float) and by
// K2/K3 (megastep.cu, float or double, plain or dual): point position from
// its owner joint's frame, signed distance and normal against the ground or
// a primitive body (cuboid, cylinder, sphere), and the penalty force of
// sim/contact.py. Templated on the scalar S (float, double or a dual of
// them, dual.cuh) and its base type P; every non-smooth step follows the
// plain PyTorch version's tie rules (dual.cuh), so a dual S gives the
// derivative autograd gives there.
//
// The second half is the reverse of that law for one point, written by hand
// on a plain scalar S (float, double, or megastep_host.py's counting
// scalar): each *_vjp takes the point's primal inputs and the cotangents of
// its outputs, recomputes the primal it needs, and adds the inputs'
// cotangents. At every kink it takes the derivative that autograd takes
// through the plain version (sim/lanes.py): torch.maximum splits the
// gradient at a tie (relu at 0 too), abs and sign have slope sign(x) and 0,
// amax splits it evenly over tied axes, a `where` passes it to the chosen
// branch only, and eps = 1e-9 smooths every norm.
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

// -- the reverse of the law, for one point on a plain scalar ----------------

// slope of torch.maximum(a, b) in a: 1 above, 1/2 at a tie, 0 below
template <class S>
__device__ __forceinline__ S max_slope(const S& a, const S& b) {
  return a > b ? S(1) : (a < b ? S(0) : S(0.5));
}

// the world-from-local matrix of a quaternion is the polynomial that
// quat_rotate applies, so a rotation's cotangent reaches q through this
// one reverse: qb += (dR/dq)^T Rb
template <class S>
__device__ __forceinline__ void quat_to_mat_vjp(const S q[4],
                                                const S Rb[3][3], S qb[4]) {
  const S w = q[0], x = q[1], y = q[2], z = q[3];
  qb[0] += S(2) * (z * (Rb[1][0] - Rb[0][1]) + y * (Rb[0][2] - Rb[2][0]) +
                   x * (Rb[2][1] - Rb[1][2]));
  qb[1] += S(2) * (y * (Rb[0][1] + Rb[1][0]) + z * (Rb[0][2] + Rb[2][0]) +
                   w * (Rb[2][1] - Rb[1][2]) -
                   S(2) * x * (Rb[1][1] + Rb[2][2]));
  qb[2] += S(2) * (x * (Rb[0][1] + Rb[1][0]) + z * (Rb[1][2] + Rb[2][1]) +
                   w * (Rb[0][2] - Rb[2][0]) -
                   S(2) * y * (Rb[0][0] + Rb[2][2]));
  qb[3] += S(2) * (x * (Rb[0][2] + Rb[2][0]) + y * (Rb[1][2] + Rb[2][1]) +
                   w * (Rb[1][0] - Rb[0][1]) -
                   S(2) * z * (Rb[0][0] + Rb[1][1]));
}

// x = p + M xi with M = quat_to_mat(q): the point's cotangent xb goes to
// p (pb += xb), to M (Mb += xb xi^T; quat_to_mat_vjp takes it on to q)
// and to the local point (xib = M^T xb; xib may be null, not asked for)
template <class S>
__device__ __forceinline__ void point_world_vjp(const S M[3][3],
                                                const S xi[3], const S xb[3],
                                                S pb[3], S Mb[3][3],
                                                S xib[3]) {
  for (int i = 0; i < 3; ++i) {
    pb[i] += xb[i];
    for (int k = 0; k < 3; ++k) Mb[i][k] += xb[i] * xi[k];
  }
  if (xib)
    for (int k = 0; k < 3; ++k)
      xib[k] = M[0][k] * xb[0] + M[1][k] * xb[1] + M[2][k] * xb[2];
}

// Reverse of sdf_normal: from (phib, nb) add the cotangents of the world
// point (xb), the primitive's rotation (Rb) and origin (cb), its size (sb),
// and the ground's point and normal (gposb, gnb); sb, gposb and gnb may be
// null (not asked for), and their work is then skipped.
template <class S>
__device__ __forceinline__ void sdf_normal_vjp(
    int gt, const S x[3], const S R[3][3], const S c[3], const S s[3],
    const S gpos[3], const S gn[3], const S& phib, const S nb[3], S xb[3],
    S Rb[3][3], S cb[3], S sb[3], S gposb[3], S gnb[3]) {
  const S eps2 = S(kContactEps * kContactEps);
  if (gt == kGround) {
    for (int i = 0; i < 3; ++i) {
      xb[i] += phib * gn[i];
      if (gposb) gposb[i] -= phib * gn[i];
      if (gnb) gnb[i] += phib * (x[i] - gpos[i]) + nb[i];
    }
    return;
  }
  const S d[3] = {x[0] - c[0], x[1] - c[1], x[2] - c[2]};
  S xl[3];
  for (int i = 0; i < 3; ++i) xl[i] = R[0][i] * d[0] + R[1][i] * d[1] + R[2][i] * d[2];
  S gl[3], xlb[3] = {S(0), S(0), S(0)};
  // the local normal's cotangent, once gl is known (n = R gl)
  auto normal_back = [&](S glb[3]) {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Rb[i][j] += nb[i] * gl[j];
    for (int j = 0; j < 3; ++j)
      glb[j] = R[0][j] * nb[0] + R[1][j] * nb[1] + R[2][j] * nb[2];
  };
  S glb[3];
  if (gt == kCuboid) {
    const S sg[3] = {S(ssgn(xl[0])), S(ssgn(xl[1])), S(ssgn(xl[2]))};
    const S dd[3] = {sabs(xl[0]) - S(0.5) * s[0], sabs(xl[1]) - S(0.5) * s[1],
                     sabs(xl[2]) - S(0.5) * s[2]};
    S dmax = dd[0] > dd[1] ? dd[0] : dd[1];
    dmax = dmax > dd[2] ? dmax : dd[2];
    const S o[3] = {smax2(dd[0], S(0)), smax2(dd[1], S(0)),
                    smax2(dd[2], S(0))};
    const S onorm = ssqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + eps2);
    const bool out = dmax > S(0);
    S ddb[3];
    if (out) {
      for (int i = 0; i < 3; ++i) gl[i] = o[i] / onorm * sg[i];
      normal_back(glb);
      S ob[3], onormb = phib;
      for (int i = 0; i < 3; ++i) {
        ob[i] = glb[i] * sg[i] / onorm;
        onormb = onormb - ob[i] * o[i] / onorm;
      }
      for (int i = 0; i < 3; ++i)
        ddb[i] = (ob[i] + onormb * o[i] / onorm) * max_slope(dd[i], S(0));
    } else {
      const S hit[3] = {S(dd[0] == dmax), S(dd[1] == dmax),
                        S(dd[2] == dmax)};
      const S hs = hit[0] + hit[1] + hit[2];
      for (int i = 0; i < 3; ++i) gl[i] = hit[i] / hs * sg[i];
      normal_back(glb);   // g_in is piecewise constant: nothing to xl
      for (int i = 0; i < 3; ++i) ddb[i] = phib * hit[i] / hs;
    }
    for (int i = 0; i < 3; ++i) {
      xlb[i] += ddb[i] * sg[i];
      if (sb) sb[i] -= S(0.5) * ddb[i];
    }
  } else if (gt == kCylinder) {
    const S r2 = ssqrt(xl[0] * xl[0] + xl[1] * xl[1] + eps2);
    const S dr = r2 - s[0];
    const S sg2 = S(ssgn(xl[2]));
    const S dz = sabs(xl[2]) - s[1];
    const S dmax = smax2(dr, dz);
    const S o_r = smax2(dr, S(0)), o_z = smax2(dz, S(0));
    const S onorm = ssqrt(o_r * o_r + o_z * o_z + eps2);
    const bool out = dmax > S(0);
    const S pick_r = S(dr >= dz);
    const S c_r = out ? o_r / onorm : pick_r;
    const S c_z = out ? o_z / onorm : S(1) - pick_r;
    gl[0] = c_r * xl[0] / r2;
    gl[1] = c_r * xl[1] / r2;
    gl[2] = c_z * sg2;
    normal_back(glb);
    const S c_rb = (glb[0] * xl[0] + glb[1] * xl[1]) / r2;
    const S c_zb = glb[2] * sg2;
    xlb[0] += glb[0] * c_r / r2;
    xlb[1] += glb[1] * c_r / r2;
    S r2b = -(c_rb * c_r / r2), drb, dzb;
    if (out) {
      const S onormb = phib - (c_rb * o_r + c_zb * o_z) / (onorm * onorm);
      drb = (c_rb / onorm + onormb * o_r / onorm) * max_slope(dr, S(0));
      dzb = (c_zb / onorm + onormb * o_z / onorm) * max_slope(dz, S(0));
    } else {
      const S sl = max_slope(dr, dz);
      drb = phib * sl;
      dzb = phib * (S(1) - sl);
    }
    r2b += drb;
    xlb[2] += dzb * sg2;
    if (sb) {
      sb[0] -= drb;
      sb[1] -= dzb;
    }
    xlb[0] += r2b * xl[0] / r2;
    xlb[1] += r2b * xl[1] / r2;
  } else {  // kSphere
    const S r = ssqrt(xl[0] * xl[0] + xl[1] * xl[1] + xl[2] * xl[2] + eps2);
    for (int i = 0; i < 3; ++i) gl[i] = xl[i] / r;
    normal_back(glb);
    const S rb =
        phib - (glb[0] * xl[0] + glb[1] * xl[1] + glb[2] * xl[2]) / (r * r);
    for (int i = 0; i < 3; ++i) xlb[i] += glb[i] / r + rb * xl[i] / r;
    if (sb) sb[0] -= phib;
  }
  // xl = R^T d, d = x - c
  for (int r = 0; r < 3; ++r) {
    S db = S(0);
    for (int i = 0; i < 3; ++i) {
      Rb[r][i] += d[r] * xlb[i];
      db += R[r][i] * xlb[i];
    }
    xb[r] += db;
    cb[r] -= db;
  }
}

// Reverse of penalty_force: from the force's cotangent fb, the cotangents
// of phi, the normal, the relative velocity and the parameters
// prmb = (kn, kt, mu, damping), all added; prmb may be null (not asked
// for), and its work is then skipped.
template <class S>
__device__ __forceinline__ void penalty_force_vjp(
    const S& phi, const S n[3], const S vr[3], const S& kn, const S& kt,
    const S& mu, const S& dmp, const S fb[3], S& phib, S nb[3], S vrb[3],
    S prmb[4]) {
  const S eps = S(kContactEps);
  const S pen = smax2(-phi, S(0));
  const S vn = vr[0] * n[0] + vr[1] * n[1] + vr[2] * n[2];
  const S pdot = smax2(-vn, S(0));
  const S fn = kn * pen + dmp * pen * pdot;
  const S vt[3] = {vr[0] - vn * n[0], vr[1] - vn * n[1], vr[2] - vn * n[2]};
  const S vtn = ssqrt(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2] +
                      eps * eps);
  const S cap = mu * fn;
  const S a = kt * vtn + eps;
  const S den = smax2(cap, a);
  const S sc = cap / den;
  const S ks = kt * sc;
  // f = fn n - ks vt
  S fnb = fb[0] * n[0] + fb[1] * n[1] + fb[2] * n[2];
  const S ksb = -(fb[0] * vt[0] + fb[1] * vt[1] + fb[2] * vt[2]);
  S vtb[3];
  for (int i = 0; i < 3; ++i) {
    nb[i] += fn * fb[i];
    vtb[i] = -(ks * fb[i]);
  }
  // ks = kt (cap / den), den = max(cap, kt vtn + eps)
  const S scb = kt * ksb;
  S capb = scb / den;
  const S denb = -(scb * sc / den);
  const S sl = max_slope(cap, a);
  capb += denb * sl;
  const S ab = denb * (S(1) - sl);
  const S vtnb = ab * kt;
  // cap = mu fn
  if (prmb) {
    prmb[1] += sc * ksb + ab * vtn;
    prmb[2] += capb * fn;
  }
  fnb += capb * mu;
  // vtn = sqrt(|vt|^2 + eps^2); vt = vr - vn n
  S vnb = S(0);
  for (int i = 0; i < 3; ++i) {
    vtb[i] += vtnb * vt[i] / vtn;
    vrb[i] += vtb[i];
    vnb -= vtb[i] * n[i];
    nb[i] -= vn * vtb[i];
  }
  // fn = kn pen + dmp pen pdot
  if (prmb) {
    prmb[0] += fnb * pen;
    prmb[3] += fnb * pen * pdot;
  }
  const S penb = fnb * (kn + dmp * pdot);
  const S pdotb = fnb * dmp * pen;
  vnb -= pdotb * max_slope(-vn, S(0));
  for (int i = 0; i < 3; ++i) {
    vrb[i] += vnb * n[i];
    nb[i] += vnb * vr[i];
  }
  phib -= penb * max_slope(-phi, S(0));
}

}  // namespace tsim
