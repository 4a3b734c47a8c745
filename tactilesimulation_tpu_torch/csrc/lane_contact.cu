// K1: fused lane-major contact pair-wrench kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// tactilesimulation_tpu/ops/lane_contact.py (launched by
// make_pair_wrenches.run_kernel). For every contact point and tactile marker
// of every segment (a run of points sharing owner joint, primitive and
// parameter row) it computes
//   world position      x = p_j + R(q_j) xi       (owner-joint frame)
//   point velocity      v = Omega_j x x + beta_j
//   SDF and normal      vs ground / cuboid / cylinder / sphere
//   relative velocity   v - (Omega_p x x + beta_p)  (primitive's joint)
//   penalty force       f = (kn p + d p max(0, -phidot)) n - kt s v_t,
//                       s = mu|f_n| / max(mu|f_n|, kt|v_t| + eps)
// and reduces the forces to per-joint wrenches F_j = sum f, T_j = sum x x f
// (opposite sign on the primitive's joint), plus dense tactile rows.
//
// Layout: every per-lane array is batch-last, (C, J|NB|ntac, B) row-major,
// so element (c, j, b) sits at (c * J + j) * B + b.
//
// Design: one thread per lane b; consecutive threads take consecutive lanes,
// so every (., J, B) load and every output store is coalesced. Each thread
// loops over all segments and their points in a fixed order and sums F and
// T of a segment in registers, then adds them to its own lane's outputs: no
// float atomics, and the result does not depend on the launch. The segment
// table and the points' local coordinates are small and read by all threads
// of a warp at the same address (broadcast through L1).
//
// What bounds it on an H100: per lane it reads the joint and body frames and
// twists (140 floats on TactilePush: J = 7, NB = 7) and writes F, T and the
// 130 tactile rows (432 floats): about 2.3 KB per lane, 2.3 MB at B = 1024,
// or 0.7 us at 3.35 TB/s. The arithmetic is about 150 flops per point, about
// 31 MFLOP at B = 1024 (0.5 us at 67 TFLOP/s fp32). Both are far below a
// launch's own latency (a few us), which dominates; and at B = 1024 one
// thread per lane fills only 8 blocks of 128 on 132 SMs, so the card is
// mostly idle. Spreading points over threads is later work.
//
// Contact parameters: element k of parameter row r for lane b is
// params[(r * 4 + k) * row_stride + b * lane_stride]. lane_stride 0
// (row_stride 1) reads one static (K, 4) table; lane_stride 1
// (row_stride B) reads per-lane (K, 4, B) parameters.

#include <cuda_runtime.h>

namespace {

constexpr int kGround = -1;    // sim/contact.py GROUND
constexpr int kCuboid = 0;     // model/schema.py GEOM_CUBOID
constexpr int kCylinder = 1;   // GEOM_CYLINDER
constexpr int kSphere = 2;     // GEOM_SPHERE
constexpr float kEps = 1e-9f;  // sim/contact.py _EPS
constexpr int kSegCols = 8;    // row0, n, joint, prim_body, prim_joint,
                               // gtype, param_row, tac0
constexpr int kBlock = 128;

__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

__global__ void __launch_bounds__(kBlock)
lane_contact_kernel(const float* __restrict__ jp, const float* __restrict__ jq,
                    const float* __restrict__ om, const float* __restrict__ be,
                    const float* __restrict__ bp, const float* __restrict__ bq,
                    const float* __restrict__ sizes,
                    const float* __restrict__ params, int row_stride,
                    int lane_stride, const float* __restrict__ gpos,
                    const float* __restrict__ gn, const float* __restrict__ xi,
                    const int* __restrict__ segs, int S, int J, int NB,
                    int ntac, int B, float* __restrict__ F,
                    float* __restrict__ T, float* __restrict__ tac) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  for (int k = 0; k < 3 * J; ++k) {
    F[k * B + b] = 0.f;
    T[k * B + b] = 0.f;
  }
  for (int k = 0; k < 3 * ntac; ++k) tac[k * B + b] = 0.f;
  const float g0 = gn[0], g1 = gn[1], g2 = gn[2];
  const float gdot = g0 * gpos[0] + g1 * gpos[1] + g2 * gpos[2];

  for (int s = 0; s < S; ++s) {
    const int* sg = segs + kSegCols * s;
    const int row0 = sg[0], n = sg[1], j = sg[2], pb = sg[3], pj = sg[4];
    const int gt = sg[5], pr = sg[6], t0 = sg[7];
#define LJ(a, c, jj) a[((c) * J + (jj)) * B + b]
    const float px = LJ(jp, 0, j), py = LJ(jp, 1, j), pz = LJ(jp, 2, j);
    const float qw = LJ(jq, 0, j), qx = LJ(jq, 1, j), qy = LJ(jq, 2, j),
                qz = LJ(jq, 3, j);
    const float ox = LJ(om, 0, j), oy = LJ(om, 1, j), oz = LJ(om, 2, j);
    const float bx = LJ(be, 0, j), by = LJ(be, 1, j), bz = LJ(be, 2, j);
    const float* prm = params + b * lane_stride;
    const float kn = prm[(pr * 4 + 0) * row_stride];
    const float kt = prm[(pr * 4 + 1) * row_stride];
    const float mu = prm[(pr * 4 + 2) * row_stride];
    const float dmp = prm[(pr * 4 + 3) * row_stride];

    // primitive frame: rotation R (world-from-local), origin c, twist
    float R[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
    float cx = 0.f, cy = 0.f, cz = 0.f;
    float pox = 0.f, poy = 0.f, poz = 0.f, pbx = 0.f, pby = 0.f, pbz = 0.f;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    if (gt != kGround) {
#define LB(a, c) a[((c) * NB + pb) * B + b]
      const float w = LB(bq, 0), x = LB(bq, 1), y = LB(bq, 2), z = LB(bq, 3);
      const float xx = x * x, yy = y * y, zz = z * z;
      const float wx = w * x, wy = w * y, wz = w * z;
      const float xy = x * y, xz = x * z, yz = y * z;
      R[0][0] = 1.f - 2.f * (yy + zz); R[0][1] = 2.f * (xy - wz);
      R[0][2] = 2.f * (xz + wy);
      R[1][0] = 2.f * (xy + wz); R[1][1] = 1.f - 2.f * (xx + zz);
      R[1][2] = 2.f * (yz - wx);
      R[2][0] = 2.f * (xz - wy); R[2][1] = 2.f * (yz + wx);
      R[2][2] = 1.f - 2.f * (xx + yy);
      cx = LB(bp, 0); cy = LB(bp, 1); cz = LB(bp, 2);
#undef LB
      pox = LJ(om, 0, pj); poy = LJ(om, 1, pj); poz = LJ(om, 2, pj);
      pbx = LJ(be, 0, pj); pby = LJ(be, 1, pj); pbz = LJ(be, 2, pj);
      s0 = sizes[3 * pb + 0]; s1 = sizes[3 * pb + 1]; s2 = sizes[3 * pb + 2];
    }

    float fsx = 0.f, fsy = 0.f, fsz = 0.f, tsx = 0.f, tsy = 0.f, tsz = 0.f;
    for (int p = 0; p < n; ++p) {
      const float* xp = xi + 3 * (row0 + p);
      const float vx0 = xp[0], vy0 = xp[1], vz0 = xp[2];
      // x = p + v + w t + qv x t,  t = 2 qv x v
      const float tx = 2.f * (qy * vz0 - qz * vy0);
      const float ty = 2.f * (qz * vx0 - qx * vz0);
      const float tz = 2.f * (qx * vy0 - qy * vx0);
      const float x0 = px + vx0 + qw * tx + (qy * tz - qz * ty);
      const float x1 = py + vy0 + qw * ty + (qz * tx - qx * tz);
      const float x2 = pz + vz0 + qw * tz + (qx * ty - qy * tx);
      float vr0 = oy * x2 - oz * x1 + bx;
      float vr1 = oz * x0 - ox * x2 + by;
      float vr2 = ox * x1 - oy * x0 + bz;

      float phi, n0, n1, n2;
      if (gt == kGround) {
        phi = x0 * g0 + x1 * g1 + x2 * g2 - gdot;
        n0 = g0; n1 = g1; n2 = g2;
      } else {
        const float d0 = x0 - cx, d1 = x1 - cy, d2 = x2 - cz;
        float xl[3];
        for (int i = 0; i < 3; ++i)
          xl[i] = R[0][i] * d0 + R[1][i] * d1 + R[2][i] * d2;
        float gl[3];
        if (gt == kCuboid) {
          const float dd[3] = {fabsf(xl[0]) - 0.5f * s0,
                               fabsf(xl[1]) - 0.5f * s1,
                               fabsf(xl[2]) - 0.5f * s2};
          const float dmax = fmaxf(fmaxf(dd[0], dd[1]), dd[2]);
          const float o[3] = {fmaxf(dd[0], 0.f), fmaxf(dd[1], 0.f),
                              fmaxf(dd[2], 0.f)};
          const float onorm =
              sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + kEps * kEps);
          phi = dmax > 0.f ? onorm : dmax;
          const float hit[3] = {dd[0] == dmax ? 1.f : 0.f,
                                dd[1] == dmax ? 1.f : 0.f,
                                dd[2] == dmax ? 1.f : 0.f};
          const float hs = hit[0] + hit[1] + hit[2];
          for (int i = 0; i < 3; ++i)
            gl[i] = (dmax > 0.f ? o[i] / onorm : hit[i] / hs) * sgn(xl[i]);
        } else if (gt == kCylinder) {
          const float r2 = sqrtf(xl[0] * xl[0] + xl[1] * xl[1] + kEps * kEps);
          const float dr = r2 - s0;
          const float dz = fabsf(xl[2]) - s1;
          const float dmax = fmaxf(dr, dz);
          const float o_r = fmaxf(dr, 0.f), o_z = fmaxf(dz, 0.f);
          const float onorm = sqrtf(o_r * o_r + o_z * o_z + kEps * kEps);
          phi = dmax > 0.f ? onorm : dmax;
          const float pick_r = dr >= dz ? 1.f : 0.f;
          const float c_r = dmax > 0.f ? o_r / onorm : pick_r;
          const float c_z = dmax > 0.f ? o_z / onorm : 1.f - pick_r;
          gl[0] = c_r * xl[0] / r2;
          gl[1] = c_r * xl[1] / r2;
          gl[2] = c_z * sgn(xl[2]);
        } else {  // kSphere
          const float r = sqrtf(xl[0] * xl[0] + xl[1] * xl[1] +
                                xl[2] * xl[2] + kEps * kEps);
          phi = r - s0;
          for (int i = 0; i < 3; ++i) gl[i] = xl[i] / r;
        }
        n0 = R[0][0] * gl[0] + R[0][1] * gl[1] + R[0][2] * gl[2];
        n1 = R[1][0] * gl[0] + R[1][1] * gl[1] + R[1][2] * gl[2];
        n2 = R[2][0] * gl[0] + R[2][1] * gl[1] + R[2][2] * gl[2];
        vr0 -= poy * x2 - poz * x1 + pbx;
        vr1 -= poz * x0 - pox * x2 + pby;
        vr2 -= pox * x1 - poy * x0 + pbz;
      }

      const float pen = fmaxf(-phi, 0.f);
      const float vn = vr0 * n0 + vr1 * n1 + vr2 * n2;
      const float pdot = fmaxf(-vn, 0.f);
      const float fn = kn * pen + dmp * pen * pdot;
      const float vt0 = vr0 - vn * n0, vt1 = vr1 - vn * n1,
                  vt2 = vr2 - vn * n2;
      const float vtn = sqrtf(vt0 * vt0 + vt1 * vt1 + vt2 * vt2 + kEps * kEps);
      const float cap = mu * fn;
      const float ks = kt * (cap / fmaxf(cap, kt * vtn + kEps));
      const float f0 = fn * n0 - ks * vt0;
      const float f1 = fn * n1 - ks * vt1;
      const float f2 = fn * n2 - ks * vt2;
      fsx += f0; fsy += f1; fsz += f2;
      tsx += x1 * f2 - x2 * f1;
      tsy += x2 * f0 - x0 * f2;
      tsz += x0 * f1 - x1 * f0;
      if (t0 >= 0) {
        const int row = t0 + p;
        tac[(0 * ntac + row) * B + b] += f0;
        tac[(1 * ntac + row) * B + b] += f1;
        tac[(2 * ntac + row) * B + b] += f2;
      }
    }
    LJ(F, 0, j) += fsx; LJ(F, 1, j) += fsy; LJ(F, 2, j) += fsz;
    LJ(T, 0, j) += tsx; LJ(T, 1, j) += tsy; LJ(T, 2, j) += tsz;
    if (gt != kGround) {
      LJ(F, 0, pj) -= fsx; LJ(F, 1, pj) -= fsy; LJ(F, 2, pj) -= fsz;
      LJ(T, 0, pj) -= tsx; LJ(T, 1, pj) -= tsy; LJ(T, 2, pj) -= tsz;
    }
#undef LJ
  }
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int lane_contact_launch(
    const float* jp, const float* jq, const float* om, const float* be,
    const float* bp, const float* bq, const float* sizes, const float* params,
    int row_stride, int lane_stride, const float* gpos, const float* gn,
    const float* xi, const int* segs, int S, int J, int NB, int ntac, int B,
    float* F, float* T, float* tac, void* stream) {
  const dim3 block(kBlock), grid((B + kBlock - 1) / kBlock);
  lane_contact_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      jp, jq, om, be, bp, bq, sizes, params, row_stride, lane_stride, gpos,
      gn, xi, segs, S, J, NB, ntac, B, F, T, tac);
  return static_cast<int>(cudaGetLastError());
}
