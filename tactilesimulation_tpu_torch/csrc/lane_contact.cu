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

// The per-point law (point position, SDF, penalty force) lives in
// contact_point.cuh, shared with K2/K3 (megastep.cu); this file keeps the
// per-segment loop and the wrench and tactile reductions.

#include <cuda_runtime.h>

#include "contact_point.cuh"

namespace {

using namespace tsim;

constexpr int kSegCols = 8;    // row0, n, joint, prim_body, prim_joint,
                               // gtype, param_row, tac0
constexpr int kBlock = 128;

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
  const float gp[3] = {gpos[0], gpos[1], gpos[2]};
  const float g[3] = {gn[0], gn[1], gn[2]};

#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const int* sg = segs + kSegCols * s;
    const int row0 = sg[0], n = sg[1], j = sg[2], pb = sg[3], pj = sg[4];
    const int gt = sg[5], pr = sg[6], t0 = sg[7];
#define LJ(a, c, jj) a[((c) * J + (jj)) * B + b]
    const float p[3] = {LJ(jp, 0, j), LJ(jp, 1, j), LJ(jp, 2, j)};
    const float q[4] = {LJ(jq, 0, j), LJ(jq, 1, j), LJ(jq, 2, j),
                        LJ(jq, 3, j)};
    const float ox = LJ(om, 0, j), oy = LJ(om, 1, j), oz = LJ(om, 2, j);
    const float bx = LJ(be, 0, j), by = LJ(be, 1, j), bz = LJ(be, 2, j);
    const float* prm = params + b * lane_stride;
    const float kn = prm[(pr * 4 + 0) * row_stride];
    const float kt = prm[(pr * 4 + 1) * row_stride];
    const float mu = prm[(pr * 4 + 2) * row_stride];
    const float dmp = prm[(pr * 4 + 3) * row_stride];

    // primitive frame: rotation R (world-from-local), origin c, twist
    float R[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
    float c[3] = {0.f, 0.f, 0.f}, sz[3] = {0.f, 0.f, 0.f};
    float pox = 0.f, poy = 0.f, poz = 0.f, pbx = 0.f, pby = 0.f, pbz = 0.f;
    if (gt != kGround) {
#define LB(a, cc) a[((cc) * NB + pb) * B + b]
      const float qb[4] = {LB(bq, 0), LB(bq, 1), LB(bq, 2), LB(bq, 3)};
      quat_to_mat(qb, R);
      c[0] = LB(bp, 0); c[1] = LB(bp, 1); c[2] = LB(bp, 2);
#undef LB
      pox = LJ(om, 0, pj); poy = LJ(om, 1, pj); poz = LJ(om, 2, pj);
      pbx = LJ(be, 0, pj); pby = LJ(be, 1, pj); pbz = LJ(be, 2, pj);
      for (int i = 0; i < 3; ++i) sz[i] = sizes[3 * pb + i];
    }

    float fsx = 0.f, fsy = 0.f, fsz = 0.f, tsx = 0.f, tsy = 0.f, tsz = 0.f;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      float x[3];
      point_world(p, q, xi + 3 * (row0 + k), x);
      float vr[3] = {oy * x[2] - oz * x[1] + bx, oz * x[0] - ox * x[2] + by,
                     ox * x[1] - oy * x[0] + bz};
      if (gt != kGround) {
        vr[0] -= poy * x[2] - poz * x[1] + pbx;
        vr[1] -= poz * x[0] - pox * x[2] + pby;
        vr[2] -= pox * x[1] - poy * x[0] + pbz;
      }
      float phi, nrm[3], f[3];
      sdf_normal(gt, x, R, c, sz, gp, g, phi, nrm);
      penalty_force(phi, nrm, vr, kn, kt, mu, dmp, f);
      fsx += f[0]; fsy += f[1]; fsz += f[2];
      tsx += x[1] * f[2] - x[2] * f[1];
      tsy += x[2] * f[0] - x[0] * f[2];
      tsz += x[0] * f[1] - x[1] * f[0];
      if (t0 >= 0) {
        const int row = t0 + k;
        tac[(0 * ntac + row) * B + b] += f[0];
        tac[(1 * ntac + row) * B + b] += f[1];
        tac[(2 * ntac + row) * B + b] += f[2];
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
