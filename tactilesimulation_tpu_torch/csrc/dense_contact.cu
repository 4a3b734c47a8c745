// K4: dense point-vs-primitive penalty contact for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// tactilesimulation_tpu/ops/dense_contact.py (launched by
// dense_point_contact). For each of N world points x with velocity xdot it
// computes the force from ONE primitive body (sphere, cuboid, cylinder) or
// the ground half-space:
//   1. world to local        xl = R^T (x - p)
//   2. SDF and normal        phi, n = R gl          (contact_point.cuh)
//   3. relative velocity     xdot - (v + w x (x - p))
//   4. normal force          kn pen + damping pen max(0, -vn)
//   5. smooth Coulomb cap    scale = cap / max(cap, kt |vt| + eps)
// The ground is the plane gn . x = gn . ground_pos, with the identity pose
// and unit size.
//
// Layout: x, xdot and f are contiguous (N, 3) rows. The 29 scalars of the
// primitive (pose, twist, size, parameters, ground) arrive as a small device
// array, packed by the wrapper from the FK outputs on the card (no host
// round trip): [p(3), R(9 row-major), v(3), w(3), size(3), kn, kt, mu,
// damping, gn(3), gn . ground_pos, 0, 0, 0].
//
// Design: one thread per point, blocks of 256, `i < N` guards the ragged
// end (no padding). The primitive type is a template parameter, so each
// instance is a straight-line program; float and double instances.
//
// What bounds it on an H100: per point it reads x and xdot and writes f:
// 36 B in float (72 B in double), 1.44 MB at N = 40,000, or 0.43 us at
// 3.35 TB/s; the arithmetic is about 100 flops per point (0.06 us at
// 67 TFLOP/s fp32). Both are below a launch's own latency (a few us), so a
// launch costs more than the work; tuning is left for later.

#include <cuda_runtime.h>

#include "contact_point.cuh"

namespace {

using namespace tsim;

constexpr int kBlock = 256;
constexpr int kScalars = 32;

template <int GT, class T>
__global__ void __launch_bounds__(kBlock)
dense_contact_kernel(const T* __restrict__ x, const T* __restrict__ xd,
                     const T* __restrict__ sc, int n, T* __restrict__ f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T xi[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  const T vi[3] = {xd[3 * i], xd[3 * i + 1], xd[3 * i + 2]};
  const T kn = sc[21], kt = sc[22], mu = sc[23], dmp = sc[24];
  T phi, nrm[3], vr[3];
  if (GT == kGround) {
    phi = xi[0] * sc[25] + xi[1] * sc[26] + xi[2] * sc[27] - sc[28];
    for (int k = 0; k < 3; ++k) {
      nrm[k] = sc[25 + k];
      vr[k] = vi[k];
    }
  } else {
    const T p[3] = {sc[0], sc[1], sc[2]};
    T R[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) R[a][b] = sc[3 + 3 * a + b];
    const T sz[3] = {sc[18], sc[19], sc[20]};
    const T zero3[3] = {T(0), T(0), T(0)};
    sdf_normal<T, T>(GT, xi, R, p, sz, zero3, zero3, phi, nrm);
    // primitive surface velocity at x: v + w x d
    const T d0 = xi[0] - p[0], d1 = xi[1] - p[1], d2 = xi[2] - p[2];
    const T* v = sc + 12;
    const T* w = sc + 15;
    vr[0] = vi[0] - (v[0] + w[1] * d2 - w[2] * d1);
    vr[1] = vi[1] - (v[1] + w[2] * d0 - w[0] * d2);
    vr[2] = vi[2] - (v[2] + w[0] * d1 - w[1] * d0);
  }
  T out[3];
  penalty_force<T, T>(phi, nrm, vr, kn, kt, mu, dmp, out);
  f[3 * i] = out[0];
  f[3 * i + 1] = out[1];
  f[3 * i + 2] = out[2];
}

template <class T>
int launch(int gtype, const T* x, const T* xd, const T* sc, int n, T* f,
           cudaStream_t stream) {
  const dim3 block(kBlock), grid((n + kBlock - 1) / kBlock);
  switch (gtype) {
    case kGround:
      dense_contact_kernel<kGround, T><<<grid, block, 0, stream>>>(
          x, xd, sc, n, f);
      break;
    case kCuboid:
      dense_contact_kernel<kCuboid, T><<<grid, block, 0, stream>>>(
          x, xd, sc, n, f);
      break;
    case kCylinder:
      dense_contact_kernel<kCylinder, T><<<grid, block, 0, stream>>>(
          x, xd, sc, n, f);
      break;
    case kSphere:
      dense_contact_kernel<kSphere, T><<<grid, block, 0, stream>>>(
          x, xd, sc, n, f);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K4 on `stream`; return cudaGetLastError() (0 = launched).
extern "C" int dense_contact_launch_f32(int gtype, const float* x,
                                        const float* xd, const float* sc,
                                        int n, float* f, void* stream) {
  return launch<float>(gtype, x, xd, sc, n, f,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int dense_contact_launch_f64(int gtype, const double* x,
                                        const double* xd, const double* sc,
                                        int n, double* f, void* stream) {
  return launch<double>(gtype, x, xd, sc, n, f,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int dense_contact_scalars() { return kScalars; }
