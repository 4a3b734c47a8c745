// K4 for Hopper (sm_90a): the dense point-vs-primitive penalty contact, and
// the tactile read built on it.
//
// Replaces the Pallas TPU kernel `_kernel` in
// tactilesimulation_tpu/ops/dense_contact.py (pallas_call at :174, launched by
// dense_point_contact) and, in the read, the tactile query around its calls
// (tactilesimulation_tpu/ops/tactile_query.tactile_field). Two entries:
//
// Points (dense_contact_launch_f32/_f64), the counterpart of the JAX
// package's public dense_point_contact: for each of N world points x with
// velocity xdot, the force from ONE primitive body (sphere, cuboid,
// cylinder) or the ground half-space:
//   1. world to local        xl = R^T (x - p)
//   2. SDF and normal        phi, n = R gl          (contact_point.cuh)
//   3. relative velocity     xdot - (v + w x (x - p))
//   4. normal force          kn pen + damping pen max(0, -vn)
//   5. smooth Coulomb cap    scale = cap / max(cap, kt |vt| + eps)
// The ground is the plane gn . x = gn . ground_pos. x, xdot and f are
// contiguous (N, 3) rows; the primitive's 32 scalars (pose, twist, size,
// parameters, ground) arrive as a small device array packed by the wrapper:
// [p(3), R(9 row-major), v(3), w(3), size(3), kn, kt, mu, damping, gn(3),
// gn . ground_pos, 0, 0, 0]. One thread per point, blocks of 256, `i < N`
// guards the ragged end; the primitive type is a template parameter.
//
// Read (tactile_read_launch_f32/_f64): the whole (Mtot, 3) sensor-frame
// field [shear0, shear1, normal] of a scene from (q, v), in one launch:
// what ops/tactile_query.tactile_field_ref computes with some 700 eager ops.
// A batch of B states (B, n) of one scene is one launch too: the grid's y
// dimension is the instance, each instance's blocks run the prologue on its
// own (q, v) and write its own (Mtot, 3) run of the (B, Mtot, 3) output;
// every row is computed by one thread in the order of a single read, so a
// batch of one is the single read, bit for bit.
//   prologue, every block: warp 0 runs FK of the J joints on Dual<T> with
//     tangent v (kinematics.cuh, K2's FK), so the joints' frames come with
//     their JVP: each lane takes joints' local frames (the sines and
//     cosines), then the joints are attached to their parents' world
//     frames one tree depth at a time, the lanes taking a depth's joints,
//     __syncwarp between depths; then one thread per joint turns the JVP
//     into the joint's world twist (Omega = 2 (qdot q*)_xyz, beta = pdot -
//     Omega x p), and one thread per tactile pair packs the pair's 32
//     scalars as the points entry takes them (the primitive's pose from its
//     joint's frame, its twist, its size, the pair's parameter row, the
//     ground), all in shared memory sized from the plan's counts at launch
//     (read_shared_bytes; past 48 KB the launch asks for it, past what a
//     block may hold it returns an error);
//   body: one thread per marker row, in 256-row tiles over a grid-stride
//     loop: the marker's world position and velocity from its owner joint's
//     frame and twist, the force of every pair whose rows hold it, summed in
//     registers in pair order (as dynamics.tactile_field adds them), the
//     sensor axes rotated by the owner joint's frame, and the three
//     projections staged in shared memory and written as one contiguous run
//     per tile.
// No atomics: two launches are bit-equal. The read plan (ops/dense_contact.py
// ReadPlan; layout at load_read_scene) holds the FK tables, each pair's row
// range, type, body joint and constants, and the markers as structure of
// arrays. A row finds its pairs by scanning the pairs' row ranges in shared
// memory (a pair covers one contiguous run of rows), which costs no bytes
// per row where a row-to-pairs index would cost 8.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s fp32):
//   points: per point x and xdot read, f written: 36 B in float, 1.44 MB at
//     N = 40,000 (0.43 us); about 100 flops per point (0.06 us);
//   read: per row 52 B of tables read (owner joint, position, normal and
//     two axes) and 12 B written, 2.56 MB at RollingBall's 40,000 rows
//     (0.76 us); 1.0e7 operations there, 254 a row with its one pair, and
//     3.9e5 on StableGrasp's 260 rows of 11 pairs (megastep_host.py's
//     HostTactileRead counts them at a run's inputs; chip_smoke.py prints
//     the bound). Both are bound by bytes, and both are below a launch's own
//     latency, so the read's design is one launch with coalesced loads in
//     place of the query's hundreds of eager ops. No tensor cores and no
//     TMA: there is no matrix product, and a tile is 3 KB. The prologue's
//     serial part is the tree's depth (5 attachments for StableGrasp's 21
//     joints) after one local frame per lane.

#include <cuda_runtime.h>

#include "contact_point.cuh"
#include "kinematics.cuh"

namespace {

using namespace tsim;

constexpr int kBlock = 256;
constexpr int kScalars = 32;
constexpr int kReadBlocksPerSM = 8;  // 256-thread blocks an SM holds at once
constexpr int kPairInts = 4;       // row0, rows, gtype, the body's joint
constexpr int kPairFloats = 14;    // body_pos(3) body_quat(4) size(3) kn kt
                                   // mu damping

// The force on one point at x moving at xd from the primitive (or ground)
// whose 32 scalars sc holds (layout above).
template <int GT, class T>
__device__ __forceinline__ void point_force(const T xi[3], const T vi[3],
                                            const T* sc, T out[3]) {
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
  penalty_force<T, T>(phi, nrm, vr, kn, kt, mu, dmp, out);
}

template <class T>
__device__ __forceinline__ void pair_force(int gt, const T xi[3],
                                           const T vi[3], const T* sc,
                                           T out[3]) {
  switch (gt) {
    case kGround: point_force<kGround, T>(xi, vi, sc, out); break;
    case kCuboid: point_force<kCuboid, T>(xi, vi, sc, out); break;
    case kCylinder: point_force<kCylinder, T>(xi, vi, sc, out); break;
    default: point_force<kSphere, T>(xi, vi, sc, out); break;
  }
}

// -- the read ----------------------------------------------------------------

// The read plan, unpacked (ops/dense_contact.py ReadPlan):
//   ints:   parent[J] | depth[J] | trans_idx[J*3] | rot_idx[J*3] | (m_rev,
//           m_exp, m_eul)[J*3] | pairs[P*4] | tac_joint[N]
//   floats: ground_pos[3] | ground_normal[3] | joint_pos[J*3]
//           | joint_quat[J*4] | joint_axis0[J*3] | basis[J*9]
//           | pair rows[P*14] | markers[12*N]: tac_pos x, y, z,
//           tac_normal x, y, z, tac_axis0 x, y, z, tac_axis1 x, y, z, each
//           a run of N values
// A joint's depth is its number of ancestors. The fields fk_local reads
// carry megastep.cu's Scene names.
template <class T>
struct ReadScene {
  int n, J, P, N;
  const int *jparent, *depth, *trans_idx, *rot_idx, *mflags, *pairs,
      *tac_joint;
  const T *gpos, *gn, *jpos, *jquat, *jaxis, *basis, *prow, *tac;
};

template <class T>
__device__ __forceinline__ ReadScene<T> load_read_scene(const int* it,
                                                        const T* ft, int n,
                                                        int J, int P, int N) {
  ReadScene<T> s;
  s.n = n; s.J = J; s.P = P; s.N = N;
  s.jparent = it; it += J;
  s.depth = it; it += J;
  s.trans_idx = it; it += 3 * J;
  s.rot_idx = it; it += 3 * J;
  s.mflags = it; it += 3 * J;
  s.pairs = it; it += kPairInts * P;
  s.tac_joint = it;
  s.gpos = ft; ft += 3;
  s.gn = ft; ft += 3;
  s.jpos = ft; ft += 3 * J;
  s.jquat = ft; ft += 4 * J;
  s.jaxis = ft; ft += 3 * J;
  s.basis = ft; ft += 9 * J;
  s.prow = ft; ft += kPairFloats * P;
  s.tac = ft;
  return s;
}

// What the prologue leaves in shared memory for the rows, and the body's
// output tile: arrays sized by the scene, carved from the block's dynamic
// shared memory by carve_read_shared (Dual<T> arrays first, then T, then
// int, so each starts aligned).
template <class T>
struct ReadShared {
  Dual<T>* qd;                        // [n] (q, v)
  Dual<T> (*jp)[3];                   // [J] FK and its JVP
  Dual<T> (*jq)[4];                   // [J]
  T (*p)[3];                          // [J] joint frames
  T (*q)[4];                          // [J]
  T (*om)[3];                         // [J] joint twists
  T (*be)[3];                         // [J]
  T (*sc)[kScalars];                  // [P] each pair's scalars
  T* tile;                            // [3 kBlock] the body's output tile
  int (*range)[3];                    // [P] row0, rows, gtype
};

template <class T>
__host__ __device__ constexpr size_t read_shared_bytes(int n, int J, int P) {
  return sizeof(Dual<T>) * (size_t(n) + 7 * size_t(J)) +
         sizeof(T) * (13 * size_t(J) + kScalars * size_t(P) + 3 * kBlock) +
         sizeof(int) * 3 * size_t(P);
}

template <class T>
__device__ __forceinline__ ReadShared<T> carve_read_shared(void* base, int n,
                                                           int J, int P) {
  ReadShared<T> sh;
  Dual<T>* d = static_cast<Dual<T>*>(base);
  sh.qd = d; d += n;
  sh.jp = reinterpret_cast<Dual<T>(*)[3]>(d); d += 3 * J;
  sh.jq = reinterpret_cast<Dual<T>(*)[4]>(d); d += 4 * J;
  T* t = reinterpret_cast<T*>(d);
  sh.p = reinterpret_cast<T(*)[3]>(t); t += 3 * J;
  sh.q = reinterpret_cast<T(*)[4]>(t); t += 4 * J;
  sh.om = reinterpret_cast<T(*)[3]>(t); t += 3 * J;
  sh.be = reinterpret_cast<T(*)[3]>(t); t += 3 * J;
  sh.sc = reinterpret_cast<T(*)[kScalars]>(t); t += kScalars * P;
  sh.tile = t; t += 3 * kBlock;
  sh.range = reinterpret_cast<int(*)[3]>(t);
  return sh;
}

// prologue 1a (a thread per joint): joint j's frame in its parent's on
// Dual<T> with tangent v (kinematics.cuh, K2's FK), kept in jp[j], jq[j]
template <class T>
__device__ __forceinline__ void read_fk_local(const ReadScene<T>& sc,
                                              const ReadShared<T>& sh, int j) {
  Dual<T> pl[3], ql[4];
  fk_local(sc, sh.qd, j, pl, ql);
  for (int i = 0; i < 3; ++i) sh.jp[j][i] = pl[i];
  for (int i = 0; i < 4; ++i) sh.jq[j][i] = ql[i];
}

// prologue 1b (a thread per joint of one depth, the depths in order):
// joint j's world frame from its parent's, which the depth before left
template <class T>
__device__ __forceinline__ void read_fk_attach(const ReadScene<T>& sc,
                                               const ReadShared<T>& sh,
                                               int j) {
  const int par = sc.jparent[j];
  Dual<T> pl[3], ql[4];
  for (int i = 0; i < 3; ++i) pl[i] = sh.jp[j][i];
  for (int i = 0; i < 4; ++i) ql[i] = sh.jq[j][i];
  fk_attach(sh.jp[par], sh.jq[par], pl, ql, sh.jp[j], sh.jq[j]);
}

// prologue 2 (a thread per joint): joint j's frame and world twist
template <class T>
__device__ __forceinline__ void read_twist(const ReadShared<T>& sh, int j) {
  T pd[3], qd[4], qc[4], w4[4], t[3];
  for (int i = 0; i < 3; ++i) {
    sh.p[j][i] = sh.jp[j][i].v;
    pd[i] = sh.jp[j][i].d;
  }
  for (int i = 0; i < 4; ++i) {
    sh.q[j][i] = sh.jq[j][i].v;
    qd[i] = sh.jq[j][i].d;
  }
  qc[0] = sh.q[j][0];
  for (int i = 1; i < 4; ++i) qc[i] = -sh.q[j][i];
  qmul(qd, qc, w4);
  for (int i = 0; i < 3; ++i) sh.om[j][i] = T(2) * w4[1 + i];
  cross3(sh.om[j], sh.p[j], t);
  for (int i = 0; i < 3; ++i) sh.be[j][i] = pd[i] - t[i];
}

// prologue 3 (a thread per pair): pair k's 32 scalars, as the points entry
// takes them, and its row range
template <class T>
__device__ __forceinline__ void read_pair(const ReadScene<T>& sc,
                                          const ReadShared<T>& sh, int k) {
  const int* pi = sc.pairs + kPairInts * k;
  const T* pr = sc.prow + kPairFloats * k;
  T* s = sh.sc[k];
  for (int e = 0; e < kScalars; ++e) s[e] = T(0);
  if (pi[2] == kGround) {
    s[3] = s[7] = s[11] = T(1);              // identity pose, unit size
    s[18] = s[19] = s[20] = T(1);
  } else {
    const int j = pi[3];
    T r[3], bq[4], R[3][3], t[3];
    qrot(sh.q[j], pr, r);
    for (int i = 0; i < 3; ++i) s[i] = sh.p[j][i] + r[i];
    qmul(sh.q[j], pr + 3, bq);
    quat_to_mat(bq, R);
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) s[3 + 3 * a + b] = R[a][b];
    cross3(sh.om[j], s, t);                  // v = w x p + beta
    for (int i = 0; i < 3; ++i) {
      s[12 + i] = t[i] + sh.be[j][i];
      s[15 + i] = sh.om[j][i];
      s[18 + i] = pr[7 + i];
    }
  }
  for (int i = 0; i < 4; ++i) s[21 + i] = pr[10 + i];
  for (int i = 0; i < 3; ++i) s[25 + i] = sc.gn[i];
  s[28] = sc.gn[0] * sc.gpos[0] + sc.gn[1] * sc.gpos[1] +
          sc.gn[2] * sc.gpos[2];
  sh.range[k][0] = pi[0];
  sh.range[k][1] = pi[1];
  sh.range[k][2] = pi[2];
}

// the body (a thread per row): row i's sensor-frame force
template <class T>
__device__ __forceinline__ void read_row(const ReadScene<T>& sc,
                                         const ReadShared<T>& sh, int i,
                                         T out[3]) {
  const int N = sc.N;
  const int j = sc.tac_joint[i];
  const T* m = sc.tac + i;
  const T xi[3] = {m[0], m[N], m[2 * N]};
  T x[3], xd[3];
  point_world(sh.p[j], sh.q[j], xi, x);
  cross3(sh.om[j], x, xd);
  for (int a = 0; a < 3; ++a) xd[a] = xd[a] + sh.be[j][a];
  T f[3] = {T(0), T(0), T(0)};
  for (int k = 0; k < sc.P; ++k) {
    const int r0 = sh.range[k][0];
    if (i < r0 || i >= r0 + sh.range[k][1]) continue;
    T fk[3];
    pair_force(sh.range[k][2], x, xd, sh.sc[k], fk);
    for (int a = 0; a < 3; ++a) f[a] = f[a] + fk[a];
  }
  T ax[3][3];                                // axis0, axis1, normal
  const int from[3] = {6, 9, 3};
  for (int c = 0; c < 3; ++c) {
    const T loc[3] = {m[from[c] * N], m[(from[c] + 1) * N],
                      m[(from[c] + 2) * N]};
    qrot(sh.q[j], loc, ax[c]);
  }
  for (int c = 0; c < 3; ++c)
    out[c] = f[0] * ax[c][0] + f[1] * ax[c][1] + f[2] * ax[c][2];
}

#ifdef __CUDACC__

template <int GT, class T>
__global__ void __launch_bounds__(kBlock)
dense_contact_kernel(const T* __restrict__ x, const T* __restrict__ xd,
                     const T* __restrict__ sc, int n, T* __restrict__ f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T xi[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  const T vi[3] = {xd[3 * i], xd[3 * i + 1], xd[3 * i + 2]};
  T out[3];
  point_force<GT, T>(xi, vi, sc, out);
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

template <class T>
__global__ void __launch_bounds__(kBlock)
tactile_read_kernel(const int* __restrict__ it, const T* __restrict__ ft,
                    const T* __restrict__ q, const T* __restrict__ v, int n,
                    int J, int P, int N, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ReadShared<T> sh = carve_read_shared<T>(smem, n, J, P);
  const ReadScene<T> sc = load_read_scene(it, ft, n, J, P, N);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.y;               // the instance
  q += b * n;
  v += b * n;
  out += b * 3 * static_cast<size_t>(N);
  if (tid < 32) {                            // FK: warp 0
    for (int i = tid; i < n; i += 32) sh.qd[i] = Dual<T>{q[i], v[i]};
    __syncwarp();
    for (int j = tid; j < J; j += 32) read_fk_local(sc, sh, j);
    for (int d = 1;; ++d) {                  // one depth at a time
      __syncwarp();
      bool deeper = false;
      for (int j = tid; j < J; j += 32) {
        const int dj = sc.depth[j];
        if (dj == d) read_fk_attach(sc, sh, j);
        deeper |= dj > d;
      }
      if (!__any_sync(0xffffffffu, deeper)) break;
    }
  }
  __syncthreads();
  for (int j = tid; j < J; j += kBlock) read_twist(sh, j);
  __syncthreads();
  for (int k = tid; k < P; k += kBlock) read_pair(sc, sh, k);
  __syncthreads();
  for (int base = blockIdx.x * kBlock; base < N; base += gridDim.x * kBlock) {
    const int i = base + tid;
    if (i < N) read_row(sc, sh, i, sh.tile + 3 * tid);
    __syncthreads();
    const int m = 3 * min(kBlock, N - base);
    for (int e = tid; e < m; e += kBlock) out[3 * base + e] = sh.tile[e];
    __syncthreads();
  }
}

template <class T>
int read_launch(const int* it, const T* ft, const T* q, const T* v, int n,
                int J, int P, int N, int B, T* out, cudaStream_t stream) {
  if (n < 1 || J < 1 || P < 1 || N < 1 || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t bytes = read_shared_bytes<T>(n, J, P);
  if (bytes > (48 << 10)) {   // past 48 KB a kernel asks for it
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (bytes > static_cast<size_t>(optin))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        tactile_read_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the blocks the card holds at once, shared out over the instances
  const int tiles = (N + kBlock - 1) / kBlock;
  const int resident = kReadBlocksPerSM * (sms > 0 ? sms : 1);
  const dim3 grid(min(tiles, max(1, (resident + B - 1) / B)), B);
  tactile_read_kernel<T><<<grid, kBlock, bytes, stream>>>(it, ft, q, v, n, J,
                                                          P, N, out);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Launch K4's points entry on `stream`; return cudaGetLastError() (0 =
// launched).
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

// Launch the tactile read of B states on `stream` (plan tables `it`, `ft`;
// n coordinates, J joints, P pairs, N rows; q, v (B, n), out (B, N, 3));
// return cudaGetLastError().
extern "C" int tactile_read_launch_f32(const int* it, const float* ft,
                                       const float* q, const float* v, int n,
                                       int J, int P, int N, int B,
                                       float* out, void* stream) {
  return read_launch<float>(it, ft, q, v, n, J, P, N, B, out,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int tactile_read_launch_f64(const int* it, const double* ft,
                                       const double* q, const double* v,
                                       int n, int J, int P, int N, int B,
                                       double* out, void* stream) {
  return read_launch<double>(it, ft, q, v, n, J, P, N, B, out,
                             static_cast<cudaStream_t>(stream));
}

#endif  // __CUDACC__

extern "C" int dense_contact_scalars() { return kScalars; }

// the plan's ints and floats per pair
extern "C" void tactile_read_layout(int* out) {
  out[0] = kPairInts;
  out[1] = kPairFloats;
}

// the dynamic shared memory a read of n coordinates, J joints and P pairs
// asks for (dbl: float64)
extern "C" long long tactile_read_shared_bytes(int n, int J, int P, int dbl) {
  return static_cast<long long>(dbl ? read_shared_bytes<double>(n, J, P)
                                    : read_shared_bytes<float>(n, J, P));
}
