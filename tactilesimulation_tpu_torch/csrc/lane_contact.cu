// K1 and K1T: the lane-major contact pair-wrench kernel and its adjoint, for
// Hopper (sm_90a).
//
// K1 replaces the Pallas TPU kernel `_kernel` of
// tactilesimulation_tpu/ops/lane_contact.py (pallas_call at :413, launched
// by make_pair_wrenches.run_kernel). For every contact point and tactile
// marker of every segment (a run of points sharing owner joint, primitive
// and parameter row) it computes
//   world position      x = p_j + M(q_j) xi       (owner-joint frame)
//   point velocity      v = Omega_j x x + beta_j
//   SDF and normal      vs ground / cuboid / cylinder / sphere
//   relative velocity   v - (Omega_p x x + beta_p)  (primitive's joint)
//   penalty force       f = (kn p + d p max(0, -phidot)) n - kt s v_t,
//                       s = mu|f_n| / max(mu|f_n|, kt|v_t| + eps)
// and reduces the forces to per-joint wrenches F_j = sum f, T_j = sum x x f
// (opposite sign on the primitive's joint, its torque taken at x, which is
// the twin's x_app_p to round-off), plus the dense tactile rows.
//
// K1T replaces the backward of the same op's jax.custom_vjp (:452), which
// XLA fuses from jax.vjp of the jnp twin: the VJP of the plain version
// (ops/lane_contact.py wrenches_ref) with its convention that the primitive
// side's application point is held fixed in the primitive's frame, so the
// primitive torque's x_app_p = c + R xi_p moves with the primitive's pose
// (c, R) only. From the cotangents of (F, T, tac) it gives those of the
// per-lane inputs (jp, jq, Om, be, bp, bquat and per-lane parameters) and
// of the shared leaves (sizes, static parameters, gpos, gn, the points'
// local coordinates). It recomputes each point's primal in registers and
// runs the hand-written reverse of the point law (contact_point.cuh), so
// the bytes it moves stay per lane.
//
// Layout: every per-lane array is batch-last, (C, J|NB|ntac, B) row-major,
// so element (c, j, b) sits at (c * J + j) * B + b.
//
// Decomposition. A block owns a tile of 32 consecutive lanes (threadIdx.x,
// so each (c, j) row of a tile is one 128-byte line) and kWarps warps
// (threadIdx.y); a tile is NS blocks, one thread-block cluster. The host
// cuts the scene's points into pieces of at most kCH points of one segment
// (ops/lane_contact.py build_plan) and deals them in rounds: in round r,
// warp w of block y takes piece (r NS + y) kWarps + w. Each lane walks its
// piece's points and keeps the piece's partial sums (K1: F and T; K1T: 43
// cotangent sums) in registers, then stores them in its warp's slot in
// shared memory. After the cluster's barrier, one task per output (K1: per
// joint; K1T: per joint, body, parameter row and the ground), owned by one
// warp of one block of the cluster, adds the round's slots in piece order
// to its accumulators, reading the other blocks' slots through the
// cluster's distributed shared memory; after the last round it writes its
// outputs once. There are no float atomics: the result is the same on
// every launch, and NS comes from the scene alone, so a lane's result does
// not depend on B. A tactile row is written once per lane: by the lane
// that computes it, or, for a marker in several segments, by a task per
// such row that sums the segments' forces (kept per point in a scratch
// array) in segment order. K1T's shared leaves are summed over a tile's 32
// lanes in a fixed order (lane 0 to 31) into per-tile partials, which the
// wrapper sums over tiles. Each block stages the piece and segment tables
// once, and each round its pieces' local points and its segments' per-lane
// frames (p, M(q), Omega, beta; the primitive's origin, R, Omega, beta;
// the parameter row; K1T: the joints' cotangents), in shared memory.
//
// The per-tile routines below compile as host C++ too (megastep_host.py
// runs them with g++, the block's threads one after another, on the CPU
// tests); the kernels and their launches are nvcc's only.
//
// What bounds them on an H100 (TactilePush, B = 1024, f32): K1 reads the
// joint and body frames and twists (140 floats per lane) and writes F, T
// and the 130 tactile rows (432 floats): ~2.3 MB, 0.7 us at 3.35 TB/s;
// K1T reads those, the cotangents (432) and writes 140: ~2.9 MB, 0.9 us.
// chip_smoke.py counts the operations the function needs at its run's
// inputs with megastep_host.py's counting scalar (K1 3.3e7, 0.5 us at
// 67 TFLOP/s; K1T asked for the per-lane cotangents 1.1e8, 1.7 us).
// Measured there (NVIDIA H100 80GB HBM3 at 700 W, the launches queued
// behind a sleep so the card runs them back to back): K1 0.026 ms and
// K1T 0.062 ms at B = 1024, 0.022 and 0.054 ms at B = 16
// (one cluster), so what they take is a tile's latency, not bytes or
// operations: the staging, 8 points in series per thread, three cluster
// barriers and the tasks' piece-by-piece sums over remote shared memory.
// Launched one by one from Python, a call costs 0.05-0.09 ms (the
// wrapper's checks and allocations, ctypes, the cluster launch).

#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

#include "contact_point.cuh"

namespace {

using namespace tsim;

constexpr int kTile = 32;      // lanes per block (threadIdx.x)
constexpr int kWarps = 4;      // warps per block (threadIdx.y)
constexpr int kCH = 8;         // points per piece
constexpr int kMaxSplit = 8;   // blocks per tile: the portable cluster size
constexpr int kSegCols = 8;    // off, n, joint, prim_body, prim_joint, gtype,
                               // param_row, tac0
constexpr int kPieceCols = 6;  // seg, xoff, n, trow, rep0, frame slot
constexpr int kRoundCols = 2;  // per (round, block): stage0, nstage
constexpr int kRepCols = 3;    // per repeated row: row, entry0, count
// plan header (ops/lane_contact.py build_plan)
enum {
  kHS, kHNP, kHNS, kHRounds, kHStageMax, kHNRep, kHNRepPts, kHOffSeg,
  kHOffPiece, kHOffRound, kHOffStage, kHOffRep, kHOffRepIdx, kHTotal,
  kHeader = 16
};
// per-lane frame of a staged segment
enum {
  kFp = 0, kFM = 3, kFOm = 12, kFBe = 15, kFc = 18, kFR = 21, kFOmp = 30,
  kFBep = 33, kFPrm = 36, kFrame = 40,
  kFgF = 40, kFgT = 43, kFgFp = 46, kFgTp = 49, kFrameT = 52
};
// K1T's per-piece cotangent sums (a slot)
enum {
  kSp = 0, kSM = 3, kSOm = 12, kSBe = 15,
  kSOmp = 18, kSBep = 21,    // prim joint's twist; the ground's gpos, gn
  kSc = 24, kSR = 27,        // prim body's origin and rotation
  kSPrm = 36, kSSize = 40, kSlotT = 43
};
constexpr int kSlotF = 6;      // K1: F (3) and T (3) of a piece
constexpr int kAccF = 6;       // K1: a joint task's accumulators
constexpr int kAccT = 18;      // K1T: a task's accumulators (the most: joint)
constexpr int kRed = 6;        // K1T: values a task sums over lanes
// want bits of K1T's per-tile partials
enum { kWSizes = 1, kWParams = 2, kWGpos = 4, kWGn = 8, kWXi = 16 };

__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }

// tasks: K1 one per joint, then one per repeated tactile row; K1T one per
// joint, body, parameter row, then the ground
__host__ __device__ inline int n_tasks(const int* h, bool adj, int J, int NB,
                                       int K) {
  return adj ? J + NB + K + 1 : J + h[kHNRep];
}
// task i's owner: warp (i mod (NS kWarps)) of the cluster, and its
// accumulators' index in the owner block
__host__ __device__ inline int task_local(int i, int NS) {
  return (i / (NS * kWarps)) * kWarps + i % kWarps;
}

// The block's shared memory, carved from the plan's header (the same on
// the host that sizes the launch and in the kernel).
struct Layout {
  int frames, xs, slots, buf, red, acc, total;   // offsets in bytes
};

template <class T>
__host__ __device__ inline Layout layout(const int* h, bool adj, int ntasks) {
  const int tb = int(sizeof(T)), NS = h[kHNS];
  Layout L;
  int o = up16(4 * (kSegCols * h[kHS] + kPieceCols * h[kHNP]));
  L.frames = o;
  o += up16(tb * h[kHStageMax] * (adj ? kFrameT : kFrame) * kTile);
  L.xs = o;
  o += up16(tb * kWarps * kCH * 3);
  L.slots = o;
  o += up16(tb * kWarps * (adj ? kSlotT : kSlotF) * kTile);
  L.buf = o;
  if (adj) o += up16(tb * kWarps * kCH * 3 * kTile);
  L.red = o;
  if (adj) o += up16(tb * kWarps * kRed * kTile);
  L.acc = o;
  const int per = (ntasks + NS * kWarps - 1) / (NS * kWarps) * kWarps;
  o += up16(tb * per * (adj ? kAccT : kAccF) * kTile);
  L.total = o;
  return L;
}

// the op's inputs
template <class T>
struct Args {
  const T *jp, *jq, *om, *be, *bp, *bq, *sizes, *params;
  int row_stride, lane_stride;   // params[(r*4+k)*row_stride + b*lane_stride]
  const T *gpos, *gn, *xi;
  int J, NB, K, ntac, nsum, B;
};

// K1's outputs (and its scratch for repeated markers), or K1T's
// cotangents: in (null = zero) and out (null = not asked for; `shared`
// holds the per-tile partials of the bits in `want`)
template <class T>
struct Outs {
  T *F, *T_, *tac, *scratch;
  const T *gF, *gT, *gtac;
  T *jp, *jq, *om, *be, *bp, *bq, *params, *shared;
  int want;
};

// offsets in a tile's row of `shared`
__host__ __device__ inline int sh_params(int NB) { return 3 * NB; }
__host__ __device__ inline int sh_gpos(int NB, int K) { return 3 * NB + 4 * K; }
__host__ __device__ inline int sh_xi(int NB, int K) { return 3 * NB + 4 * K + 6; }
__host__ __device__ inline int sh_width(int NB, int K, int nsum) {
  return 3 * NB + 4 * K + 6 + 3 * nsum;
}

// One block: tile t (lanes 32 t ...), cluster rank y, its shared memory,
// and the slots of every block of its cluster (remote[y'], y' < NS).
template <class T>
struct Block {
  const int* plan;      // the plan in device memory
  const int* seg;       // staged tables
  const int* piece;
  int t, y, adj, NS;
  T *frames, *xs, *slots, *buf, *red, *acc;
  T* remote[kMaxSplit];

  __device__ int frame_width() const { return adj ? kFrameT : kFrame; }
  __device__ T fr(int slot, int f, int l) const {
    return frames[(slot * frame_width() + f) * kTile + l];
  }
  // round r's piece of block yy's warp w (or -1)
  __device__ int piece_of(int r, int yy, int w) const {
    const int p = (r * NS + yy) * kWarps + w;
    return p < plan[kHNP] ? p : -1;
  }
  __device__ T* accs(int task, int width, int l) const {
    return acc + task_local(task, NS) * width * kTile + l;
  }
};

template <class T>
__device__ Block<T> carve(const int* plan, unsigned char* smem, int t, int y,
                          bool adj, int ntasks) {
  const Layout L = layout<T>(plan, adj, ntasks);
  Block<T> k;
  k.plan = plan;
  k.seg = reinterpret_cast<const int*>(smem);
  k.piece = k.seg + kSegCols * plan[kHS];
  k.t = t;
  k.y = y;
  k.adj = adj;
  k.NS = plan[kHNS];
  k.frames = reinterpret_cast<T*>(smem + L.frames);
  k.xs = reinterpret_cast<T*>(smem + L.xs);
  k.slots = reinterpret_cast<T*>(smem + L.slots);
  k.buf = reinterpret_cast<T*>(smem + L.buf);
  k.red = reinterpret_cast<T*>(smem + L.red);
  k.acc = reinterpret_cast<T*>(smem + L.acc);
  for (int i = 0; i < kMaxSplit; ++i) k.remote[i] = k.slots;
  return k;
}

// -- staging; a block's threads split each loop (thread tid of nth) ----------

// once: the tables, and the accumulators zeroed
template <class T>
__device__ void stage_tables(const Block<T>& k, int ntasks, int tid,
                             int nth) {
  const int* plan = k.plan;
  int* si = const_cast<int*>(k.seg);
  const int nint = kSegCols * plan[kHS] + kPieceCols * plan[kHNP];
  for (int i = tid; i < nint; i += nth) si[i] = plan[plan[kHOffSeg] + i];
  const Layout L = layout<T>(plan, k.adj, ntasks);
  const int nacc = (L.total - L.acc) / int(sizeof(T));
  for (int i = tid; i < nacc; i += nth) k.acc[i] = T(0);
}

// each round: its segments' per-lane frames and its pieces' points
template <class T>
__device__ void stage_round(const Block<T>& k, const Args<T>& a,
                            const Outs<T>& o, int r, int tid, int nth) {
  const int* plan = k.plan;
  const int* rd = plan + plan[kHOffRound] + kRoundCols * (r * k.NS + k.y);
  const int* stg = plan + plan[kHOffStage] + rd[0];
  const int B = a.B, J = a.J, NB = a.NB;
  const int FW = k.frame_width();
  for (int u = tid; u < rd[1] * kTile; u += nth) {
    const int slot = u / kTile, l = u % kTile, b = k.t * kTile + l;
    const int* sg = k.seg + kSegCols * stg[slot];
    const int j = sg[2], pb = sg[3], pj = sg[4], gt = sg[5], pr = sg[6];
    T* F = k.frames + slot * FW * kTile + l;
    for (int f = 0; f < FW; ++f) F[f * kTile] = T(0);
    if (b >= B) continue;
    auto lj = [&](const T* x, int c, int jj) { return x[(c * J + jj) * B + b]; };
    auto lb = [&](const T* x, int c, int bb) { return x[(c * NB + bb) * B + b]; };
    T q[4], M[3][3];
    for (int c = 0; c < 4; ++c) q[c] = lj(a.jq, c, j);
    quat_to_mat(q, M);
    for (int c = 0; c < 3; ++c) {
      F[(kFp + c) * kTile] = lj(a.jp, c, j);
      F[(kFOm + c) * kTile] = lj(a.om, c, j);
      F[(kFBe + c) * kTile] = lj(a.be, c, j);
      for (int e = 0; e < 3; ++e) F[(kFM + 3 * c + e) * kTile] = M[c][e];
    }
    const T* prm = a.params + b * a.lane_stride;
    for (int e = 0; e < 4; ++e)
      F[(kFPrm + e) * kTile] = prm[(pr * 4 + e) * a.row_stride];
    if (gt != kGround) {
      for (int c = 0; c < 4; ++c) q[c] = lb(a.bq, c, pb);
      quat_to_mat(q, M);
      for (int c = 0; c < 3; ++c) {
        F[(kFc + c) * kTile] = lb(a.bp, c, pb);
        F[(kFOmp + c) * kTile] = lj(a.om, c, pj);
        F[(kFBep + c) * kTile] = lj(a.be, c, pj);
        for (int e = 0; e < 3; ++e) F[(kFR + 3 * c + e) * kTile] = M[c][e];
      }
    }
    if (!k.adj) continue;
    for (int c = 0; c < 3; ++c) {
      if (o.gF) F[(kFgF + c) * kTile] = lj(o.gF, c, j);
      if (o.gT) F[(kFgT + c) * kTile] = lj(o.gT, c, j);
      if (gt != kGround) {
        if (o.gF) F[(kFgFp + c) * kTile] = lj(o.gF, c, pj);
        if (o.gT) F[(kFgTp + c) * kTile] = lj(o.gT, c, pj);
      }
    }
  }
  for (int u = tid; u < kWarps * kCH * 3; u += nth) {
    const int w = u / (kCH * 3), e = u % (kCH * 3);
    const int p = k.piece_of(r, k.y, w);
    const int* pc = k.piece + kPieceCols * (p < 0 ? 0 : p);
    k.xs[u] = p >= 0 && e < 3 * pc[2] ? a.xi[3 * pc[1] + e] : T(0);
  }
}

// a piece's segment frame, read from the staged frames for lane l
template <class T>
struct Frame {
  int j, pb, pj, gt, pr;
  T p[3], M[3][3], om[3], be[3], c[3], R[3][3], omp[3], bep[3], prm[4],
      s[3];
};

template <class T>
__device__ void load_frame(const Block<T>& k, const Args<T>& a, const int* pc,
                           int l, Frame<T>& F) {
  const int* sg = k.seg + kSegCols * pc[0];
  F.j = sg[2];
  F.pb = sg[3];
  F.pj = sg[4];
  F.gt = sg[5];
  F.pr = sg[6];
  const int slot = pc[5];
  for (int c = 0; c < 3; ++c) {
    F.p[c] = k.fr(slot, kFp + c, l);
    F.om[c] = k.fr(slot, kFOm + c, l);
    F.be[c] = k.fr(slot, kFBe + c, l);
    F.c[c] = k.fr(slot, kFc + c, l);
    F.omp[c] = k.fr(slot, kFOmp + c, l);
    F.bep[c] = k.fr(slot, kFBep + c, l);
    F.s[c] = F.gt != kGround ? a.sizes[3 * F.pb + c] : T(0);
    for (int e = 0; e < 3; ++e) {
      F.M[c][e] = k.fr(slot, kFM + 3 * c + e, l);
      F.R[c][e] = k.fr(slot, kFR + 3 * c + e, l);
    }
  }
  for (int e = 0; e < 4; ++e) F.prm[e] = k.fr(slot, kFPrm + e, l);
}

template <class T>
__device__ __forceinline__ void cross3(const T a[3], const T b[3], T c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// the point's world position, relative velocity, SDF, normal and force
template <class T>
__device__ __forceinline__ void point_force(const Frame<T>& F,
                                            const Args<T>& a, const T xi[3],
                                            T x[3], T vr[3], T& phi, T n[3],
                                            T f[3]) {
  for (int i = 0; i < 3; ++i)
    x[i] = F.p[i] + (F.M[i][0] * xi[0] + F.M[i][1] * xi[1] + F.M[i][2] * xi[2]);
  T w[3];
  cross3(F.om, x, w);
  for (int i = 0; i < 3; ++i) vr[i] = w[i] + F.be[i];
  if (F.gt != kGround) {
    cross3(F.omp, x, w);
    for (int i = 0; i < 3; ++i) vr[i] = vr[i] - (w[i] + F.bep[i]);
  }
  const T gp[3] = {a.gpos[0], a.gpos[1], a.gpos[2]};
  const T gn[3] = {a.gn[0], a.gn[1], a.gn[2]};
  T R[3][3], c[3];
  for (int i = 0; i < 3; ++i) {
    c[i] = F.c[i];
    for (int e = 0; e < 3; ++e) R[i][e] = F.R[i][e];
  }
  sdf_normal(F.gt, x, R, c, F.s, gp, gn, phi, n);
  penalty_force(phi, n, vr, F.prm[0], F.prm[1], F.prm[2], F.prm[3], f);
}

// the round's pieces in order: fn(p, source block, its warp)
template <class T, class Fn>
__device__ void for_round_pieces(const Block<T>& k, int r, const Fn& fn) {
#pragma unroll 1
  for (int yy = 0; yy < k.NS; ++yy)
    for (int ww = 0; ww < kWarps; ++ww) {
      const int p = k.piece_of(r, yy, ww);
      if (p >= 0) fn(p, yy, ww);
    }
}

// -- K1 ----------------------------------------------------------------------

// the piece of warp w in round r, for lane l
template <class T>
__device__ void fwd_piece(const Block<T>& k, const Args<T>& a,
                          const Outs<T>& o, int r, int w, int l) {
  const int p = k.piece_of(r, k.y, w);
  if (p < 0) return;
  const int* pc = k.piece + kPieceCols * p;
  const int n = pc[2], trow = pc[3], rep0 = pc[4];
  const int b = k.t * kTile + l;
  const bool live = b < a.B;
  Frame<T> F;
  load_frame(k, a, pc, l, F);
  T fs[3] = {T(0), T(0), T(0)}, ts[3] = {T(0), T(0), T(0)};
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    T x[3], vr[3], phi, nrm[3], f[3], tq[3];
    point_force(F, a, k.xs + (w * kCH + i) * 3, x, vr, phi, nrm, f);
    cross3(x, f, tq);
    for (int c = 0; c < 3; ++c) {
      fs[c] = fs[c] + f[c];
      ts[c] = ts[c] + tq[c];
    }
    if (trow < 0 || !live) continue;
    for (int c = 0; c < 3; ++c) {
      if (rep0 < 0)
        o.tac[(c * a.ntac + trow + i) * a.B + b] = f[c];
      else                              // a marker in several segments
        o.scratch[((rep0 + i) * 3 + c) * a.B + b] = f[c];
    }
  }
  T* s = k.slots + w * kSlotF * kTile + l;
  for (int c = 0; c < 3; ++c) {
    s[c * kTile] = fs[c];
    s[(3 + c) * kTile] = ts[c];
  }
}

// joint task j: add round r's slots, in piece order. The sums run in
// registers: a piece's slot values are loaded together (remote loads from
// the cluster's other blocks, issued back to back), then added.
template <class T>
__device__ void fwd_accumulate(const Block<T>& k, const Args<T>& a, int r,
                               int l, int task) {
  if (task >= a.J) return;
  T* acc = k.accs(task, kAccF, l);
  T sum[kSlotF];
  for (int e = 0; e < kSlotF; ++e) sum[e] = acc[e * kTile];
  for_round_pieces(k, r, [&](int p, int yy, int ww) {
    const int* sg = k.seg + kSegCols * k.piece[kPieceCols * p];
    const bool gen = sg[2] == task, prim = sg[5] != kGround && sg[4] == task;
    if (!gen && !prim) return;
    const T* s = k.remote[yy] + ww * kSlotF * kTile + l;
    T v[kSlotF];
    for (int e = 0; e < kSlotF; ++e) v[e] = s[e * kTile];
    for (int e = 0; e < kSlotF; ++e) {
      if (gen) sum[e] = sum[e] + v[e];
      if (prim) sum[e] = sum[e] - v[e];
    }
  });
  for (int e = 0; e < kSlotF; ++e) acc[e * kTile] = sum[e];
}

// after the last round: a joint's F and T, or a repeated row's forces
// summed over its segments in segment order
template <class T>
__device__ void fwd_finish(const Block<T>& k, const Args<T>& a,
                           const Outs<T>& o, int l, int task) {
  const int b = k.t * kTile + l;
  if (b >= a.B) return;
  if (task < a.J) {
    const T* acc = k.accs(task, kAccF, l);
    for (int c = 0; c < 3; ++c) {
      o.F[(c * a.J + task) * a.B + b] = acc[c * kTile];
      o.T_[(c * a.J + task) * a.B + b] = acc[(3 + c) * kTile];
    }
    return;
  }
  const int* rp = k.plan + k.plan[kHOffRep] + kRepCols * (task - a.J);
  const int* idx = k.plan + k.plan[kHOffRepIdx] + rp[1];
  for (int c = 0; c < 3; ++c) {
    T v = o.scratch[(idx[0] * 3 + c) * a.B + b];
    for (int m = 1; m < rp[2]; ++m)
      v = v + o.scratch[(idx[m] * 3 + c) * a.B + b];
    o.tac[(c * a.ntac + rp[0]) * a.B + b] = v;
  }
}

// -- K1T ---------------------------------------------------------------------

// the cotangents of shared leaves and parameters that are asked for; a
// piece skips the work of the others
template <class T>
__device__ bool want_sizes(const Outs<T>& o) {
  return o.shared && (o.want & kWSizes);
}
template <class T>
__device__ bool want_params(const Args<T>& a, const Outs<T>& o) {
  return a.lane_stride ? o.params != nullptr
                       : o.shared && (o.want & kWParams);
}
template <class T>
__device__ bool want_ground(const Outs<T>& o) {
  return o.shared && (o.want & (kWGpos | kWGn));
}
template <class T>
__device__ bool want_xi(const Outs<T>& o) {
  return o.shared && (o.want & kWXi);
}

// the piece of warp w in round r, for lane l
template <class T>
__device__ void bwd_piece(const Block<T>& k, const Args<T>& a,
                          const Outs<T>& o, int r, int w, int l) {
  const int p = k.piece_of(r, k.y, w);
  if (p < 0) return;
  const int* pc = k.piece + kPieceCols * p;
  const int n = pc[2], trow = pc[3], slot = pc[5];
  const int b = k.t * kTile + l;
  const bool live = b < a.B;
  Frame<T> F;
  load_frame(k, a, pc, l, F);
  const bool prim = F.gt != kGround;
  T gF[3], gT[3], gFp[3], gTp[3];
  for (int c = 0; c < 3; ++c) {
    gF[c] = k.fr(slot, kFgF + c, l);
    gT[c] = k.fr(slot, kFgT + c, l);
    gFp[c] = k.fr(slot, kFgFp + c, l);
    gTp[c] = k.fr(slot, kFgTp + c, l);
  }
  const T gp[3] = {a.gpos[0], a.gpos[1], a.gpos[2]};
  const T gn[3] = {a.gn[0], a.gn[1], a.gn[2]};
  T pb_[3] = {T(0), T(0), T(0)}, Mb[3][3], omb[3] = {T(0), T(0), T(0)},
    beb[3] = {T(0), T(0), T(0)}, ompb[3] = {T(0), T(0), T(0)},
    bepb[3] = {T(0), T(0), T(0)}, cb[3] = {T(0), T(0), T(0)}, Rb[3][3],
    prmb[4] = {T(0), T(0), T(0), T(0)}, sb[3] = {T(0), T(0), T(0)};
  for (int i = 0; i < 3; ++i)
    for (int e = 0; e < 3; ++e) Mb[i][e] = Rb[i][e] = T(0);
  const bool xi_out = want_xi(o);
  T* prm_out = want_params(a, o) ? prmb : nullptr;
  T* size_out = want_sizes(o) ? sb : nullptr;
  T* gpos_out = want_ground(o) ? ompb : nullptr;
  T* gn_out = want_ground(o) ? bepb : nullptr;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const T* xi = k.xs + (w * kCH + i) * 3;
    T x[3], vr[3], phi, nrm[3], f[3], t3[3];
    point_force(F, a, xi, x, vr, phi, nrm, f);
    // F_j += f, T_j += x x f; the primitive's joint: -f, -(x_app x f)
    T fb[3], xb[3];
    cross3(gT, x, t3);
    for (int c = 0; c < 3; ++c) fb[c] = gF[c] + t3[c];
    cross3(f, gT, xb);
    if (prim) {
      cross3(gTp, x, t3);
      for (int c = 0; c < 3; ++c) fb[c] = fb[c] - (gFp[c] + t3[c]);
      // x_app = c + R xi_p, xi_p = R^T (x - c) held fixed
      T xab[3], d[3], xl[3];
      cross3(f, gTp, xab);
      for (int c = 0; c < 3; ++c) d[c] = x[c] - F.c[c];
      for (int c = 0; c < 3; ++c)
        xl[c] = F.R[0][c] * d[0] + F.R[1][c] * d[1] + F.R[2][c] * d[2];
      for (int c = 0; c < 3; ++c) {
        cb[c] = cb[c] - xab[c];
        for (int e = 0; e < 3; ++e) Rb[c][e] = Rb[c][e] - xab[c] * xl[e];
      }
    }
    if (trow >= 0 && o.gtac && live)
      for (int c = 0; c < 3; ++c)
        fb[c] = fb[c] + o.gtac[(c * a.ntac + trow + i) * a.B + b];
    T phib = T(0), nb[3] = {T(0), T(0), T(0)}, vrb[3] = {T(0), T(0), T(0)};
    penalty_force_vjp(phi, nrm, vr, F.prm[0], F.prm[1], F.prm[2], F.prm[3],
                      fb, phib, nb, vrb, prm_out);
    // v_rel = Om x x + be - (Omp x x + bep)
    cross3(x, vrb, t3);
    for (int c = 0; c < 3; ++c) {
      omb[c] = omb[c] + t3[c];
      beb[c] = beb[c] + vrb[c];
    }
    cross3(vrb, F.om, t3);
    for (int c = 0; c < 3; ++c) xb[c] = xb[c] + t3[c];
    if (prim) {
      cross3(x, vrb, t3);
      for (int c = 0; c < 3; ++c) {
        ompb[c] = ompb[c] - t3[c];
        bepb[c] = bepb[c] - vrb[c];
      }
      cross3(vrb, F.omp, t3);
      for (int c = 0; c < 3; ++c) xb[c] = xb[c] - t3[c];
    }
    // (the ground's gpos and gn cotangents share the twist's slots)
    sdf_normal_vjp(F.gt, x, F.R, F.c, F.s, gp, gn, phib, nb, xb, Rb, cb,
                   size_out, gpos_out, gn_out);
    T xib[3];
    point_world_vjp(F.M, xi, xb, pb_, Mb, xi_out ? xib : nullptr);
    if (xi_out)
      for (int c = 0; c < 3; ++c)
        k.buf[((w * kCH + i) * 3 + c) * kTile + l] = live ? xib[c] : T(0);
  }
  T* s = k.slots + w * kSlotT * kTile + l;
  for (int c = 0; c < 3; ++c) {
    s[(kSp + c) * kTile] = pb_[c];
    s[(kSOm + c) * kTile] = omb[c];
    s[(kSBe + c) * kTile] = beb[c];
    s[(kSOmp + c) * kTile] = ompb[c];
    s[(kSBep + c) * kTile] = bepb[c];
    s[(kSc + c) * kTile] = cb[c];
    s[(kSSize + c) * kTile] = sb[c];
    for (int e = 0; e < 3; ++e) {
      s[(kSM + 3 * c + e) * kTile] = Mb[c][e];
      s[(kSR + 3 * c + e) * kTile] = Rb[c][e];
    }
  }
  for (int e = 0; e < 4; ++e) s[(kSPrm + e) * kTile] = prmb[e];
}

// the piece's points' coordinate cotangents summed over the tile's lanes,
// lane 0 to 31; entry e of the piece by lane e mod 32
template <class T>
__device__ void bwd_piece_reduce(const Block<T>& k, const Args<T>& a,
                                 const Outs<T>& o, int r, int w, int l) {
  const int p = k.piece_of(r, k.y, w);
  if (p < 0 || !want_xi(o)) return;
  const int* pc = k.piece + kPieceCols * p;
  T* dst = o.shared + k.t * sh_width(a.NB, a.K, a.nsum) +
           sh_xi(a.NB, a.K) + 3 * pc[1];
  for (int e = l; e < 3 * pc[2]; e += kTile) {
    const T* src = k.buf + (w * kCH * 3 + e) * kTile;
    T v = src[0];
    for (int m = 1; m < kTile; ++m) v = v + src[m];
    dst[e] = v;
  }
}

// which tasks are asked for at all
template <class T>
__device__ bool bwd_live(const Args<T>& a, const Outs<T>& o, int task) {
  if (task < a.J) return o.jp || o.jq || o.om || o.be;
  if (task < a.J + a.NB) return o.bp || o.bq || want_sizes(o);
  if (task < a.J + a.NB + a.K) return want_params(a, o);
  return want_ground(o);
}

// task: add round r's slots, in piece order, to its accumulators (in
// registers, as fwd_accumulate)
template <class T>
__device__ void bwd_accumulate(const Block<T>& k, const Args<T>& a,
                               const Outs<T>& o, int r, int l, int task) {
  if (!bwd_live(a, o, task)) return;
  T* acc = k.accs(task, kAccT, l);
  const int J = a.J, NB = a.NB;
  T sum[kAccT];
  for (int e = 0; e < kAccT; ++e) sum[e] = acc[e * kTile];
  // m slot entries from e0 on, added to sum[a0...]
  auto add = [&](const T* s, int e0, int a0, int m) {
    T v[kAccT];
    for (int e = 0; e < m; ++e) v[e] = s[(e0 + e) * kTile];
    for (int e = 0; e < m; ++e) sum[a0 + e] = sum[a0 + e] + v[e];
  };
  for_round_pieces(k, r, [&](int p, int yy, int ww) {
    const int* sg = k.seg + kSegCols * k.piece[kPieceCols * p];
    const bool prim = sg[5] != kGround;
    const T* s = k.remote[yy] + ww * kSlotT * kTile + l;
    if (task < J) {                                  // joint: p, M, Om, be
      if (sg[2] == task) add(s, 0, 0, 18);
      if (prim && sg[4] == task) add(s, kSOmp, kSOm, 6);
    } else if (task < J + NB) {                      // body: c, R, size
      if (prim && sg[3] == task - J) {
        add(s, kSc, 0, 12);
        add(s, kSSize, 12, 3);
      }
    } else if (task < J + NB + a.K) {                // parameter row
      if (sg[6] == task - J - NB) add(s, kSPrm, 0, 4);
    } else if (!prim) {                              // the ground
      add(s, kSOmp, 0, 6);
    }
  });
  for (int e = 0; e < kAccT; ++e) acc[e * kTile] = sum[e];
}

// after the last round: the task's outputs; values summed over lanes go to
// the warp's red buffer (bwd_finish_reduce)
template <class T>
__device__ void bwd_finish(const Block<T>& k, const Args<T>& a,
                           const Outs<T>& o, int w, int l, int task) {
  if (!bwd_live(a, o, task)) return;
  const int b = k.t * kTile + l;
  const bool live = b < a.B;
  const int B = a.B, J = a.J, NB = a.NB;
  const T* acc = k.accs(task, kAccT, l);
  T* red = k.red + w * kRed * kTile + l;
  auto at = [&](int e) { return acc[e * kTile]; };
  if (task < J) {                                    // joint j
    const int j = task;
    if (!live) return;
    for (int c = 0; c < 3; ++c) {
      if (o.jp) o.jp[(c * J + j) * B + b] = at(kSp + c);
      if (o.om) o.om[(c * J + j) * B + b] = at(kSOm + c);
      if (o.be) o.be[(c * J + j) * B + b] = at(kSBe + c);
    }
    if (o.jq) {
      T q[4], Mb[3][3], qb[4] = {T(0), T(0), T(0), T(0)};
      for (int c = 0; c < 4; ++c) q[c] = a.jq[(c * J + j) * B + b];
      for (int c = 0; c < 3; ++c)
        for (int e = 0; e < 3; ++e) Mb[c][e] = at(kSM + 3 * c + e);
      quat_to_mat_vjp(q, Mb, qb);
      for (int c = 0; c < 4; ++c) o.jq[(c * J + j) * B + b] = qb[c];
    }
  } else if (task < J + NB) {                        // body pb
    const int pb = task - J;
    if (want_sizes(o))
      for (int c = 0; c < 3; ++c) red[c * kTile] = live ? at(12 + c) : T(0);
    if (!live) return;
    if (o.bp)
      for (int c = 0; c < 3; ++c) o.bp[(c * NB + pb) * B + b] = at(c);
    if (o.bq) {
      T q[4], Rb[3][3], qb[4] = {T(0), T(0), T(0), T(0)};
      for (int c = 0; c < 4; ++c) q[c] = a.bq[(c * NB + pb) * B + b];
      for (int c = 0; c < 3; ++c)
        for (int e = 0; e < 3; ++e) Rb[c][e] = at(3 + 3 * c + e);
      quat_to_mat_vjp(q, Rb, qb);
      for (int c = 0; c < 4; ++c) o.bq[(c * NB + pb) * B + b] = qb[c];
    }
  } else if (task < J + NB + a.K) {                  // parameter row
    const int pr = task - J - NB;
    if (a.lane_stride) {
      if (live)
        for (int e = 0; e < 4; ++e) o.params[(pr * 4 + e) * B + b] = at(e);
    } else {
      for (int e = 0; e < 4; ++e) red[e * kTile] = live ? at(e) : T(0);
    }
  } else {                                           // the ground
    for (int e = 0; e < 6; ++e) red[e * kTile] = live ? at(e) : T(0);
  }
}

// the task's red values summed over the tile's lanes (lane 0 to 31), value
// e by lane e, into the tile's row of `shared`
template <class T>
__device__ void bwd_finish_reduce(const Block<T>& k, const Args<T>& a,
                                  const Outs<T>& o, int w, int l, int task) {
  if (!o.shared || !bwd_live(a, o, task)) return;
  const int J = a.J, NB = a.NB;
  int m = 0, dst = 0;
  if (task >= J && task < J + NB) {
    if (want_sizes(o)) m = 3;
    dst = 3 * (task - J);
  } else if (task >= J + NB && task < J + NB + a.K) {
    if (a.lane_stride == 0) m = 4;
    dst = sh_params(NB) + 4 * (task - J - NB);
  } else if (task == J + NB + a.K) {
    m = 6;
    dst = sh_gpos(NB, a.K);
  }
  if (l >= m) return;
  const T* src = k.red + (w * kRed + l) * kTile;
  T v = src[0];
  for (int i = 1; i < kTile; ++i) v = v + src[i];
  o.shared[k.t * sh_width(NB, a.K, a.nsum) + dst + l] = v;
}

#ifdef __CUDACC__
namespace cg = cooperative_groups;

// One tile per cluster (blockIdx.x), rank y = blockIdx.y. ADJ: K1T.
template <bool ADJ>
__global__ void __launch_bounds__(kTile * kWarps)
lane_contact_kernel(const int* __restrict__ plan, Args<float> a,
                    Outs<float> o) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int l = threadIdx.x, w = threadIdx.y;
  const int tid = w * kTile + l, nth = kTile * kWarps;
  const int ntasks = n_tasks(plan, ADJ, a.J, a.NB, a.K);
  Block<float> k = carve<float>(plan, smem, blockIdx.x, blockIdx.y, ADJ,
                                ntasks);
  for (int yy = 0; yy < k.NS; ++yy)
    k.remote[yy] = cl.map_shared_rank(k.slots, yy);
  stage_tables(k, ntasks, tid, nth);
  __syncthreads();
  const int gw = k.y * kWarps + w, nw = k.NS * kWarps;
  for (int r = 0; r < plan[kHRounds]; ++r) {
    stage_round(k, a, o, r, tid, nth);
    __syncthreads();
    if (ADJ) {
      bwd_piece(k, a, o, r, w, l);
      __syncwarp();
      bwd_piece_reduce(k, a, o, r, w, l);
    } else {
      fwd_piece(k, a, o, r, w, l);
    }
    cl.sync();
    for (int task = gw; task < ntasks; task += nw) {
      if (ADJ)
        bwd_accumulate(k, a, o, r, l, task);
      else
        fwd_accumulate(k, a, r, l, task);
    }
    cl.sync();   // the round's slots and frames stay until all have read
  }
  if (!ADJ) __threadfence();   // the repeated markers' scratch
  cl.sync();
  for (int task = gw; task < ntasks; task += nw) {
    if (ADJ) {
      bwd_finish(k, a, o, w, l, task);
      __syncwarp();
      bwd_finish_reduce(k, a, o, w, l, task);
      __syncwarp();
    } else {
      fwd_finish(k, a, o, l, task);
    }
  }
}

template <bool ADJ>
cudaLaunchConfig_t config(const int* hdr, const Args<float>& a,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.B + kTile - 1) / kTile, hdr[kHNS]);
  cfg.blockDim = dim3(kTile, kWarps);
  cfg.dynamicSmemBytes =
      layout<float>(hdr, ADJ, n_tasks(hdr, ADJ, a.J, a.NB, a.K)).total;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = hdr[kHNS];
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel's dynamic shared memory above the 48 KB default (set once per
// size)
template <bool ADJ>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 0;
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      lane_contact_kernel<ADJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <bool ADJ>
int launch(const int* hdr, const int* plan, const Args<float>& a,
           const Outs<float>& o, cudaStream_t stream) {
  if (hdr[kHNS] < 1 || hdr[kHNS] > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<ADJ>(hdr, a, attr);
  cfg.stream = stream;
  cudaError_t err = allow_smem<ADJ>(cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, lane_contact_kernel<ADJ>, plan, a, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool ADJ>
int info(const int* hdr, const Args<float>& a, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, lane_contact_kernel<ADJ>);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<ADJ>(hdr, a, attr);
  err = allow_smem<ADJ>(cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, lane_contact_kernel<ADJ>,
                                       &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(cfg.dynamicSmemBytes);
  out[3] = clusters;
  return 0;
}
#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__
#define LC_ARGS                                                              \
  const int *hdr, const int *plan, const float *jp, const float *jq,         \
      const float *om, const float *be, const float *bp, const float *bq,    \
      const float *sizes, const float *params, int row_stride,               \
      int lane_stride, const float *gpos, const float *gn, const float *xi, \
      int J, int NB, int K, int ntac, int nsum, int B
#define LC_MAKE_ARGS                                                         \
  Args<float>{jp,    jq,   om,         be,          bp, bq,  sizes,          \
              params, row_stride, lane_stride, gpos, gn, xi, J,             \
              NB,    K,    ntac,       nsum,        B}

// Launch K1 on `stream`; `hdr` is the plan's header on the host, `plan` the
// whole plan on the device; `scratch` ((repeated points, 3, B)) holds the
// forces of markers that appear in several segments (null if none).
// Returns the CUDA error (0 = launched).
extern "C" int lane_contact_launch(LC_ARGS, float* F, float* T, float* tac,
                                   float* scratch, void* stream) {
  Outs<float> o = {};
  o.F = F;
  o.T_ = T;
  o.tac = tac;
  o.scratch = scratch;
  return launch<false>(hdr, plan, LC_MAKE_ARGS, o,
                       static_cast<cudaStream_t>(stream));
}

// Launch K1T: the cotangents gF, gT, gtac (any may be null: zero) in; the
// per-lane cotangents (null: not asked for) and, where `want` asks for
// any shared leaf, their per-tile partials `shared` (ntiles, width) out.
extern "C" int lane_contact_adjoint_launch(
    LC_ARGS, const float* gF, const float* gT, const float* gtac,
    float* g_jp, float* g_jq, float* g_om, float* g_be, float* g_bp,
    float* g_bq, float* g_params, float* shared, int want, void* stream) {
  Outs<float> o = {};
  o.gF = gF;
  o.gT = gT;
  o.gtac = gtac;
  o.jp = g_jp;
  o.jq = g_jq;
  o.om = g_om;
  o.be = g_be;
  o.bp = g_bp;
  o.bq = g_bq;
  o.params = g_params;
  o.shared = shared;
  o.want = want;
  return launch<true>(hdr, plan, LC_MAKE_ARGS, o,
                      static_cast<cudaStream_t>(stream));
}

// what the compiler and the card make of the two kernels at a plan and
// its counts (J, NB, K, B): out = [registers, local bytes per thread,
// dynamic shared bytes per block, resident clusters on the device] for K1
// (out[0..3]) and K1T (out[4..7])
extern "C" int lane_contact_kernel_info(const int* hdr, int J, int NB, int K,
                                        int B, int* out) {
  Args<float> a = {};
  a.J = J;
  a.NB = NB;
  a.K = K;
  a.B = B;
  const int err = info<false>(hdr, a, out);
  return err ? err : info<true>(hdr, a, out + 4);
}
#endif  // __CUDACC__
