// Scalar algebra shared by the hand-written kernels: float, double and
// forward-mode dual numbers Dual<T> = v + d eps (eps^2 = 0), nestable
// (Dual<Dual<T>> carries a second tangent, and so on).
//
// Every non-smooth function follows the tie rules of the plain PyTorch
// version (and of jnp), so a derivative taken here equals the one autograd
// takes there:
//   smax2 / smin2   torch.maximum / torch.minimum: half the tangent to each
//                   side at a tie;
//   max3_even       torch.amax over three: the tangents of the tied
//                   arguments averaged;
//   sabs            derivative sign(x), which is 0 at 0;
//   stop            detach(): the primal value as a constant;
//   branches        a `where` takes the chosen branch's derivative.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tsim {

template <class T>
struct Dual {
  T v;  // value (itself dual when nested)
  T d;  // tangent
};

template <class T>
struct BaseOf {
  using type = T;
};
template <class T>
struct BaseOf<Dual<T>> {
  using type = typename BaseOf<T>::type;
};
template <class T>
using base_t = typename BaseOf<T>::type;

// -- constants and primal values --------------------------------------------
template <class S>
struct Lift {
  __device__ __forceinline__ static S of(base_t<S> c) { return c; }
};
template <class T>
struct Lift<Dual<T>> {
  __device__ __forceinline__ static Dual<T> of(base_t<T> c) {
    return {Lift<T>::of(c), Lift<T>::of(base_t<T>(0))};
  }
};
template <class S>
__device__ __forceinline__ S cst(base_t<S> c) {
  return Lift<S>::of(c);
}

__device__ __forceinline__ float pv(float x) { return x; }
__device__ __forceinline__ double pv(double x) { return x; }
template <class T>
__device__ __forceinline__ base_t<T> pv(const Dual<T>& x) {
  return pv(x.v);
}

// -- arithmetic on duals ----------------------------------------------------
template <class T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a,
                                             const Dual<T>& b) {
  return {a.v + b.v, a.d + b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a,
                                             const Dual<T>& b) {
  return {a.v - b.v, a.d - b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a) {
  return {-a.v, -a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a,
                                             const Dual<T>& b) {
  return {a.v * b.v, a.v * b.d + a.d * b.v};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a,
                                             const Dual<T>& b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
// with a base scalar on either side
template <class T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, base_t<T> s) {
  return {a.v + s, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator+(base_t<T> s, const Dual<T>& a) {
  return {s + a.v, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, base_t<T> s) {
  return {a.v - s, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(base_t<T> s, const Dual<T>& a) {
  return {s - a.v, -a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, base_t<T> s) {
  return {a.v * s, a.d * s};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(base_t<T> s, const Dual<T>& a) {
  return {s * a.v, s * a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, base_t<T> s) {
  return {a.v / s, a.d / s};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(base_t<T> s, const Dual<T>& b) {
  const T q = s / b.v;
  return {q, -(q * b.d) / b.v};
}
template <class T, class U>
__device__ __forceinline__ Dual<T>& operator+=(Dual<T>& a, const U& b) {
  a = a + b;
  return a;
}
template <class T, class U>
__device__ __forceinline__ Dual<T>& operator-=(Dual<T>& a, const U& b) {
  a = a - b;
  return a;
}

// -- elementary functions ---------------------------------------------------
__device__ __forceinline__ float ssin(float x) { return sinf(x); }
__device__ __forceinline__ double ssin(double x) { return sin(x); }
__device__ __forceinline__ float scos(float x) { return cosf(x); }
__device__ __forceinline__ double scos(double x) { return cos(x); }
__device__ __forceinline__ float ssqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ssqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float sabs(float x) { return fabsf(x); }
__device__ __forceinline__ double sabs(double x) { return fabs(x); }

template <class T>
__device__ __forceinline__ Dual<T> ssin(const Dual<T>& a) {
  return {ssin(a.v), scos(a.v) * a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> scos(const Dual<T>& a) {
  return {scos(a.v), -(ssin(a.v) * a.d)};
}
template <class T>
__device__ __forceinline__ Dual<T> ssqrt(const Dual<T>& a) {
  const T s = ssqrt(a.v);
  return {s, a.d / (s * base_t<T>(2))};
}

// sign of the primal value as a base scalar: 0 at 0 (torch.sign)
template <class S>
__device__ __forceinline__ base_t<S> ssgn(const S& x) {
  const base_t<S> p = pv(x);
  return base_t<S>((p > base_t<S>(0)) - (p < base_t<S>(0)));
}
template <class T>
__device__ __forceinline__ Dual<T> sabs(const Dual<T>& a) {
  return {sabs(a.v), a.d * ssgn(a.v)};
}

// detach(): the primal value, every tangent zero
template <class S>
__device__ __forceinline__ S stop(const S& x) {
  return cst<S>(pv(x));
}

// max / min that split the tangent at a tie
__device__ __forceinline__ float smax2(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double smax2(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float smin2(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double smin2(double a, double b) {
  return fmin(a, b);
}
template <class T>
__device__ __forceinline__ Dual<T> smax2(const Dual<T>& a, const Dual<T>& b) {
  const base_t<T> pa = pv(a), pb = pv(b);
  if (pa > pb) return a;
  if (pa < pb) return b;
  return (a + b) * base_t<T>(0.5);
}
template <class T>
__device__ __forceinline__ Dual<T> smin2(const Dual<T>& a, const Dual<T>& b) {
  const base_t<T> pa = pv(a), pb = pv(b);
  if (pa < pb) return a;
  if (pa > pb) return b;
  return (a + b) * base_t<T>(0.5);
}
template <class T>
__device__ __forceinline__ Dual<T> smax2(const Dual<T>& a, base_t<T> b) {
  return smax2(a, cst<Dual<T>>(b));
}
template <class T>
__device__ __forceinline__ Dual<T> smin2(const Dual<T>& a, base_t<T> b) {
  return smin2(a, cst<Dual<T>>(b));
}

// the primal part replaced by p (tangents kept)
__device__ __forceinline__ float with_primal(float, float p) { return p; }
__device__ __forceinline__ double with_primal(double, double p) { return p; }
template <class T>
__device__ __forceinline__ Dual<T> with_primal(const Dual<T>& x,
                                               base_t<T> p) {
  return {with_primal(x.v, p), x.d};
}

// torch.amax over three values: the max, its tangent averaged over ties
template <class S>
__device__ __forceinline__ S max3_even(const S& a, const S& b, const S& c) {
  using B = base_t<S>;
  const B pa = pv(a), pb = pv(b), pc = pv(c);
  B m = pa > pb ? pa : pb;
  m = m > pc ? m : pc;
  const int cnt = (pa == m) + (pb == m) + (pc == m);
  if (cnt <= 1) return pa == m ? a : (pb == m ? b : c);
  S s = cst<S>(B(0));
  if (pa == m) s = s + a;
  if (pb == m) s = s + b;
  if (pc == m) s = s + c;
  return with_primal(s * (B(1) / B(cnt)), m);
}

}  // namespace tsim
