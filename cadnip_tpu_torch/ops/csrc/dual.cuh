// Forward-mode dual numbers for kernel K2's device functions.
//
// Dual<N> carries a value and its N partial derivatives with respect to an
// instance's local unknowns. A device residual written once as a template
// over its number type, and evaluated on Dual<N> seeded with the unit
// tangents, yields f and q together with the local Jacobians df/du and
// dq/du in one pass: what jax.linearize with basis tangents gives the
// reference kernel, and what torch.func.jacrev gives the port's twin.
//
// Kinks follow the twin's autodiff conventions, not a textbook's: clamps
// pass the derivative when the value sits ON a bound (torch.clamp's
// backward is inclusive), |x| has derivative 0 at x = 0, and a select
// (torch.where) differentiates only the branch it takes.
#pragma once

#include <cuda_runtime.h>

template <int N>
struct Dual {
  double v;
  double d[N];

  __device__ Dual() : v(0.0) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = 0.0;
  }
  __device__ Dual(double x) : v(x) {  // NOLINT: constants promote
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = 0.0;
  }
  // the local unknown `seed` itself: value x, unit tangent
  __device__ static Dual var(double x, int seed) {
    Dual r(x);
    r.d[seed] = 1.0;
    return r;
  }
};

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r(a.v + b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r(a.v - b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r(-a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r(a.v * b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r(a.v / b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}
// mixed forms: a constant operand has no tangent
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, double b) {
  Dual<N> r = a;
  r.v = a.v + b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(double a, const Dual<N>& b) {
  return b + a;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, double b) {
  Dual<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(double a, const Dual<N>& b) {
  Dual<N> r(a - b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, double b) {
  Dual<N> r(a.v * b);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(double a, const Dual<N>& b) {
  Dual<N> r(a * b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a * b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, double b) {
  Dual<N> r(a.v / b);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(double a, const Dual<N>& b) {
  Dual<N> r(a / b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -r.v * b.d[k] / b.v;
  return r;
}

// ---- elementary functions, overloaded for double and Dual<N>

__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <int N>
__device__ __forceinline__ Dual<N> dexp(const Dual<N>& a) {
  Dual<N> r(exp(a.v));
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * r.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dlog(const Dual<N>& a) {
  Dual<N> r(log(a.v));
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / a.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dabs(const Dual<N>& a) {
  // sign(0) = 0: the derivative of |x| vanishes at x = 0
  const double s = a.v > 0.0 ? 1.0 : (a.v < 0.0 ? -1.0 : 0.0);
  Dual<N> r(fabs(a.v));
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = s * a.d[k];
  return r;
}

__device__ __forceinline__ double val(double x) { return x; }
template <int N>
__device__ __forceinline__ double val(const Dual<N>& a) { return a.v; }

// clamp with a constant bound: the derivative passes where the value lies
// within the bounds, bounds included; NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min(const T& x, double lo) {
  return val(x) < lo ? T(lo) : x;
}
template <typename T>
__device__ __forceinline__ T clamp_max(const T& x, double hi) {
  return val(x) > hi ? T(hi) : x;
}
template <typename T>
__device__ __forceinline__ T clip(const T& x, double lo, double hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
