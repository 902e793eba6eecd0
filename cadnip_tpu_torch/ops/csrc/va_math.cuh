// The math of the Verilog-A device functions that
// cadnip_tpu_torch/va/cuda.py emits, over double and Dual<N>.
//
// Each function has the value of the torch function that the interpreter of
// cadnip_tpu_torch/va/codegen.py calls, and the derivative that torch's
// autodiff gives it, kinks included: the safe forms (`_safe_exp` with its
// knee at 85, `_limexp_t` at 80, `_safe_ln`, `_safe_sqrt`,
// `_safe_div`, `_SafePow`'s partials), `abs` as where(x >= 0, x, -x) (+1 at
// 0), torch.minimum / maximum (NaN propagates, a tie splits the derivative in
// half) and torch.where (only the arm taken differentiates). Both operands
// of a two-argument function have one type: the emitter lifts a double to
// the dual type where they differ.
#pragma once

#include <cuda_runtime.h>

#include "dual.cuh"

namespace dev {
namespace va {

// torch.where
template <class X>
__device__ __forceinline__ X sel(bool c, const X& a, const X& b) {
  return c ? a : b;
}

// ---- one operand: value, and the derivative through a Dual's chain rule

__device__ __forceinline__ double tmin_(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ double tmax_(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
}

// value r and derivative g of a function at x.v: r + g dx
template <int N>
__device__ __forceinline__ Dual<N> chain(double r, double g,
                                         const Dual<N>& x) {
  Dual<N> o(r);
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = x.d[k] * g;
  return o;
}

// exp(min(x, knee)) (1 + max(x - knee, 0)): the derivative is
// exp(min(x, knee)) on both sides, and at the knee the two halves of the
// tie add up to it
__device__ __forceinline__ double exp_knee(double x, double knee) {
  return exp(tmin_(x, knee)) * (1.0 + tmax_(x - knee, 0.0));
}
template <int N>
__device__ __forceinline__ Dual<N> exp_knee(const Dual<N>& x, double knee) {
  return chain(exp_knee(x.v, knee), exp(tmin_(x.v, knee)), x);
}
template <class X>
__device__ __forceinline__ X exp85(const X& x) { return exp_knee(x, 85.0); }
template <class X>
__device__ __forceinline__ X limexp(const X& x) { return exp_knee(x, 80.0); }

__device__ __forceinline__ double ln(double x) {
  return x > 0.0 ? log(x) : -690.0;
}
template <int N>
__device__ __forceinline__ Dual<N> ln(const Dual<N>& x) {
  if (!(x.v > 0.0)) return Dual<N>(-690.0);
  Dual<N> o(log(x.v));
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = x.d[k] / x.v;
  return o;
}

__device__ __forceinline__ double sqrt_(double x) {
  return x > 0.0 ? sqrt(x) : 0.0;
}
template <int N>
__device__ __forceinline__ Dual<N> sqrt_(const Dual<N>& x) {
  if (!(x.v > 0.0)) return Dual<N>(0.0);
  Dual<N> o(sqrt(x.v));
  const double s = 2.0 * o.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = x.d[k] / s;
  return o;
}

template <class X>
__device__ __forceinline__ X abs_(const X& x) {
  return val(x) >= 0.0 ? x : -x;
}

__device__ __forceinline__ double tanh_(double x) { return tanh(x); }
template <int N>
__device__ __forceinline__ Dual<N> tanh_(const Dual<N>& x) {
  const double r = tanh(x.v);
  return chain(r, 1.0 - r * r, x);
}

// ---- two operands of one type

// torch.minimum / maximum: NaN propagates; at a tie each side takes half
__device__ __forceinline__ double min_(double a, double b) {
  return tmin_(a, b);
}
__device__ __forceinline__ double max_(double a, double b) {
  return tmax_(a, b);
}
template <int N>
__device__ __forceinline__ Dual<N> pick(const Dual<N>& a, const Dual<N>& b,
                                        bool a_wins) {
  if (isnan(a.v) || isnan(b.v)) return a + b;
  if (a.v == b.v) {
    Dual<N> o(a.v);
#pragma unroll
    for (int k = 0; k < N; ++k) o.d[k] = 0.5 * a.d[k] + 0.5 * b.d[k];
    return o;
  }
  return a_wins ? a : b;
}
template <int N>
__device__ __forceinline__ Dual<N> min_(const Dual<N>& a, const Dual<N>& b) {
  return pick(a, b, a.v < b.v);
}
template <int N>
__device__ __forceinline__ Dual<N> max_(const Dual<N>& a, const Dual<N>& b) {
  return pick(a, b, a.v > b.v);
}

// _safe_div: 0 where the divisor is 0
template <class X>
__device__ __forceinline__ X div(const X& a, const X& b) {
  return val(b) == 0.0 ? X(0.0) : a / b;
}

// _SafePow: pow's value; d/da = b a^(b-1), at a = 0 only 1 for b = 1;
// d/db = a^b ln a for a > 0, else 0
__device__ __forceinline__ double pow_(double a, double b) {
  return pow(a, b);
}
template <int N>
__device__ __forceinline__ Dual<N> pow_(const Dual<N>& a, const Dual<N>& b) {
  const double v = pow(a.v, b.v);
  double ga = b.v * pow(a.v == 0.0 ? 1.0 : a.v, b.v - 1.0);
  if (a.v == 0.0) ga = b.v == 1.0 ? 1.0 : 0.0;
  const double gb = a.v > 0.0 ? v * log(a.v) : 0.0;
  Dual<N> o(v);
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = ga * a.d[k] + gb * b.d[k];
  return o;
}

}  // namespace va
}  // namespace dev
