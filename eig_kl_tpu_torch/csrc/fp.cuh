// Explicitly rounded arithmetic for kernels templated on their float type
// (float or double): one overload per type of each operation, so that a
// kernel rounds every multiply, add, subtract, divide and root on its own,
// as its plain PyTorch version does.  nvcc contracts a * b + c into one
// fused multiply-add unless each operation is an intrinsic.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }

// a * b + c as the port's plain versions round it: in f32 one fused
// multiply-add, as XLA's CPU fusion contracts a product into the add that
// takes it; in f64 the rounded product, then the add (PyTorch has no exact
// f64 fused multiply-add).
__device__ __forceinline__ float mul_add(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) {
  return __dadd_rn(__dmul_rn(a, b), c);
}

// The square root of a sum as the plain versions take it: an f32 root in
// f64, rounded once (the correctly rounded f32 root); an f64 root as it is.
__device__ __forceinline__ float root_rn(float s) {
  return __double2float_rn(__dsqrt_rn(static_cast<double>(s)));
}
__device__ __forceinline__ double root_rn(double s) { return __dsqrt_rn(s); }

template <class T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() {
  return __int_as_float(0xff800000);
}
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double(0xfff0000000000000ULL);
}

// The 16-byte vector of T: the widest load a thread issues (Hopper has no
// 32-byte load), 4 floats or 2 doubles.
template <class T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int kWidth = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int kWidth = 2;
};

// Element e of a 16-byte vector (e a constant once the caller's loop is
// unrolled, so the vector stays in registers), and the vector of an array.
__device__ __forceinline__ float vec_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double vec_at(const double2& v, int e) { return e == 0 ? v.x : v.y; }
__device__ __forceinline__ float4 vec_of(const float (&a)[4]) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ double2 vec_of(const double (&a)[2]) { return make_double2(a[0], a[1]); }

}  // namespace
