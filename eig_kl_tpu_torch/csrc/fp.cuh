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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes of shared memory into registers, as a volatile asm statement:
// the compiler may neither drop it nor load the same bytes again later
// instead of keeping them in registers (which it does to a plain load of
// memory that nothing writes in between).
__device__ __forceinline__ void load16(float4& v, const float4* p) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void load16(double2& v, const double2* p) {
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];" : "=d"(v.x), "=d"(v.y) : "r"(smem_addr(p)) : "memory");
}

// A chain over `count` values of one or two 16-byte-aligned arrays in
// shared memory, in index order: acc = step(acc, a[i]) (kArrays = 1) or
// step(acc, a[i], b[i]) (kArrays = 2); count is a multiple of kGroup, and
// kGroup of 16 bytes' values.  The values come into registers a group at a
// time, 16 bytes per load (load16), in two register buffers taken in
// turns: the loads of the next group are spread between the steps of the
// current one (one every kGroup / loads steps), so that only the step's
// latency stands on the chain.  (Where they came as one run, the compiler
// placed them after the current group's steps, and each group waited for
// its loads.)  The arrays must be written before the call.  K4's fused
// multiply-add chain and K6's add chains.
template <int kGroup, int kArrays, class T, class Step>
__device__ __forceinline__ T chain(const T* a, const T* b, int count, T acc, Step step) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kWidth;
  constexpr int kQ = kGroup / kV;        // 16-byte vectors per array and group
  constexpr int kLoads = kArrays * kQ;   // loads per group
  constexpr int kEvery = kGroup / kLoads;  // steps per load
  static_assert(kGroup % kV == 0 && (kArrays == 1 || kArrays == 2) && kGroup % kLoads == 0,
                "a group is whole vectors, its loads spread evenly");
  const V* va = reinterpret_cast<const V*>(a);
  const V* vb = reinterpret_cast<const V*>(b);
  V a0[kQ], b0[kArrays == 2 ? kQ : 1], a1[kQ], b1[kArrays == 2 ? kQ : 1];
  // Load l of group g: vector l / 2 of a (l even) or of b (l odd), or
  // vector l of a.
  auto load = [&](V* ra, V* rb, int g, int l) {
    if constexpr (kArrays == 2) {
      if (l % 2 == 0) {
        load16(ra[l / 2], va + g / kV + l / 2);
      } else {
        load16(rb[l / 2], vb + g / kV + l / 2);
      }
    } else {
      load16(ra[l], va + g / kV + l);
    }
  };
  // The steps of the group in (ra, rb), with the loads of group `next`
  // into (na, nb) between them.
  auto run = [&](const V* ra, const V* rb, V* na, V* nb, int next) {
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      if (e % kEvery == 0) load(na, nb, next, e / kEvery);
      if constexpr (kArrays == 2) {
        acc = step(acc, vec_at(ra[e / kV], e % kV), vec_at(rb[e / kV], e % kV));
      } else {
        acc = step(acc, vec_at(ra[e / kV], e % kV));
      }
    }
  };
  if (count <= 0) return acc;
  // The loads are unconditional (the last group is loaded again at the
  // end), so that no branch stands between them and the steps.
  const int last = count - kGroup;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) load(a0, b0, 0, l);
  for (int g = kGroup;; g += 2 * kGroup) {
    run(a0, b0, a1, b1, min(g, last));
    if (g >= count) break;
    run(a1, b1, a0, b0, min(g + kGroup, last));
    if (g + kGroup >= count) break;
  }
  return acc;
}

}  // namespace
