// The selection helpers of the KL pass, shared by K2 (csrc/kl_pass.cu, in
// f32 and f64) and K5 (csrc/smega.cu, f32), so that the two keep one tie
// rule: the first maximum of D = -(sf * a_s) per side, "larger, or equal
// (+0 == -0) at a lower index", through a per-128-node row-max cache or a
// flat scan.  Templated on the float type T.  Every product is an explicit
// rounded intrinsic (csrc/fp.cuh), so the passes reproduce their plain
// PyTorch versions' bits.

#pragma once

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 128;  // nodes per cached row
constexpr unsigned kFull = 0xffffffffu;

// (v2, i2) beats (v1, i1): a larger value, or an equal one at a lower index.
template <class T>
__device__ __forceinline__ bool beats(T v2, int i2, T v1, int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

template <class T>
__device__ __forceinline__ void warp_argmax(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T v2 = __shfl_down_sync(kFull, v, off);
    const int i2 = __shfl_down_sync(kFull, i, off);
    if (beats(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
}

__device__ __forceinline__ int warp_sum(int c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(kFull, c, off);
  return c;
}

template <class T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_of(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// D = -(sf * a_s) of one node, the value the scan, the cache and the lane
// search compare.
template <class T>
__device__ __forceinline__ T gain_d(T f, T a) {
  return -mul_rn(f, a);
}

// The flat scan's step: indices reach a thread in increasing order, so a
// strict > keeps the first maximum of each side.
template <class T>
__device__ __forceinline__ void consider(T f, T a, int idx, T& vl, int& il, T& vr, int& ir) {
  const T d = gain_d(f, a);
  if (f > T(0)) {
    if (d > vl) {
      vl = d;
      il = idx;
    }
  } else if (f < T(0)) {
    if (d > vr) {
      vr = d;
      ir = idx;
    }
  }
}

// Nodes 4q .. 4q + 3 of p (16-byte aligned): one float4, or two double2.
__device__ __forceinline__ void load4(const float* p, size_t q, float (&out)[4]) {
  const float4 v = reinterpret_cast<const float4*>(p)[q];
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, size_t q, double (&out)[4]) {
  const double2 lo = reinterpret_cast<const double2*>(p)[2 * q];
  const double2 hi = reinterpret_cast<const double2*>(p)[2 * q + 1];
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = hi.x;
  out[3] = hi.y;
}

// One start's (or shard's) row-max cache: rm_l[rows] and rm_r[rows] (T),
// then dirty[ceil(rows / 32)] and list[list_cap] (4-byte words).
template <class T>
struct Cache {
  T* rm_l;
  T* rm_r;
  unsigned* dirty;
  int* list;
};

// Both sides' maxima of row r of the state (sf, as), computed by one warp
// (lane k holds nodes 128r + 4k .. 128r + 4k + 3) and written by lane 0.
template <class T>
__device__ __forceinline__ void refresh_row(const T* sf, const T* as, const Cache<T>& c, int r,
                                            int lane) {
  T fs[4], as4[4];
  load4(sf, static_cast<size_t>(r) * (kRow / 4) + lane, fs);
  load4(as, static_cast<size_t>(r) * (kRow / 4) + lane, as4);
  T ml = neg_inf<T>(), mr = neg_inf<T>();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T d = gain_d(fs[k], as4[k]);
    if (fs[k] > T(0)) ml = max_of(ml, d);
    if (fs[k] < T(0)) mr = max_of(mr, d);
  }
  ml = warp_max(ml);
  mr = warp_max(mr);
  if (lane == 0) {
    c.rm_l[r] = ml;
    c.rm_r[r] = mr;
  }
}

// Marks row r dirty; the first to mark it appends it to the list (rows
// beyond list_cap are found by a walk over the dirty bits instead).
template <class T>
__device__ __forceinline__ void mark(const Cache<T>& c, int r, int list_cap, int* count) {
  const unsigned bit = 1u << (r & 31);
  if (atomicOr(&c.dirty[r >> 5], bit) & bit) return;
  const int k = atomicAdd(count, 1);
  if (k < list_cap) c.list[k] = r;
}

// Adds coef * w into a_s (`as`, at offsets local to the stripe [r0, r0 +
// n_local)) over the entries of one CSR row whose columns lie in the
// stripe; with the cache, marks their rows; where wab is given, the thread
// that meets column b records its weight there.  Neighbours in one row are
// distinct, so no two threads touch one entry.
template <bool kCache, class T>
__device__ __forceinline__ void update_row(const int* indptr, const int* indices, const T* data,
                                           T* as, int row, int r0, int n_local, T coef, int b,
                                           T* wab, const Cache<T>& c, int list_cap, int* count) {
  const int lo = indptr[row];
  const int deg = indptr[row + 1] - lo;
  for (int k = threadIdx.x; k < deg; k += kThreads) {
    const int j = indices[lo + k];
    const int jl = j - r0;
    if (static_cast<unsigned>(jl) >= static_cast<unsigned>(n_local)) continue;
    const T w = data[lo + k];
    as[jl] = add_rn(as[jl], mul_rn(coef, w));
    if (wab != nullptr && j == b) *wab = w;
    if constexpr (kCache) mark(c, jl / kRow, list_cap, count);
  }
}

}  // namespace
