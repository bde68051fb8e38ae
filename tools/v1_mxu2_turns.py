"""Other designs of ``spmv_v1_f32`` and of the mxu2 forms of the v2 SpMV
(``eig_kl_tpu_torch/csrc/spmv_csr.cu``): the ones they replaced, and one
tried and not kept, built from the strings below so that ``chip_smoke.py``
times them beside the kernels in the same call, in turns (new, earlier,
earlier, new), on the same layouts and inputs:

* ``spmv_v1_earlier_f32``: one 512-thread block per y window walks the
  window's chunks one after another, each chunk's scan in shared memory
  (9 steps, 18 block barriers);
* ``spmv_v2_mxu2[_bf16i|_bf16w]_earlier_f32``: a lane per row (K1's warp
  per 32 rows) carrying the 4 (or 2) partials, a switch on each entry's
  slot class;
* the same with ``_group``: a group of 4 (or 2) threads per row, a
  partial per thread, the design first proposed for them, which the card
  timed slower than the kernel's branch-free lane per row.

Each takes the arguments of the kernel it stands beside (``spmv_v1_earlier``
those of ``spmv_v1_f32`` before its scratch and tickets) and gives its bits.
The templates keep their lazy-walk branch, but no lazy walk is built from
them: the port's lazy walks now gather ``z = dsinv * w`` and take it as an
argument, and ``tools/lazy_walk_turns.py`` holds their earlier design.
Nothing here is imported by the port.  Needs ``nvcc`` and a card::

    python3 -c "import tools.v1_mxu2_turns as T; T.build()"
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "eig_kl_tpu_torch" / "_build" / "turns"

_PREAMBLE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 8;
constexpr int kStage = 32 * kPerLane;

"""

#: The earlier spmv_v1_f32 (a block per y window), verbatim.
V1_EARLIER = _PREAMBLE + r"""
constexpr int kV1Chunk = 512;
constexpr int kV1Window = 1024;

__global__ void __launch_bounds__(kV1Chunk)
spmv_v1_kernel(const int* __restrict__ x_base, const short* __restrict__ col_local,
               const short* __restrict__ row_local, const float* __restrict__ w,
               const int* __restrict__ win_ptr, const int* __restrict__ win_chunks,
               const float* __restrict__ x, float* __restrict__ y, int n, int rows) {
  __shared__ float e_s[kV1Chunk];
  __shared__ int r_s[kV1Chunk + 1];
  __shared__ float y_s[kV1Window];
  const int t = threadIdx.x;
  const int win = blockIdx.x;
  y_s[t] = 0.0f;
  y_s[t + kV1Chunk] = 0.0f;
  if (t == 0) r_s[kV1Chunk] = -1;  // slot 511 always ends its segment
  for (int i = win_ptr[win]; i < win_ptr[win + 1]; ++i) {
    const int c = win_chunks[i];
    const long long slot = static_cast<long long>(c) * kV1Chunk + t;
    const int cl = x_base[c] + col_local[slot];
    const float g = __fadd_rn(cl < n ? x[cl] : 0.0f, 0.0f);
    float e = __fmul_rn(g, w[slot]);
    const int r = row_local[slot];
    r_s[t] = r;
    e_s[t] = e;
    __syncthreads();
    for (int k = 1; k < kV1Chunk; k <<= 1) {
      const float add = (t >= k && r_s[t - k] == r) ? e_s[t - k] : 0.0f;
      __syncthreads();
      e = __fadd_rn(e, add);
      e_s[t] = e;
      __syncthreads();
    }
    if (r_s[t + 1] != r) y_s[r] = __fadd_rn(y_s[r], e);
    __syncthreads();
  }
  const long long row = static_cast<long long>(win) * kV1Window + t;
  if (row < rows) y[row] = y_s[t];
  if (row + kV1Chunk < rows) y[row + kV1Chunk] = y_s[t + kV1Chunk];
}
""" + r"""
}  // namespace

extern "C" int spmv_v1_earlier_f32(const void* x_base, const void* col_local, const void* row_local,
                                   const void* w, const void* win_ptr, const void* win_chunks,
                                   const void* x, void* y, int n, int rows, int windows, void* stream) {
  if (rows < n || rows > windows * kV1Window) return static_cast<int>(cudaErrorInvalidValue);
  if (windows > 0) {
    spmv_v1_kernel<<<windows, kV1Chunk, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x_base), static_cast<const short*>(col_local),
        static_cast<const short*>(row_local), static_cast<const float*>(w),
        static_cast<const int*>(win_ptr), static_cast<const int*>(win_chunks),
        static_cast<const float*>(x), static_cast<float*>(y), n, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

#: The earlier v2 kernel template, of which its mxu2 entry points are built.
MXU2_EARLIER = _PREAMBLE + r"""
constexpr int kV2Chunk = kStage;  // entries a warp stages at a time
constexpr int kV2Seq = 0, kV2Lanes = 1, kV2Blocks = 2;  // the reduce's orders

template <bool kBf16>
__device__ __forceinline__ float product(float w, float x) {
  const float p = __fmul_rn(w, x);
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(p));
  } else {
    return p;
  }
}

__device__ __forceinline__ float weight(const float* w) { return __ldg(w); }
__device__ __forceinline__ float weight(const __nv_bfloat16* w) { return __bfloat162float(__ldg(w)); }

template <bool kBf16, bool kLazy, int kReduce, class TW>
__global__ void __launch_bounds__(kThreads)
spmv_v2_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
               const TW* __restrict__ w, const short* __restrict__ slot, int shift, int lanes,
               const int* __restrict__ tail_warp,
               const int* __restrict__ tail_rows, const int* __restrict__ tail_cols,
               const float* __restrict__ tail_w, const float* __restrict__ tail_y,
               const float* __restrict__ x,
               const float* __restrict__ dsinv, float* __restrict__ y, int n, int rows) {
  static_assert(kBf16 || std::is_same_v<TW, float>, "bf16 weights come with bf16 products");
  constexpr int kSlotBits = kReduce == kV2Seq ? 0 : 9;
  __shared__ float e_s[kWarps][kV2Chunk];
  __shared__ int g_s[kWarps][kV2Chunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= rows) return;
  const int row = r0 + lane;
  auto gather = [&](int j) {
    if constexpr (kLazy) {
      return __fmul_rn(__ldg(dsinv + j), __ldg(x + j));
    } else {
      return __ldg(x + j);
    }
  };
  float sum = 0.0f;
  if (r0 < n) {  // whole warps: the __syncwarp calls below see every lane
    const int lo = __ldg(ptr + min(row, n - 1));
    const int hi = row < n ? __ldg(ptr + min(row, n - 1) + 1) : lo;
    const int span_lo = __ldg(ptr + r0);
    const int span_hi = __ldg(ptr + min(r0 + 32, n));
    const int t_lo = tail_warp != nullptr ? __ldg(tail_warp + (r0 >> 5)) : 0;
    const int t_hi = tail_warp != nullptr ? __ldg(tail_warp + (r0 >> 5) + 1) : 0;
    // The partials of the current sub-chunk: part (kV2Lanes: p0 .. p3, one
    // per slot % lanes; kV2Blocks: the block sums so far, blk the current
    // 32-slot block's).
    float part = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f, blk = 0.0f;
    int group = -1;  // the first entry's flush adds +0 to +0
    int block = -1;
    auto flush = [&]() {
      if constexpr (kReduce == kV2Lanes) {
        const float pair = __fadd_rn(part, p1);
        sum = __fadd_rn(sum, lanes == 4 ? __fadd_rn(pair, __fadd_rn(p2, p3)) : pair);
        p1 = p2 = p3 = 0.0f;
      } else if constexpr (kReduce == kV2Blocks) {
        sum = __fadd_rn(sum, __fadd_rn(part, blk));
        blk = 0.0f;
      } else {
        sum = __fadd_rn(sum, part);
      }
      part = 0.0f;
    };
    for (int c0 = span_lo; c0 < span_hi; c0 += kV2Chunk) {
      const int len = min(kV2Chunk, span_hi - c0);
      int col[kPerLane];
      int sl[kPerLane];
      float wt[kPerLane];
      float xg[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = min(lane + 32 * q, len - 1);
        col[q] = __ldg(cols + c0 + i);
        wt[q] = weight(w + c0 + i);
        if constexpr (kReduce != kV2Seq) sl[q] = __ldg(slot + c0 + i);
      }
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) xg[q] = gather(col[q]);
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = lane + 32 * q;
        if (i < len) {
          e_s[warp][i] = product<kBf16>(wt[q], xg[q]);
          int key = col[q] >> shift;
          if constexpr (kReduce != kV2Seq) key = (key << kSlotBits) | sl[q];
          g_s[warp][i] = key;
        }
      }
      __syncwarp();
      const int ke = min(hi, c0 + len);
      for (int k = max(lo, c0); k < ke; ++k) {
        const int gs = g_s[warp][k - c0];
        const int gk = gs >> kSlotBits;
        const float e = e_s[warp][k - c0];
        if (gk != group) {
          flush();
          group = gk;
          block = -1;
        }
        if constexpr (kReduce == kV2Lanes) {
          switch (gs & (lanes - 1)) {
            case 0: part = __fadd_rn(part, e); break;
            case 1: p1 = __fadd_rn(p1, e); break;
            case 2: p2 = __fadd_rn(p2, e); break;
            default: p3 = __fadd_rn(p3, e); break;
          }
        } else if constexpr (kReduce == kV2Blocks) {
          const int b = (gs & 511) >> 5;
          if (b != block) {
            part = __fadd_rn(part, blk);
            blk = 0.0f;
            block = b;
          }
          blk = __fadd_rn(blk, e);
        } else {
          part = __fadd_rn(part, e);
        }
      }
      __syncwarp();
    }
    flush();
    if (row < n && tail_y != nullptr) {
      sum = __fadd_rn(sum, __ldg(tail_y + row));
    } else {
      for (int k = t_lo; k < t_hi; ++k) {
        if (__ldg(tail_rows + k) == row) {
          sum = __fadd_rn(sum, __fmul_rn(__ldg(tail_w + k), gather(__ldg(tail_cols + k))));
        }
      }
    }
  }
  if (row >= rows) return;
  if constexpr (kLazy) {
    y[row] = __fmul_rn(0.5f, __fmaf_rn(__ldg(dsinv + row), sum, __ldg(x + row)));
  } else {
    y[row] = sum;
  }
}

""" + r"""
int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

#define MXU2_ENTRY(NAME, BF16, LAZY, TW)                                                                \
  extern "C" int NAME(const void* ptr, const void* cols, const void* w, const void* slot, int shift,    \
                      int lanes, const void* tail_warp, const void* tail_rows, const void* tail_cols,   \
                      const void* tail_w, const void* tail_y, const void* x, const void* dsinv, void* y, \
                      int n, int rows, void* stream) {                                                  \
    if (lanes != 2 && lanes != 4) return static_cast<int>(cudaErrorInvalidValue);                       \
    if (rows > 0) {                                                                                     \
      spmv_v2_kernel<BF16, LAZY, kV2Lanes, TW><<<blocks_for(rows), kThreads, 0,                         \
                                                 static_cast<cudaStream_t>(stream)>>>(                  \
          static_cast<const int*>(ptr), static_cast<const int*>(cols), static_cast<const TW*>(w),       \
          static_cast<const short*>(slot), shift, lanes, static_cast<const int*>(tail_warp),            \
          static_cast<const int*>(tail_rows), static_cast<const int*>(tail_cols),                       \
          static_cast<const float*>(tail_w), static_cast<const float*>(tail_y),                         \
          static_cast<const float*>(x), static_cast<const float*>(dsinv), static_cast<float*>(y), n,    \
          rows);                                                                                        \
    }                                                                                                   \
    return static_cast<int>(cudaGetLastError());                                                        \
  }

#define MXU2_FORMS(SUFFIX)                                                              \
  MXU2_ENTRY(spmv_v2_mxu2##SUFFIX##_f32, false, false, float)                           \
  MXU2_ENTRY(spmv_v2_mxu2_bf16i##SUFFIX##_f32, true, false, float)                      \
  MXU2_ENTRY(spmv_v2_mxu2_bf16w##SUFFIX##_f32, true, false, __nv_bfloat16)

MXU2_FORMS(_earlier)
"""

#: The group design of the mxu2 forms, timed against the kernel's and
#: slower (PERF.md §6): a group of 4 (or 2) threads per row, thread j
#: adding the entries of slot class j, the partials added pairwise by xor
#: shuffles within the group where the sub-chunk changes.
MXU2_GROUP = _PREAMBLE + r"""
constexpr int kV2Chunk = kStage;

template <bool kBf16>
__device__ __forceinline__ float product(float w, float x) {
  const float p = __fmul_rn(w, x);
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(p));
  } else {
    return p;
  }
}

__device__ __forceinline__ float weight(const float* w) { return __ldg(w); }
__device__ __forceinline__ float weight(const __nv_bfloat16* w) { return __bfloat162float(__ldg(w)); }

// x[j], or the lazy walk's dsinv[j] * w[j] (one rounding).
template <bool kLazy>
__device__ __forceinline__ float v2_gather(const float* __restrict__ x, const float* __restrict__ dsinv, int j) {
  if constexpr (kLazy) {
    return __fmul_rn(__ldg(dsinv + j), __ldg(x + j));
  } else {
    return __ldg(x + j);
  }
}

// One stage of a warp's span: entries c0 .. c0 + len - 1 (len <= kV2Chunk)
// into e (the rounded products) and g (the sub-chunk col >> shift, with the
// slot in the low 9 bits where kSlots), by the warp's 32 lanes, loads
// coalesced and kPerLane gathers of x in flight per lane.
template <bool kBf16, bool kLazy, bool kSlots, class TW>
__device__ __forceinline__ void v2_stage(const int* __restrict__ cols, const TW* __restrict__ w,
                                         const short* __restrict__ slot, int shift,
                                         const float* __restrict__ x, const float* __restrict__ dsinv,
                                         int c0, int len, int lane, float* e, int* g) {
  int col[kPerLane];
  int sl[kPerLane];
  float wt[kPerLane];
  float xg[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = min(lane + 32 * q, len - 1);
    col[q] = __ldg(cols + c0 + i);
    wt[q] = weight(w + c0 + i);
    if constexpr (kSlots) sl[q] = __ldg(slot + c0 + i);
  }
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) xg[q] = v2_gather<kLazy>(x, dsinv, col[q]);
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = lane + 32 * q;
    if (i < len) {
      e[i] = product<kBf16>(wt[q], xg[q]);
      int key = col[q] >> shift;
      if constexpr (kSlots) key = (key << 9) | sl[q];
      g[i] = key;
    }
  }
}

// The row's tail: tail_y's value (the v1 tail's A @ x), or the COO tail's
// triplets of the row among the 32-row group's t_lo .. t_hi, each added as
// round(w * x[col]) in CSR order.
template <bool kLazy>
__device__ __forceinline__ float v2_tail(float sum, int row, int n, int t_lo, int t_hi,
                                         const int* __restrict__ tail_rows, const int* __restrict__ tail_cols,
                                         const float* __restrict__ tail_w, const float* __restrict__ tail_y,
                                         const float* __restrict__ x, const float* __restrict__ dsinv) {
  if (row < n && tail_y != nullptr) return __fadd_rn(sum, __ldg(tail_y + row));
  for (int k = t_lo; k < t_hi; ++k) {
    if (__ldg(tail_rows + k) == row) {
      sum = __fadd_rn(sum, __fmul_rn(__ldg(tail_w + k), v2_gather<kLazy>(x, dsinv, __ldg(tail_cols + k))));
    }
  }
  return sum;
}

// y[row] = sum, or the lazy walk's 0.5 * fma(dsinv, sum, w).
template <bool kLazy>
__device__ __forceinline__ void v2_store(float* __restrict__ y, const float* __restrict__ x,
                                         const float* __restrict__ dsinv, int row, float sum) {
  if constexpr (kLazy) {
    y[row] = __fmul_rn(0.5f, __fmaf_rn(__ldg(dsinv + row), sum, __ldg(x + row)));
  } else {
    y[row] = sum;
  }
}

// The mxu2 order's kernel: a group of kL threads (4 or 2, the dot's
// partials) per row, 32 / kL rows per warp.  The warp stages its rows'
// span as spmv_v2_kernel does; then every thread of a row's group walks the
// row's staged entries, thread j adding the entries of slot class j (slot %
// kL) into its partial, so that the kL partials are kL threads' registers
// and no thread branches on a class.  Where the sub-chunk changes, the
// group adds its partials pairwise with two xor shuffles, (p0 + p1) + (p2 +
// p3) (or p0 + p1), into the row's sum, which each thread of the group
// keeps; the group's first thread adds the tail and writes y.  Rows of a
// warp diverge, so each shuffle names its group's lanes alone.
template <bool kBf16, bool kLazy, int kL, class TW>
__global__ void __launch_bounds__(kThreads)
spmv_v2_mxu2_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                    const TW* __restrict__ w, const short* __restrict__ slot, int shift,
                    const int* __restrict__ tail_warp,
                    const int* __restrict__ tail_rows, const int* __restrict__ tail_cols,
                    const float* __restrict__ tail_w, const float* __restrict__ tail_y,
                    const float* __restrict__ x,
                    const float* __restrict__ dsinv, float* __restrict__ y, int n, int rows) {
  static_assert(kBf16 || std::is_same_v<TW, float>, "bf16 weights come with bf16 products");
  static_assert(kL == 2 || kL == 4, "the dot keeps 2 or 4 partials");
  constexpr int kRows = 32 / kL;  // rows per warp
  __shared__ float e_s[kWarps][kV2Chunk];
  __shared__ int g_s[kWarps][kV2Chunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + warp) * kRows;
  if (r0 >= rows) return;
  const int row = r0 + lane / kL;
  const int j = lane % kL;
  const unsigned mask = ((1u << kL) - 1) << (lane & ~(kL - 1));
  float sum = 0.0f;
  if (r0 < n) {  // whole warps: the __syncwarp calls below see every lane
    const int lo = __ldg(ptr + min(row, n - 1));
    const int hi = row < n ? __ldg(ptr + min(row, n - 1) + 1) : lo;
    const int span_lo = __ldg(ptr + r0);
    const int span_hi = __ldg(ptr + min(r0 + kRows, n));
    float part = 0.0f;
    int group = -1;  // the first entry's flush adds +0 to +0
    auto flush = [&]() {
      float pair = __fadd_rn(part, __shfl_xor_sync(mask, part, 1));
      if constexpr (kL == 4) pair = __fadd_rn(pair, __shfl_xor_sync(mask, pair, 2));
      sum = __fadd_rn(sum, pair);
      part = 0.0f;
    };
    for (int c0 = span_lo; c0 < span_hi; c0 += kV2Chunk) {
      const int len = min(kV2Chunk, span_hi - c0);
      v2_stage<kBf16, kLazy, true>(cols, w, slot, shift, x, dsinv, c0, len, lane, e_s[warp], g_s[warp]);
      __syncwarp();
      const int ke = min(hi, c0 + len);
      for (int k = max(lo, c0); k < ke; ++k) {
        const int gs = g_s[warp][k - c0];
        const float e = e_s[warp][k - c0];
        if ((gs >> 9) != group) {
          flush();
          group = gs >> 9;
        }
        if ((gs & (kL - 1)) == j) part = __fadd_rn(part, e);
      }
      __syncwarp();
    }
    flush();
    if (j == 0) {
      const int t_lo = tail_warp != nullptr ? __ldg(tail_warp + (r0 >> 5)) : 0;
      const int t_hi = tail_warp != nullptr ? __ldg(tail_warp + (r0 >> 5) + 1) : 0;
      sum = v2_tail<kLazy>(sum, row, n, t_lo, t_hi, tail_rows, tail_cols, tail_w, tail_y, x, dsinv);
    }
  }
  if (j != 0 || row >= rows) return;
  v2_store<kLazy>(y, x, dsinv, row, sum);
}

""" + r"""
}  // namespace

#define GROUP_ENTRY(NAME, BF16, LAZY, TW)                                                               \
  extern "C" int NAME(const void* ptr, const void* cols, const void* w, const void* slot, int shift,    \
                      int lanes, const void* tail_warp, const void* tail_rows, const void* tail_cols,   \
                      const void* tail_w, const void* tail_y, const void* x, const void* dsinv, void* y, \
                      int n, int rows, void* stream) {                                                  \
    if (lanes != 2 && lanes != 4) return static_cast<int>(cudaErrorInvalidValue);                       \
    if (rows > 0) {                                                                                     \
      const int per_block = kWarps * 32 / lanes;                                                        \
      auto kernel = lanes == 4 ? spmv_v2_mxu2_kernel<BF16, LAZY, 4, TW> : spmv_v2_mxu2_kernel<BF16, LAZY, 2, TW>; \
      kernel<<<(rows + per_block - 1) / per_block, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(   \
          static_cast<const int*>(ptr), static_cast<const int*>(cols), static_cast<const TW*>(w),       \
          static_cast<const short*>(slot), shift, static_cast<const int*>(tail_warp),                   \
          static_cast<const int*>(tail_rows), static_cast<const int*>(tail_cols),                       \
          static_cast<const float*>(tail_w), static_cast<const float*>(tail_y),                         \
          static_cast<const float*>(x), static_cast<const float*>(dsinv), static_cast<float*>(y), n,    \
          rows);                                                                                        \
    }                                                                                                   \
    return static_cast<int>(cudaGetLastError());                                                        \
  }

GROUP_ENTRY(spmv_v2_mxu2_group_f32, false, false, float)
GROUP_ENTRY(spmv_v2_mxu2_bf16i_group_f32, true, false, float)
GROUP_ENTRY(spmv_v2_mxu2_bf16w_group_f32, true, false, __nv_bfloat16)
"""

#: The mxu2 forms' other designs, by suffix: their sources.
MXU2_VARIANTS = {"earlier": MXU2_EARLIER, "group": MXU2_GROUP}


def _nvcc_build(name: str, source: str) -> ctypes.CDLL:
    """Build ``source`` as ``_build/turns/<name>.so`` with the port's nvcc
    flags (ops/_build.py) and load it."""
    from eig_kl_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(source)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   stdout=subprocess.DEVNULL)
    return ctypes.CDLL(str(lib))


def build() -> dict[str, ctypes.CDLL]:
    """The other designs' libraries: "v1", "earlier" and "group" (the mxu2
    forms), built in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = {"v1": ("spmv_v1_earlier", V1_EARLIER)}
    jobs.update({k: (f"mxu2_{k}", source) for k, source in MXU2_VARIANTS.items()})
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_nvcc_build, *job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def v1_earlier(lib: ctypes.CDLL, layout, x, y) -> None:
    """The earlier ``spmv_v1_f32`` on the current stream: ``y = A @ x``."""
    import torch

    fn = lib.spmv_v1_earlier_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    code = fn(layout.x_base.data_ptr(), layout.col_local.data_ptr(), layout.row_local.data_ptr(),
              layout.weights.data_ptr(), layout.win_ptr.data_ptr(), layout.win_chunks.data_ptr(),
              x.data_ptr(), y.data_ptr(), layout.num_nodes, x.numel(), layout.num_windows,
              torch.cuda.current_stream(x.device).cuda_stream)
    if code:
        raise RuntimeError(f"spmv_v1_earlier_f32 failed with CUDA error {code}")


def mxu2_symbol(kernel_symbol: str, variant: str) -> str:
    """The symbol in the ``variant`` library that stands beside the port's
    mxu2 entry point ``kernel_symbol`` (``spmv_v2_mxu2_bf16i_f32`` ->
    ``spmv_v2_mxu2_bf16i_earlier_f32``)."""
    assert kernel_symbol.endswith("_f32") and "mxu2" in kernel_symbol, kernel_symbol
    return f"{kernel_symbol[:-4]}_{variant}_f32"


@contextlib.contextmanager
def swapped(kernel, lib: ctypes.CDLL, variant: str):
    """Within the block, calls of the port's mxu2 entry point ``kernel`` (a
    ``Kernel``, whose wrapper prepares the arguments) run the ``variant``
    design's symbol of ``lib`` instead."""
    fn = getattr(lib, mxu2_symbol(kernel.symbol, variant))
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    if kernel._fn is None:
        kernel._load()
    saved, kernel._fn = kernel._fn, fn
    try:
        yield
    finally:
        kernel._fn = saved
