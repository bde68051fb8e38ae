// K1: y = A @ x for the symmetric CSR adjacency, in float32; and four entry
// points that end in it:
// * power_step_f32:  y = x - inv_shift * (2 x - 2 (A @ x) / deg), the power
//   step (eig_kl_tpu/spectral/power.py:184);
// * laplacian_f32:   y = deg * x - A @ x, the "eig" Laplacian of Lanczos and
//   LOBPCG (eig_kl_tpu/spectral/lanczos.py:57-60);
// * spmm_csr_f32:    Y = A @ X (or deg * X - A @ X) for X of shape (n, k)
//   row-major, 1 <= k <= 16, LOBPCG's blocked product
//   (eig_kl_tpu/spectral/lobpcg_solver.py:51-56, a vmap of the SpMV);
// * lazy_walk_f32:   y = 0.5 * (w + dsinv * (A @ (dsinv * w))), the momentum
//   exit's lazy walk (eig_kl_tpu/spectral/power.py:297-305).
//
// Replaces the TPU SpMV kernels of eig_kl_tpu/ops/spmv_pallas.py: v1
// (_spmv_kernel, :339), v2's gather pass (_gather_kernel, :1049) and v2's
// reduce pass (_reduce_kernel_mxu, :1118, and its variants :1080, :1207,
// :1276).  Those are two TPU forms of one function; their chunk plans exist
// only to work around the TPU's gather limits.  Hopper gathers x directly
// from the CSR arrays, so this kernel takes no plan.
//
// Bound on this card: bytes.  One call must read indptr, indices, data and
// x and write y once, 11.3 MB at gen 1.0x (201,920 rows, 1,107,844 nnz), or
// 3.4 us at 3.35 TB/s; its 2*nnz flops are negligible.  The power step
// also reads deg (0.8 MB more).  What limits it is the x gathers: each
// fetches 4 bytes of a 32-byte sector from L2, at random on a circuit, and
// on an H100 the gathers alone take about 10 us at gen 1.0x
// (tools/k1_k6_floors.py).
//
// The order of the adds is XLA's CPU order for the JAX package's f32 ELL
// SpMV, which depends on the ELL width W (the largest degree rounded up to
// a multiple of 8):
// * W <= 32: entry k of the row goes to lane k mod 8; each lane
//   accumulates with fused multiply-adds; the lanes combine as
//   ((l0+l4) + (l2+l6)) + ((l1+l5) + (l3+l7)).
// * W > 32: windows of 32 positions after (32*ceil(W/32) - W)/2 leading pad
//   positions; each window adds its rounded products in order, and the
//   window sums add in order.
// So K1, the plain version (ops/spmv.py) and the JAX package's CPU SpMV
// agree bit for bit, and so does every entry point's A @ x part (each
// column of spmm_csr_f32 is K1 on that column).  The epilogues round as
// XLA's CPU fusion does, which contracts a product into the add or
// subtraction that takes it: the power step's last operation x - c * lap,
// the Laplacian's deg * x - Ax and the lazy walk's w + dsinv * Ax are each
// one fused multiply-add (tests/test_torch_lanczos.py holds the plain
// versions to XLA's bits).  The lazy walk's gather multiplies dsinv[j] *
// w[j] with one rounding, as the element-wise product that XLA fuses into
// its gather does.
//
// Design: a warp per 32 consecutive rows, one lane per row, one writer per
// row, no atomics.  The warp's rows span one contiguous range of the CSR
// arrays.  Its 32 lanes load that span coalesced (indices and data) and
// issue its x gathers all at once, into the warp's buffer in shared
// memory: for W <= 32 the data and the gathered x apart (the lane FMAs
// need both), for W > 32 the rounded products.  Then each lane walks its
// own row in the buffer in XLA's order: for W <= 32 the 8 lane FMA chains
// (entries l, l+8, l+16, l+24) and their fixed combine; for W > 32 one
// chain per window, each window's sum added to the row's as the walk
// enters the next window.  A warp's span holds at most 32 * W entries, so
// for W <= 32 it is one buffer of 1,024 entries; for W > 32 the warp takes
// it 256 entries at a time and each lane carries its chain across them.
// The blocked product takes X four columns at a time where k is a multiple
// of 4: one 16-byte gather of X[j * k + c0 .. + 3] per entry fetches the
// four values from one 32-byte sector, where K1 fetches a sector for one
// value, so four columns cost about one K1 launch.  The warp stages its
// span 256 entries at a time (data, and the four gathered values of each
// entry), and each lane carries its row's four sets of chains across the
// chunks.  Any other k takes one column at a time through K1's walk.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 8;  // XLA's FMA lanes for W <= 32
constexpr int kWindow = 32;
constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 1024;   // W <= 32: a warp's span, at most 32 * W entries
constexpr int kChunk = 256;   // W > 32: the entries a warp buffers at a time
constexpr int kPerLane = 8;    // loads in flight per lane
constexpr int kStage = 32 * kPerLane;

// Floats of shared memory per warp.
__host__ __device__ __forceinline__ int buffer_floats(int row_width) {
  return row_width <= kWindow ? 2 * kSpan : kChunk;
}

// What a row sum gathers for column j of the matrix: x[j], X[j * k + c] or
// dsinv[j] * w[j] (one rounding).
struct GatherX {
  const float* __restrict__ x;
  __device__ __forceinline__ float operator()(int j) const { return __ldg(x + j); }
};
struct GatherColumn {
  const float* __restrict__ x;
  int k, c;
  __device__ __forceinline__ float operator()(int j) const {
    return __ldg(x + static_cast<long long>(j) * k + c);
  }
};
struct GatherScaled {
  const float* __restrict__ w;
  const float* __restrict__ s;
  __device__ __forceinline__ float operator()(int j) const {
    return __fmul_rn(__ldg(s + j), __ldg(w + j));
  }
};

// Row r0 + lane's sum in XLA's order on that lane, for the warp's rows
// r0 .. r0 + 31 (rows at or past n count as empty).  `buf` is the warp's
// buffer: 2 * kSpan floats for W <= 32, kChunk for W > 32.
template <class Gather>
__device__ __forceinline__ float row_sum(const int* __restrict__ indptr,
                                         const int* __restrict__ indices,
                                         const float* __restrict__ data, Gather gx,
                                         float* buf, int r0, int n, int row_width) {
  // Every load below is unconditional, at an index clamped into range, and
  // a select drops what is out of range: a load under a branch makes the
  // lane wait for it before it issues the next one.
  const int lane = threadIdx.x & 31;
  const int row = r0 + lane;
  __syncwarp();  // the buffer's last reader (a call before this one) is done
  const int lo = __ldg(indptr + min(row, n - 1));
  const int hi = row < n ? __ldg(indptr + min(row, n - 1) + 1) : lo;
  const int span_lo = __ldg(indptr + r0);
  const int span_hi = __ldg(indptr + min(r0 + 32, n));
  if (row_width <= kWindow) {
    // The span holds at most 32 * W <= kSpan entries.
    float* d = buf;
    float* xv = buf + kSpan;
    const int len = min(span_hi - span_lo, kSpan);
    for (int base = 0; base < len; base += kStage) {
      int col[kPerLane];
      float w[kPerLane];
      float xg[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = min(base + lane + 32 * q, len - 1);
        col[q] = __ldg(indices + span_lo + i);
        w[q] = __ldg(data + span_lo + i);
      }
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) xg[q] = gx(col[q]);
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = base + lane + 32 * q;
        if (i < len) {
          d[i] = w[q];
          xv[i] = xg[q];
        }
      }
    }
    __syncwarp();
    const int b = lo - span_lo;
    const int deg = row < n ? min(hi - lo, kSpan - b) : 0;
    float acc[kLanes];
#pragma unroll
    for (int q = 0; q < kLanes; ++q) acc[q] = 0.0f;
    for (int t0 = 0; t0 < deg; t0 += kLanes) {
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        const int t = min(b + t0 + q, kSpan - 1);
        const float next = __fmaf_rn(d[t], xv[t], acc[q]);
        acc[q] = t0 + q < deg ? next : acc[q];
      }
    }
    return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[4]), __fadd_rn(acc[2], acc[6])),
                     __fadd_rn(__fadd_rn(acc[1], acc[5]), __fadd_rn(acc[3], acc[7])));
  }
  const int windows = (row_width + kWindow - 1) / kWindow;
  const int pad = (windows * kWindow - row_width) / 2;
  float out = 0.0f;
  float s = 0.0f;
  for (int c0 = span_lo; c0 < span_hi; c0 += kChunk) {
    const int len = min(kChunk, span_hi - c0);
    for (int base = 0; base < len; base += kStage) {
      int col[kPerLane];
      float w[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = min(base + lane + 32 * q, len - 1);
        col[q] = __ldg(indices + c0 + i);
        w[q] = __ldg(data + c0 + i);
      }
      float xg[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) xg[q] = gx(col[q]);
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = base + lane + 32 * q;
        if (i < len) buf[i] = __fmul_rn(w[q], xg[q]);
      }
    }
    __syncwarp();
    const int ke = min(hi, c0 + len);
    for (int k = max(lo, c0); k < ke;) {
      // Entering a window: add the last one's sum (the first time, +0 to
      // +0, which changes nothing).  Then add this window's products.
      const int offset = (k - lo + pad) & (kWindow - 1);
      if (offset == 0) {
        out = __fadd_rn(out, s);
        s = 0.0f;
      }
      const int end = min(ke, k + kWindow - offset);
#pragma unroll 4
      for (; k < end; ++k) s = __fadd_rn(s, buf[k - c0]);
    }
    __syncwarp();
  }
  return __fadd_rn(out, s);
}

__global__ void __launch_bounds__(kThreads)
    spmv_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                    const float* __restrict__ data, const float* __restrict__ x,
                    float* __restrict__ y, int n, int row_width) {
  extern __shared__ float buffers[];
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  float* buf = buffers + warp * buffer_floats(row_width);
  const float s = row_sum(indptr, indices, data, GatherX{x}, buf, r0, n, row_width);
  const int row = r0 + (threadIdx.x & 31);
  if (row < n) y[row] = s;
}

__global__ void __launch_bounds__(kThreads)
    power_step_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                      const float* __restrict__ data, const float* __restrict__ x,
                      const float* __restrict__ deg, float inv_shift,
                      float* __restrict__ y, int n, int row_width) {
  extern __shared__ float buffers[];
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  float* buf = buffers + warp * buffer_floats(row_width);
  const int row = r0 + (threadIdx.x & 31);
  const float xr = __ldg(x + min(row, n - 1));
  const float dr = __ldg(deg + min(row, n - 1));
  const float ax = row_sum(indptr, indices, data, GatherX{x}, buf, r0, n, row_width);
  if (row < n) {
    const float lap = __fsub_rn(__fmul_rn(2.0f, xr), __fdiv_rn(__fmul_rn(2.0f, ax), dr));
    y[row] = __fmaf_rn(-inv_shift, lap, xr);
  }
}

__global__ void __launch_bounds__(kThreads)
    laplacian_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                     const float* __restrict__ data, const float* __restrict__ x,
                     const float* __restrict__ deg, float* __restrict__ y, int n,
                     int row_width) {
  extern __shared__ float buffers[];
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  float* buf = buffers + warp * buffer_floats(row_width);
  const int row = r0 + (threadIdx.x & 31);
  const float xr = __ldg(x + min(row, n - 1));
  const float dr = __ldg(deg + min(row, n - 1));
  const float ax = row_sum(indptr, indices, data, GatherX{x}, buf, r0, n, row_width);
  if (row < n) y[row] = __fmaf_rn(dr, xr, -ax);
}

__global__ void __launch_bounds__(kThreads)
    spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ x,
                const float* __restrict__ deg, float* __restrict__ y, int n, int k,
                int row_width) {
  extern __shared__ float buffers[];
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  float* buf = buffers + warp * buffer_floats(row_width);
  const int row = r0 + (threadIdx.x & 31);
  const long long base = static_cast<long long>(min(row, n - 1)) * k;
  const float dr = deg != nullptr ? __ldg(deg + min(row, n - 1)) : 0.0f;
  for (int c = 0; c < k; ++c) {
    const float ax = row_sum(indptr, indices, data, GatherColumn{x, k, c}, buf, r0, n, row_width);
    if (row < n) y[base + c] = deg != nullptr ? __fmaf_rn(dr, __ldg(x + base + c), -ax) : ax;
  }
}

__global__ void __launch_bounds__(kThreads)
    lazy_walk_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                     const float* __restrict__ data, const float* __restrict__ w,
                     const float* __restrict__ dsinv, float* __restrict__ y, int n,
                     int row_width) {
  extern __shared__ float buffers[];
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  float* buf = buffers + warp * buffer_floats(row_width);
  const int row = r0 + (threadIdx.x & 31);
  const float wr = __ldg(w + min(row, n - 1));
  const float sr = __ldg(dsinv + min(row, n - 1));
  const float ax = row_sum(indptr, indices, data, GatherScaled{w, dsinv}, buf, r0, n, row_width);
  if (row < n) y[row] = __fmul_rn(0.5f, __fmaf_rn(sr, ax, wr));
}

constexpr int kChunk4 = 256;              // entries staged at a time, four columns each
constexpr int kBuffer4 = kChunk4 * 5;     // floats per warp: the data, then a float4 per entry
constexpr int kPerLane4 = 4;
constexpr int kStage4 = 32 * kPerLane4;

__device__ __forceinline__ float4 fadd4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// Columns c0 .. c0 + 3 of A @ X for row r0 + lane, X row-major (n, k) with k
// a multiple of 4 and X 16-byte aligned: each column added in row_sum's
// (XLA's) order.  `buf` is the warp's kBuffer4 floats.
__device__ __forceinline__ float4 row_sum4(const int* __restrict__ indptr,
                                           const int* __restrict__ indices,
                                           const float* __restrict__ data,
                                           const float* __restrict__ x, int k, int c0,
                                           float* buf, int r0, int n, int row_width) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + lane;
  __syncwarp();  // the buffer's last reader (a call before this one) is done
  const int lo = __ldg(indptr + min(row, n - 1));
  const int hi = row < n ? __ldg(indptr + min(row, n - 1) + 1) : lo;
  const int span_lo = __ldg(indptr + r0);
  const int span_hi = __ldg(indptr + min(r0 + 32, n));
  float* d = buf;
  float4* xv = reinterpret_cast<float4*>(buf + kChunk4);
  const bool lanes8 = row_width <= kWindow;
  const int windows = (row_width + kWindow - 1) / kWindow;
  const int pad = lanes8 ? 0 : (windows * kWindow - row_width) / 2;
  // W <= 32: the 8 lane chains; W > 32: acc[0] the window's sum, acc[1] the row's.
  float4 acc[kLanes];
#pragma unroll
  for (int q = 0; q < kLanes; ++q) acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = span_lo; c < span_hi; c += kChunk4) {
    const int len = min(kChunk4, span_hi - c);
    for (int base = 0; base < len; base += kStage4) {
      int col[kPerLane4];
      float w[kPerLane4];
      float4 xg[kPerLane4];
#pragma unroll
      for (int q = 0; q < kPerLane4; ++q) {
        const int i = min(base + lane + 32 * q, len - 1);
        col[q] = __ldg(indices + c + i);
        w[q] = __ldg(data + c + i);
      }
#pragma unroll
      for (int q = 0; q < kPerLane4; ++q) {
        xg[q] = __ldg(reinterpret_cast<const float4*>(x + static_cast<long long>(col[q]) * k + c0));
      }
#pragma unroll
      for (int q = 0; q < kPerLane4; ++q) {
        const int i = base + lane + 32 * q;
        if (i < len) {
          d[i] = w[q];
          xv[i] = xg[q];
        }
      }
    }
    __syncwarp();
    // This row's entries in the chunk, as positions in the row.
    const int pb = max(lo, c) - lo;
    const int pe = min(hi, c + len) - lo;
    if (lanes8) {
      for (int p0 = pb & ~(kLanes - 1); p0 < pe; p0 += kLanes) {
#pragma unroll
        for (int q = 0; q < kLanes; ++q) {
          const int p = p0 + q;
          const int t = min(max(lo + p, c), c + len - 1) - c;
          const float wt = d[t];
          const float4 xt = xv[t];
          if (p >= pb && p < pe) {
            acc[q] = make_float4(__fmaf_rn(wt, xt.x, acc[q].x), __fmaf_rn(wt, xt.y, acc[q].y),
                                 __fmaf_rn(wt, xt.z, acc[q].z), __fmaf_rn(wt, xt.w, acc[q].w));
          }
        }
      }
    } else {
      for (int p = pb; p < pe;) {
        const int offset = (p + pad) & (kWindow - 1);
        if (offset == 0) {
          acc[1] = fadd4(acc[1], acc[0]);
          acc[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        const int end = min(pe, p + kWindow - offset);
        for (; p < end; ++p) {
          const float wt = d[lo + p - c];
          const float4 xt = xv[lo + p - c];
          acc[0] = fadd4(acc[0], make_float4(__fmul_rn(wt, xt.x), __fmul_rn(wt, xt.y),
                                             __fmul_rn(wt, xt.z), __fmul_rn(wt, xt.w)));
        }
      }
    }
    __syncwarp();
  }
  if (!lanes8) return fadd4(acc[1], acc[0]);
  return fadd4(fadd4(fadd4(acc[0], acc[4]), fadd4(acc[2], acc[6])),
               fadd4(fadd4(acc[1], acc[5]), fadd4(acc[3], acc[7])));
}

__global__ void __launch_bounds__(kThreads)
    spmm4_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                 const float* __restrict__ data, const float* __restrict__ x,
                 const float* __restrict__ deg, float* __restrict__ y, int n, int k,
                 int row_width) {
  extern __shared__ float4 buffers4[];
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  float* buf = reinterpret_cast<float*>(buffers4) + warp * kBuffer4;
  const int row = r0 + (threadIdx.x & 31);
  const long long base = static_cast<long long>(min(row, n - 1)) * k;
  const float dr = deg != nullptr ? __ldg(deg + min(row, n - 1)) : 0.0f;
  for (int c0 = 0; c0 < k; c0 += 4) {
    const float4 ax = row_sum4(indptr, indices, data, x, k, c0, buf, r0, n, row_width);
    if (row < n) {
      float4 out = ax;
      if (deg != nullptr) {
        const float4 xr = __ldg(reinterpret_cast<const float4*>(x + base + c0));
        out = make_float4(__fmaf_rn(dr, xr.x, -ax.x), __fmaf_rn(dr, xr.y, -ax.y),
                          __fmaf_rn(dr, xr.z, -ax.z), __fmaf_rn(dr, xr.w, -ax.w));
      }
      *reinterpret_cast<float4*>(y + base + c0) = out;
    }
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

size_t shared_bytes(int row_width) {
  return static_cast<size_t>(kWarps) * buffer_floats(row_width) * sizeof(float);
}

}  // namespace

extern "C" int spmv_csr_f32(const void* indptr, const void* indices,
                            const void* data, const void* x, void* y, int n,
                            int row_width, void* stream) {
  if (n > 0) {
    spmv_csr_kernel<<<blocks_for(n), kThreads, shared_bytes(row_width),
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const float*>(data), static_cast<const float*>(x),
        static_cast<float*>(y), n, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int power_step_f32(const void* indptr, const void* indices, const void* data,
                              const void* x, const void* deg, float inv_shift, void* y,
                              int n, int row_width, void* stream) {
  if (n > 0) {
    power_step_kernel<<<blocks_for(n), kThreads, shared_bytes(row_width),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const float*>(data), static_cast<const float*>(x),
        static_cast<const float*>(deg), inv_shift, static_cast<float*>(y), n, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int laplacian_f32(const void* indptr, const void* indices, const void* data,
                             const void* x, const void* deg, void* y, int n, int row_width,
                             void* stream) {
  if (n > 0) {
    laplacian_kernel<<<blocks_for(n), kThreads, shared_bytes(row_width),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const float*>(data), static_cast<const float*>(x),
        static_cast<const float*>(deg), static_cast<float*>(y), n, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

// deg may be null: then Y = A @ X.
extern "C" int spmm_csr_f32(const void* indptr, const void* indices, const void* data,
                            const void* x, const void* deg, void* y, int n, int k,
                            int row_width, void* stream) {
  if (k < 1 || k > 16) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (n > 0 && k % 4 == 0 && aligned) {
    spmm4_kernel<<<blocks_for(n), kThreads, kWarps * kBuffer4 * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const float*>(data), static_cast<const float*>(x),
        static_cast<const float*>(deg), static_cast<float*>(y), n, k, row_width);
  } else if (n > 0) {
    spmm_kernel<<<blocks_for(n), kThreads, shared_bytes(row_width),
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const float*>(data), static_cast<const float*>(x),
        static_cast<const float*>(deg), static_cast<float*>(y), n, k, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lazy_walk_f32(const void* indptr, const void* indices, const void* data,
                             const void* w, const void* dsinv, void* y, int n, int row_width,
                             void* stream) {
  if (n > 0) {
    lazy_walk_kernel<<<blocks_for(n), kThreads, shared_bytes(row_width),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const float*>(data), static_cast<const float*>(w),
        static_cast<const float*>(dsinv), static_cast<float*>(y), n, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
