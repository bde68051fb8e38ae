// K1: y = A @ x for the symmetric CSR adjacency, in float32 and in float64
// (spmv_csr_f32, spmv_csr_f64); and four entry points that end in it, each
// in both types (the _f32 and _f64 symbols):
// * power_step:  y = x - inv_shift * (2 x - 2 (A @ x) / deg), the power
//   step (eig_kl_tpu/spectral/power.py:184);
// * laplacian:   y = deg * x - A @ x, the "eig" Laplacian of Lanczos and
//   LOBPCG (eig_kl_tpu/spectral/lanczos.py:57-60);
// * spmm_csr:    Y = A @ X (or deg * X - A @ X) for X of shape (n, k)
//   row-major, 1 <= k <= 16, LOBPCG's blocked product
//   (eig_kl_tpu/spectral/lobpcg_solver.py:51-56, a vmap of the SpMV);
// * lazy_walk:   y = 0.5 * (w + dsinv * (A @ z)), z = dsinv * w, the
//   momentum exit's lazy walk (eig_kl_tpu/spectral/power.py:297-305); given
//   w = u * c (c one value), the epilogue 0.5 * fma(u, c, dsinv * Ax): the
//   momentum check's walk of its deflated iterate on a graph wider than 32,
//   where XLA recomputes w in the epilogue's fusion and fuses that product.
// The lazy walks gather z, made beforehand by lazy_rescale (below): one
// random gather per entry, as the SpMV's (gathering dsinv[j] and w[j] would
// take two).  z[j] is one rounded product, so forming it once per node
// gives the bits of forming it per entry, and the JAX package forms it as a
// vector too (power.py:305, matvec(dsinv_st * w)).
// Two more, f32 only, take a TPU plan's layout (ops/spmv_plan.py) and add
// each row in that kernel's own order, which the JAX package runs wherever
// its f32 SpMV has a plan (the mega engine's starting A @ s and recount, and
// every SpMV of a device graph that carries a plan: the KL engine's, the
// power solve's on its zero-padded (P/128, 128) state):
// * spmv_v1_f32: the v1 kernel's (_spmv_kernel, :339), at most 32,768
//   stored entries, and v2's v1 tails;
// * spmv_v2_f32: the v2 pair's (_gather_kernel, :1049, and the default
//   reduce _reduce_kernel_mxu, :1118), above 32,768, with f32 or bf16
//   products (the pair's default bf16-intermediate mode,
//   (g * w).astype(bfloat16), :1077), and its lazy-walk form.
// Both write a flat vector of n or the padded state, its padding +0.
// The f64 instantiations serve the JAX package's f64 paths off the TPU
// (eig_kl_tpu/cli/main.py:204-212, the --f64 flag); the H100 runs f64
// natively.
//
// Replaces the TPU SpMV kernels of eig_kl_tpu/ops/spmv_pallas.py: v1
// (_spmv_kernel, :339), v2's gather pass (_gather_kernel, :1049) and v2's
// reduce pass (_reduce_kernel_mxu, :1118, and its variants :1080, :1207,
// :1276).  Those are two TPU forms of one function; their chunk plans exist
// to work around the TPU's gather limits.  Hopper gathers x directly from
// the CSR arrays, so K1's XLA-ordered entry points take no plan; only
// spmv_v1_f32 and spmv_v2_f32 (below) take a plan's layout, for its order.
//
// Bound on this card: bytes.  One call must read indptr, indices, data and
// x and write y once, 11.3 MB at gen 1.0x (201,920 rows, 1,107,844 nnz), or
// 3.4 us at 3.35 TB/s (f64: 17.3 MB, 5.2 us); its 2*nnz flops are
// negligible.  The power step
// also reads deg (0.8 MB more).  What limits it is the x gathers: each
// fetches 4 bytes of a 32-byte sector from L2, at random on a circuit, and
// on an H100 the gathers alone take about 10 us at gen 1.0x
// (tools/k1_k6_floors.py).
//
// The order of the adds is XLA's CPU order for the JAX package's f32 ELL
// SpMV, which depends on the ELL width W (the largest degree rounded up to
// a multiple of 8):
// * W = 8 or 16: one chain of fused multiply-adds over the row's entries
//   in position order (LLVM unrolls the row's loop fully and keeps it a
//   chain); the power solve's first step, which XLA fuses with the start
//   vector's draw and does not unroll, takes the 8 lanes below instead
//   (power_step's `lanes`);
// * W = 24 or 32: entry k of the row goes to lane k mod 8; each lane
//   accumulates with fused multiply-adds; the lanes combine as
//   ((l0+l4) + (l2+l6)) + ((l1+l5) + (l3+l7)).
// * W > 32: windows of 32 positions after (32*ceil(W/32) - W)/2 leading pad
//   positions; each window adds its rounded products in order, and the
//   window sums add in order.
// So K1, the plain version (ops/spmv.py) and the JAX package's CPU SpMV
// agree bit for bit in f32, and so does every entry point's A @ x part (each
// column of spmm_csr_f32 is K1 on that column).  The epilogues round as
// XLA's CPU fusion does, which contracts a product into the add or
// subtraction that takes it: the power step's last operation x - c * lap,
// the Laplacian's deg * x - Ax and the lazy walk's w + dsinv * Ax are each
// one fused multiply-add (tests/test_torch_lanczos.py holds the plain
// versions to XLA's bits).  The lazy walk's z = dsinv * w is one rounding
// per value, as the element-wise product that XLA fuses into its gather.
// In f64 the order is the same, and every product is
// rounded before its add, as the plain version's f64 branch does (PyTorch
// has no exact f64 fused multiply-add): the lanes of W <= 32 add rounded
// products, and each epilogue rounds its product before the add.  Every
// f64 operation is an explicit __d*_rn intrinsic (csrc/fp.cuh), so nvcc
// contracts nothing and K1 equals the plain version bit for bit.
//
// Design: a warp per 32 consecutive rows, one lane per row, one writer per
// row, no atomics.  The warp's rows span one contiguous range of the CSR
// arrays.  Its 32 lanes load that span coalesced (indices and data) and
// issue its x gathers all at once, into the warp's buffer in shared
// memory: for W <= 32 the data and the gathered x apart (the lane FMAs
// need both), for W > 32 the rounded products.  Then each lane walks its
// own row in the buffer in XLA's order: for W <= 32 the 8 lane FMA chains
// (entries l, l+8, l+16, l+24) and their fixed combine, or for W <= 16 the
// one chain (every entry into lane 0, no combine); for W > 32 one
// chain per window, each window's sum added to the row's as the walk
// enters the next window.  A warp's span holds at most 32 * W entries, so
// for W <= 32 it is one buffer of 1,024 entries; for W > 32 the warp takes
// it 256 entries at a time and each lane carries its chain across them.
// The blocked product takes X four columns at a time where k is a multiple
// of 4: the gather of X[j * k + c0 .. + 3] per entry fetches the four
// values from one 32-byte sector (one 16-byte load in f32, two in f64:
// Hopper has no 32-byte load), where K1 fetches a sector for one value,
// so four columns cost about one K1 launch.  The warp stages its span 256
// entries at a time (data, and the four gathered values of each entry),
// and each lane carries its row's four sets of chains (32 accumulators)
// across the chunks.  Any other k, or an X not 16-byte aligned, takes one
// column at a time through K1's walk.  The W <= 32 buffer of f64 holds the rounded
// products (8 bytes each, the bytes of f32's data and gathered x), so its
// shared memory per block is the same in both types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fp.cuh"
#include "seg_scan.cuh"

namespace {

constexpr int kLanes = 8;  // XLA's FMA lanes for W = 24 and 32
constexpr int kChainWidth = 16;  // W <= 16: one chain, in position order
constexpr int kWindow = 32;
constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 1024;   // W <= 32: a warp's span, at most 32 * W entries
constexpr int kChunk = 256;   // W > 32: the entries a warp buffers at a time
constexpr int kPerLane = 8;    // loads in flight per lane
constexpr int kStage = 32 * kPerLane;

// W <= 32 in f32: the lanes fuse each product into its add, so the buffer
// holds the data and the gathered x apart; in f64 it holds the rounded
// products.
template <class T>
constexpr bool kFusedLanes = std::is_same<T, float>::value;

// Values of T in shared memory per warp (8 KB for W <= 32 in both types).
template <class T>
__host__ __device__ __forceinline__ int buffer_values(int row_width) {
  return row_width <= kWindow ? (kFusedLanes<T> ? 2 * kSpan : kSpan) : kChunk;
}

// What a row sum gathers for column j of the matrix: x[j] (the lazy walk's
// z[j]) or X[j * k + c].
template <class T>
struct GatherX {
  const T* __restrict__ x;
  __device__ __forceinline__ T operator()(int j) const { return __ldg(x + j); }
};
template <class T>
struct GatherColumn {
  const T* __restrict__ x;
  int k, c;
  __device__ __forceinline__ T operator()(int j) const {
    return __ldg(x + static_cast<long long>(j) * k + c);
  }
};

// Row r0 + lane's sum in XLA's order on that lane, for the warp's rows
// r0 .. r0 + 31 (rows at or past n count as empty).  `buf` is the warp's
// buffer of buffer_values<T>(row_width) values.  `lanes`: the 8 lanes at
// W <= 16 too, in place of the one chain.
template <class T, class Gather>
__device__ __forceinline__ T row_sum(const int* __restrict__ indptr,
                                     const int* __restrict__ indices,
                                     const T* __restrict__ data, Gather gx, T* buf,
                                     int r0, int n, int row_width, bool lanes = false) {
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
  constexpr bool kFused = kFusedLanes<T>;
  if (row_width <= kWindow) {
    // The span holds at most 32 * W <= kSpan entries.
    T* d = buf;           // fused lanes: the data; else the rounded products
    T* xv = buf + kSpan;  // fused lanes only: the gathered x
    const int len = min(span_hi - span_lo, kSpan);
    for (int base = 0; base < len; base += kStage) {
      int col[kPerLane];
      T w[kPerLane];
      T xg[kPerLane];
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
          if constexpr (kFused) {
            d[i] = w[q];
            xv[i] = xg[q];
          } else {
            d[i] = mul_rn(w[q], xg[q]);
          }
        }
      }
    }
    __syncwarp();
    const int b = lo - span_lo;
    const int deg = row < n ? min(hi - lo, kSpan - b) : 0;
    if (row_width <= kChainWidth && !lanes) {  // one chain in position order
      T s = T(0);
      for (int t = b; t < b + deg; ++t) {
        if constexpr (kFused) {
          s = fma_rn(d[t], xv[t], s);
        } else {
          s = add_rn(s, d[t]);
        }
      }
      return s;
    }
    T acc[kLanes];
#pragma unroll
    for (int q = 0; q < kLanes; ++q) acc[q] = T(0);
    for (int t0 = 0; t0 < deg; t0 += kLanes) {
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        const int t = min(b + t0 + q, kSpan - 1);
        T next;
        if constexpr (kFused) {
          next = fma_rn(d[t], xv[t], acc[q]);
        } else {
          next = add_rn(acc[q], d[t]);
        }
        acc[q] = t0 + q < deg ? next : acc[q];
      }
    }
    return add_rn(add_rn(add_rn(acc[0], acc[4]), add_rn(acc[2], acc[6])),
                  add_rn(add_rn(acc[1], acc[5]), add_rn(acc[3], acc[7])));
  }
  const int windows = (row_width + kWindow - 1) / kWindow;
  const int pad = (windows * kWindow - row_width) / 2;
  T out = T(0);
  T s = T(0);
  for (int c0 = span_lo; c0 < span_hi; c0 += kChunk) {
    const int len = min(kChunk, span_hi - c0);
    for (int base = 0; base < len; base += kStage) {
      int col[kPerLane];
      T w[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = min(base + lane + 32 * q, len - 1);
        col[q] = __ldg(indices + c0 + i);
        w[q] = __ldg(data + c0 + i);
      }
      T xg[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) xg[q] = gx(col[q]);
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = base + lane + 32 * q;
        if (i < len) buf[i] = mul_rn(w[q], xg[q]);
      }
    }
    __syncwarp();
    const int ke = min(hi, c0 + len);
    for (int k = max(lo, c0); k < ke;) {
      // Entering a window: add the last one's sum (the first time, +0 to
      // +0, which changes nothing).  Then add this window's products.
      const int offset = (k - lo + pad) & (kWindow - 1);
      if (offset == 0) {
        out = add_rn(out, s);
        s = T(0);
      }
      const int end = min(ke, k + kWindow - offset);
#pragma unroll 4
      for (; k < end; ++k) s = add_rn(s, buf[k - c0]);
    }
    __syncwarp();
  }
  return add_rn(out, s);
}

// The warp's rows and its buffer in the block's dynamic shared memory.
template <class T>
__device__ __forceinline__ T* warp_buffer(int row_width, int& r0) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int warp = threadIdx.x >> 5;
  r0 = (blockIdx.x * kWarps + warp) * 32;
  return reinterpret_cast<T*>(shared_raw) + warp * buffer_values<T>(row_width);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    spmv_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                    const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, int n, int row_width) {
  int r0;
  T* buf = warp_buffer<T>(row_width, r0);
  if (r0 >= n) return;
  const T s = row_sum(indptr, indices, data, GatherX<T>{x}, buf, r0, n, row_width);
  const int row = r0 + (threadIdx.x & 31);
  if (row < n) y[row] = s;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    power_step_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                      const T* __restrict__ data, const T* __restrict__ x,
                      const T* __restrict__ deg, T inv_shift,
                      T* __restrict__ y, int n, int row_width, bool lanes) {
  int r0;
  T* buf = warp_buffer<T>(row_width, r0);
  if (r0 >= n) return;
  const int row = r0 + (threadIdx.x & 31);
  const T xr = __ldg(x + min(row, n - 1));
  const T dr = __ldg(deg + min(row, n - 1));
  const T ax = row_sum(indptr, indices, data, GatherX<T>{x}, buf, r0, n, row_width, lanes);
  if (row < n) {
    const T lap = sub_rn(mul_rn(T(2), xr), div_rn(mul_rn(T(2), ax), dr));
    y[row] = mul_add(-inv_shift, lap, xr);
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    laplacian_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                     const T* __restrict__ data, const T* __restrict__ x,
                     const T* __restrict__ deg, T* __restrict__ y, int n,
                     int row_width) {
  int r0;
  T* buf = warp_buffer<T>(row_width, r0);
  if (r0 >= n) return;
  const int row = r0 + (threadIdx.x & 31);
  const T xr = __ldg(x + min(row, n - 1));
  const T dr = __ldg(deg + min(row, n - 1));
  const T ax = row_sum(indptr, indices, data, GatherX<T>{x}, buf, r0, n, row_width);
  if (row < n) y[row] = mul_add(dr, xr, -ax);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ x,
                const T* __restrict__ deg, T* __restrict__ y, int n, int k,
                int row_width) {
  int r0;
  T* buf = warp_buffer<T>(row_width, r0);
  if (r0 >= n) return;
  const int row = r0 + (threadIdx.x & 31);
  const long long base = static_cast<long long>(min(row, n - 1)) * k;
  const T dr = deg != nullptr ? __ldg(deg + min(row, n - 1)) : T(0);
  for (int c = 0; c < k; ++c) {
    const T ax = row_sum(indptr, indices, data, GatherColumn<T>{x, k, c}, buf, r0, n, row_width);
    if (row < n) y[base + c] = deg != nullptr ? mul_add(dr, __ldg(x + base + c), -ax) : ax;
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    lazy_walk_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                     const T* __restrict__ data, const T* __restrict__ w,
                     const T* __restrict__ z, const T* __restrict__ dsinv,
                     const T* __restrict__ u, const T* __restrict__ c, T* __restrict__ y, int n,
                     int row_width) {
  int r0;
  T* buf = warp_buffer<T>(row_width, r0);
  if (r0 >= n) return;
  const int row = r0 + (threadIdx.x & 31);
  const T wr = __ldg(w + min(row, n - 1));
  const T sr = __ldg(dsinv + min(row, n - 1));
  const T ax = row_sum(indptr, indices, data, GatherX<T>{z}, buf, r0, n, row_width);
  if (row >= n) return;
  if (u != nullptr) {
    // w = u * c, recomputed in the epilogue: its product is the one fused.
    y[row] = mul_rn(T(0.5), mul_add(__ldg(u + row), __ldg(c), mul_rn(sr, ax)));
  } else {
    y[row] = mul_rn(T(0.5), mul_add(sr, ax, wr));
  }
}

// lazy_rescale: the momentum step's rescale of its two carries, w' = u *
// inv and wp' = w * inv (eig_kl_tpu/spectral/power.py:316-322, `(w * inv, u *
// inv)`, inv one value), and the next lazy walk's z = dsinv * w', each
// product rounded once, in one pass; without inv (and w) the standalone z
// pass, z = dsinv * u, for a walk whose vector no rescale made.  Replaces
// no TPU kernel: the JAX package's two products are XLA element-wise
// operations, and z is the product that XLA fuses into the walk's gather.
// Bound by bytes (a read of u, w and dsinv and a write of three vectors);
// one value per thread, every load and store coalesced.
template <class T>
__global__ void __launch_bounds__(256)
    lazy_rescale_kernel(const T* __restrict__ u, const T* __restrict__ w, const T* __restrict__ inv,
                        const T* __restrict__ dsinv, T* __restrict__ u_out, T* __restrict__ w_out,
                        T* __restrict__ z, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T ui = __ldg(u + i);
  if (inv != nullptr) {
    const T c = __ldg(inv);
    ui = mul_rn(ui, c);
    u_out[i] = ui;
    if (w != nullptr) w_out[i] = mul_rn(__ldg(w + i), c);
  }
  z[i] = mul_rn(__ldg(dsinv + i), ui);
}

// The blocked product's vector walk: kCols = 4 columns per walk of the
// rows, gathered kCols / V 16-byte vectors at a time (V = 4 f32 or 2 f64
// values): one load in f32, two loads of one 32-byte sector in f64.
constexpr int kCols = 4;
constexpr int kChunkV = 256;  // entries staged at a time, kCols columns each
constexpr int kPerLaneV = 4;
constexpr int kStageV = 32 * kPerLaneV;

// Values of T per warp: the data, then kCols values per entry.
constexpr int kBufferV = kChunkV * (1 + kCols);

// Columns c0 .. c0 + kCols - 1 of A @ X for row r0 + lane into out[], X
// row-major (n, k) with k a multiple of kCols and X 16-byte aligned: each
// column added in row_sum's (XLA's) order.  `buf` is the warp's
// kBufferV values.
template <class T>
__device__ __forceinline__ void row_sum_v(const int* __restrict__ indptr,
                                          const int* __restrict__ indices,
                                          const T* __restrict__ data,
                                          const T* __restrict__ x, int k, int c0, T* buf,
                                          int r0, int n, int row_width, T (&out)[kCols]) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kWidth;
  constexpr int kQ = kCols / kV;  // 16-byte vectors per entry
  static_assert(kCols % kV == 0, "whole 16-byte vectors per entry");
  const int lane = threadIdx.x & 31;
  const int row = r0 + lane;
  __syncwarp();  // the buffer's last reader (a call before this one) is done
  const int lo = __ldg(indptr + min(row, n - 1));
  const int hi = row < n ? __ldg(indptr + min(row, n - 1) + 1) : lo;
  const int span_lo = __ldg(indptr + r0);
  const int span_hi = __ldg(indptr + min(r0 + 32, n));
  T* d = buf;
  V* xv = reinterpret_cast<V*>(buf + kChunkV);
  const bool lanes8 = row_width <= kWindow;
  const bool chain = row_width <= kChainWidth;  // one chain in acc[0]
  const int windows = (row_width + kWindow - 1) / kWindow;
  const int pad = lanes8 ? 0 : (windows * kWindow - row_width) / 2;
  // W <= 32: the 8 lane chains; W > 32: acc[0] the window's sum, acc[1] the row's.
  T acc[kLanes][kCols];
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[q][c] = T(0);
  }
  for (int c = span_lo; c < span_hi; c += kChunkV) {
    const int len = min(kChunkV, span_hi - c);
    for (int base = 0; base < len; base += kStageV) {
      int col[kPerLaneV];
      T w[kPerLaneV];
      V xg[kPerLaneV][kQ];
#pragma unroll
      for (int q = 0; q < kPerLaneV; ++q) {
        const int i = min(base + lane + 32 * q, len - 1);
        col[q] = __ldg(indices + c + i);
        w[q] = __ldg(data + c + i);
      }
#pragma unroll
      for (int q = 0; q < kPerLaneV; ++q) {
        const V* src = reinterpret_cast<const V*>(x + static_cast<long long>(col[q]) * k + c0);
#pragma unroll
        for (int v = 0; v < kQ; ++v) xg[q][v] = __ldg(src + v);
      }
#pragma unroll
      for (int q = 0; q < kPerLaneV; ++q) {
        const int i = base + lane + 32 * q;
        if (i < len) {
          d[i] = w[q];
#pragma unroll
          for (int v = 0; v < kQ; ++v) xv[i * kQ + v] = xg[q][v];
        }
      }
    }
    __syncwarp();
    // This row's entries in the chunk, as positions in the row.
    const int pb = max(lo, c) - lo;
    const int pe = min(hi, c + len) - lo;
    if (chain) {
      for (int p = pb; p < pe; ++p) {
        const int t = lo + p - c;
        const T wt = d[t];
        V xt[kQ];
#pragma unroll
        for (int v = 0; v < kQ; ++v) xt[v] = xv[t * kQ + v];
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[0][e] = mul_add(wt, vec_at(xt[e / kV], e % kV), acc[0][e]);
      }
    } else if (lanes8) {
      for (int p0 = pb & ~(kLanes - 1); p0 < pe; p0 += kLanes) {
#pragma unroll
        for (int q = 0; q < kLanes; ++q) {
          const int p = p0 + q;
          const int t = min(max(lo + p, c), c + len - 1) - c;
          const T wt = d[t];
          V xt[kQ];
#pragma unroll
          for (int v = 0; v < kQ; ++v) xt[v] = xv[t * kQ + v];
          if (p >= pb && p < pe) {
#pragma unroll
            for (int e = 0; e < kCols; ++e) acc[q][e] = mul_add(wt, vec_at(xt[e / kV], e % kV), acc[q][e]);
          }
        }
      }
    } else {
      for (int p = pb; p < pe;) {
        const int offset = (p + pad) & (kWindow - 1);
        if (offset == 0) {
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            acc[1][e] = add_rn(acc[1][e], acc[0][e]);
            acc[0][e] = T(0);
          }
        }
        const int end = min(pe, p + kWindow - offset);
        for (; p < end; ++p) {
          const int t = lo + p - c;
          const T wt = d[t];
          V xt[kQ];
#pragma unroll
          for (int v = 0; v < kQ; ++v) xt[v] = xv[t * kQ + v];
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[0][e] = add_rn(acc[0][e], mul_rn(wt, vec_at(xt[e / kV], e % kV)));
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    if (chain) {
      out[e] = acc[0][e];
    } else if (lanes8) {
      out[e] = add_rn(add_rn(add_rn(acc[0][e], acc[4][e]), add_rn(acc[2][e], acc[6][e])),
                      add_rn(add_rn(acc[1][e], acc[5][e]), add_rn(acc[3][e], acc[7][e])));
    } else {
      out[e] = add_rn(acc[1][e], acc[0][e]);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    spmm_v_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                  const T* __restrict__ data, const T* __restrict__ x,
                  const T* __restrict__ deg, T* __restrict__ y, int n, int k,
                  int row_width) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kWidth;
  constexpr int kQ = kCols / kV;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  T* buf = reinterpret_cast<T*>(shared_raw) + warp * kBufferV;
  const int row = r0 + (threadIdx.x & 31);
  const long long base = static_cast<long long>(min(row, n - 1)) * k;
  const T dr = deg != nullptr ? __ldg(deg + min(row, n - 1)) : T(0);
  for (int c0 = 0; c0 < k; c0 += kCols) {
    T ax[kCols];
    row_sum_v<T>(indptr, indices, data, x, k, c0, buf, r0, n, row_width, ax);
    if (row < n) {
#pragma unroll
      for (int v = 0; v < kQ; ++v) {
        T part[kV];
        if (deg != nullptr) {
          const V xr = __ldg(reinterpret_cast<const V*>(x + base + c0) + v);
#pragma unroll
          for (int e = 0; e < kV; ++e) part[e] = mul_add(dr, vec_at(xr, e), -ax[v * kV + e]);
        } else {
#pragma unroll
          for (int e = 0; e < kV; ++e) part[e] = ax[v * kV + e];
        }
        reinterpret_cast<V*>(y + base + c0)[v] = vec_of(part);
      }
    }
  }
}

// spmv_v1_f32: y = A @ x in the order of the JAX package's v1 TPU SpMV
// (eig_kl_tpu/ops/spmv_pallas.py:_spmv_kernel, :339), from its chunk layout
// (ops/spmv_plan.py:build_v1_layout).  Per chunk of 512 slots, slot t's
// product (x[col] + 0) * w, rounded; then the TPU kernel's segmented
// Hillis-Steele scan (seg_scan.cuh), round k adding e[t - k] where slot
// t - k holds the same row (+0 otherwise); then the slot that ends its
// row's segment (the next slot holds another row, or t = 511) holds the
// row's total in that chunk.  A y window of 1,024 rows adds its chunks'
// totals in plan order, from +0: y = ((+0 + t1) + t2) + ... over the
// chunks where the row ends (a chunk where it does not adds +0, which moves
// no bit: y is never -0).  A window's chunks are sorted by column stripe,
// so one row ends in several of them.  No product is contracted into an
// add, as in the TPU kernel's interpret-mode program on the CPU.
//
// Design: one block of 512 threads per chunk, all chunks in flight (block
// b takes the b-th chunk in plan order).  The scan's steps 1..16 run in
// registers within each warp, steps 32..256 in shared memory: 5 block
// barriers per chunk.  The block spreads its totals into the window's
// 1,024 rows in shared memory (+0 where no segment ends; one writer per
// row, as a row ends once per chunk) and writes them to the scratch row of
// its plan position.  Then it takes its window's ticket (__threadfence,
// atomicAdd); the last of the window's blocks to arrive adds the window's
// scratch rows in plan order, two rows per thread, writes y and resets the
// ticket.  A window of one chunk writes y from shared memory and takes no
// ticket.  Blocks below the window count also write +0 into an empty
// window's rows.  The order of every add is fixed whichever block comes
// last, so y is deterministic.  The scratch and the tickets belong to one
// stream.
constexpr int kV1Chunk = seg_scan::kChunk;
constexpr int kV1Window = 1024;

// Slot `pos` of chunk c: (x[col] + 0) * w, rounded (x is +0 past n).
__device__ __forceinline__ float v1_product(const int* __restrict__ x_base, const short* __restrict__ col_local,
                                            const float* __restrict__ w, const float* __restrict__ x, int n,
                                            int c, int pos) {
  const long long slot = static_cast<long long>(c) * kV1Chunk + pos;
  const int cl = __ldg(x_base + c) + __ldg(col_local + slot);
  return __fmul_rn(__fadd_rn(cl < n ? __ldg(x + cl) : 0.0f, 0.0f), __ldg(w + slot));
}

__global__ void __launch_bounds__(kV1Chunk)
spmv_v1_kernel(const int* __restrict__ x_base, const short* __restrict__ col_local,
               const short* __restrict__ row_local, const float* __restrict__ w,
               const int* __restrict__ win_ptr, const int* __restrict__ win_chunks,
               const float* __restrict__ x, float* __restrict__ y, float* __restrict__ scratch,
               int* __restrict__ tickets, int n, int rows, int windows, int chunks) {
  __shared__ float buf[2][kV1Chunk];
  __shared__ short rl[kV1Chunk];
  __shared__ float y_s[kV1Window];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  if (b < windows && __ldg(win_ptr + b) == __ldg(win_ptr + b + 1)) {
    for (int q = t; q < kV1Window; q += kV1Chunk) {
      const long long row = static_cast<long long>(b) * kV1Window + q;
      if (row < rows) y[row] = 0.0f;
    }
  }
  if (b >= chunks) return;  // uniform per block
  const int c = __ldg(win_chunks + b);
  const long long base = static_cast<long long>(c) * kV1Chunk;
  const int r = __ldg(row_local + base + t);
  const float e = v1_product(x_base, col_local, w, x, n, c, t);
  const float e_lo = t >= 32 ? v1_product(x_base, col_local, w, x, n, c, t - 32) : 0.0f;
  const int r_lo = t >= 32 ? __ldg(row_local + base + t - 32) : -1;
  // The window of plan position b: win_ptr[win] <= b < win_ptr[win + 1].
  int win = 0;
  for (int hi = windows; hi - win > 1;) {
    const int mid = (win + hi) / 2;
    if (__ldg(win_ptr + mid) <= b) {
      win = mid;
    } else {
      hi = mid;
    }
  }
  const int first = __ldg(win_ptr + win);
  const int count = __ldg(win_ptr + win + 1) - first;
  const float v0 = seg_scan::warp_scan_steps(e, e_lo, r, r_lo, t & 31);
  y_s[t] = 0.0f;
  y_s[t + kV1Chunk] = 0.0f;
  const float* v = seg_scan::block_scan_steps(v0, r, buf, rl);
  if (t == kV1Chunk - 1 || rl[t + 1] != r) y_s[r] = v[t];
  __syncthreads();
  const long long row0 = static_cast<long long>(win) * kV1Window;
  if (count == 1) {
    for (int q = t; q < kV1Window; q += kV1Chunk) {
      if (row0 + q < rows) y[row0 + q] = __fadd_rn(0.0f, y_s[q]);
    }
    return;
  }
  float* out = scratch + static_cast<long long>(b) * kV1Window;
  out[t] = y_s[t];
  out[t + kV1Chunk] = y_s[t + kV1Chunk];
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(tickets + win, 1) == count - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int q = t; q < kV1Window; q += kV1Chunk) {
    float acc = 0.0f;
    const float* col = scratch + static_cast<long long>(first) * kV1Window + q;
    int i = 0;
    for (; i + 4 <= count; i += 4) {
      float part[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) part[k] = __ldcg(col + static_cast<long long>(i + k) * kV1Window);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = __fadd_rn(acc, part[k]);
    }
    for (; i < count; ++i) acc = __fadd_rn(acc, __ldcg(col + static_cast<long long>(i) * kV1Window));
    if (row0 + q < rows) y[row0 + q] = acc;
  }
  if (t == 0) tickets[win] = 0;
}

// spmv_v2_f32: y = A @ x in the order of the JAX package's v2 TPU SpMV
// (_gather_kernel, :1049, then _reduce_kernel_mxu, :1118, then the tail),
// from the port's layout of its plan (ops/spmv_plan.py:build_v2_layout): the
// CSR arrays of the entries the plan's buckets keep, the shift that marks
// where a row's partial restarts (a 512-slot sub-chunk of the reduce pass),
// and the spill.  The reduce's one-hot dot adds a row's slots one after the
// other from +0, in column order, and adds each sub-chunk's partial into y
// in turn; then the tail adds in.  So a row is a walk over its kept entries
// in CSR order with a partial that is added into the row's sum and restarts
// from +0 wherever col >> shift changes, then the tail: a COO tail's
// entries in column order, each y + round(w * x[col]), or (tail_y) the v1
// tail's row, computed first by spmv_v1_f32.  The COO tail comes as
// (row, col, w) triplets in CSR order, with where each warp's 32 rows start
// among them (tail_warp): a warp reads its two bounds before its walk, then
// its lanes walk the warp's triplets together, each adding those of its own
// row, so the tail costs its own entries and one word per 32 rows.  Products are rounded to f32
// (kBf16: then to bf16, round to nearest even), never contracted into an
// add, as in the TPU kernels' interpret-mode program on the CPU.
//
// The opt-in reduce kernels (EIG_KL_TPU_REDUCE_IMPL) add a sub-chunk's
// slots in another order, which needs each kept entry's slot in its
// sub-chunk (slot, 0-511):
//  * kReduce == kV2Lanes, _reduce_kernel_mxu2 (:1276) at row blocks up to
//    2,048: its factored dot keeps `lanes` (4 or 2) interleaved partials,
//    slot s adding into partial s % lanes from +0, and adds them pairwise,
//    (p0 + p1) + (p2 + p3) or p0 + p1 (from 2,176 rows on, its order is
//    the default's and the wrapper sends it there);
//  * kReduce == kV2Blocks, _reduce_kernel (:1080, "vpu"): its sum over the
//    512 slots adds each 32 slots from +0, then those block sums one after
//    the other.
// TW is the weights' type: float, or __nv_bfloat16 (EIG_KL_TPU_BF16_W, the
// plan's weights_bf16, read only with bf16 products: the product
// round(x * float(w)) in f32, then to bf16).
//
// Design: K1's warp per 32 rows.  The warp's rows span one range of the
// kept entries; its lanes stage that range 256 entries at a time into
// shared memory, loads coalesced and 8 gathers of x in flight per lane:
// each entry's rounded product and its sub-chunk (col >> shift; with the
// slot in the low 9 bits where the order reads it).  Then each lane walks
// its own row in the buffer, carrying its partials and its sum across the
// stages; the mxu2 order adds each entry into every partial, +0 into those
// of the other slot classes, so the lanes of a warp never diverge on a
// class (a switch on it took 1.8 times as long on the card).  kLazy: the
// lazy walk 0.5 * fma(dsinv, A z, w), x being w, the gather z[j] = dsinv[j]
// * w[j] (lazy_rescale's, one rounding), the COO tail's gathers too; the
// epilogue reads w and dsinv coalesced.  Rows n .. rows - 1 (the padded
// state's padding) are empty.
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
               const float* __restrict__ x, const float* __restrict__ z,
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
  const float* __restrict__ gathered = kLazy ? z : x;
  auto gather = [&](int j) { return __ldg(gathered + j); };
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
          // Each partial adds e or +0: a partial from +0 is never -0, so
          // the +0 adds move no bit, and no lane branches on the class.
          const int cls = gs & (lanes - 1);
          part = __fadd_rn(part, cls == 0 ? e : 0.0f);
          p1 = __fadd_rn(p1, cls == 1 ? e : 0.0f);
          p2 = __fadd_rn(p2, cls == 2 ? e : 0.0f);
          p3 = __fadd_rn(p3, cls == 3 ? e : 0.0f);
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

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <class T>
size_t shared_bytes(int row_width) {
  return static_cast<size_t>(kWarps) * buffer_values<T>(row_width) * sizeof(T);
}

template <class T>
int spmv_csr(const void* indptr, const void* indices, const void* data, const void* x,
             void* y, int n, int row_width, void* stream) {
  if (n > 0) {
    spmv_csr_kernel<T><<<blocks_for(n), kThreads, shared_bytes<T>(row_width),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), n,
        row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int power_step(const void* indptr, const void* indices, const void* data, const void* x,
               const void* deg, T inv_shift, void* y, int n, int row_width, int lanes,
               void* stream) {
  if (n > 0) {
    power_step_kernel<T><<<blocks_for(n), kThreads, shared_bytes<T>(row_width),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<const T*>(deg),
        inv_shift, static_cast<T*>(y), n, row_width, lanes != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int laplacian(const void* indptr, const void* indices, const void* data, const void* x,
              const void* deg, void* y, int n, int row_width, void* stream) {
  if (n > 0) {
    laplacian_kernel<T><<<blocks_for(n), kThreads, shared_bytes<T>(row_width),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<const T*>(deg),
        static_cast<T*>(y), n, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int spmm_csr(const void* indptr, const void* indices, const void* data, const void* x,
             const void* deg, void* y, int n, int k, int row_width, void* stream) {
  if (k < 1 || k > 16) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  constexpr int kV = Vec16<T>::kWidth;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  const auto* dp = static_cast<const T*>(data);
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const T*>(deg);
  auto* yp = static_cast<T*>(y);
  if (n > 0 && k % 4 == 0 && aligned) {
    spmm_v_kernel<T><<<blocks_for(n), kThreads, kWarps * kBufferV * sizeof(T), s>>>(
        ip, ix, dp, xp, gp, yp, n, k, row_width);
  } else if (n > 0) {
    spmm_kernel<T><<<blocks_for(n), kThreads, shared_bytes<T>(row_width),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<const T*>(deg),
        static_cast<T*>(y), n, k, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int lazy_walk(const void* indptr, const void* indices, const void* data, const void* w,
              const void* z, const void* dsinv, const void* u, const void* c, void* y, int n,
              int row_width, void* stream) {
  if ((u == nullptr) != (c == nullptr) || z == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    lazy_walk_kernel<T><<<blocks_for(n), kThreads, shared_bytes<T>(row_width),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(w), static_cast<const T*>(z),
        static_cast<const T*>(dsinv), static_cast<const T*>(u), static_cast<const T*>(c),
        static_cast<T*>(y), n, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int lazy_rescale(const void* u, const void* w, const void* inv, const void* dsinv, void* u_out,
                 void* w_out, void* z, int n, void* stream) {
  if ((inv == nullptr) != (u_out == nullptr) || (w == nullptr) != (w_out == nullptr) ||
      (w != nullptr && inv == nullptr) || z == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    lazy_rescale_kernel<T><<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(w), static_cast<const T*>(inv),
        static_cast<const T*>(dsinv), static_cast<T*>(u_out), static_cast<T*>(w_out), static_cast<T*>(z), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spmv_csr_f32(const void* indptr, const void* indices, const void* data,
                            const void* x, void* y, int n, int row_width, void* stream) {
  return spmv_csr<float>(indptr, indices, data, x, y, n, row_width, stream);
}

extern "C" int spmv_csr_f64(const void* indptr, const void* indices, const void* data,
                            const void* x, void* y, int n, int row_width, void* stream) {
  return spmv_csr<double>(indptr, indices, data, x, y, n, row_width, stream);
}

// lanes: the row sums in the 8 lanes at W <= 16 too (the solve's first step).
extern "C" int power_step_f32(const void* indptr, const void* indices, const void* data,
                              const void* x, const void* deg, float inv_shift, void* y,
                              int n, int row_width, int lanes, void* stream) {
  return power_step<float>(indptr, indices, data, x, deg, inv_shift, y, n, row_width, lanes, stream);
}

extern "C" int power_step_f64(const void* indptr, const void* indices, const void* data,
                              const void* x, const void* deg, double inv_shift, void* y,
                              int n, int row_width, int lanes, void* stream) {
  return power_step<double>(indptr, indices, data, x, deg, inv_shift, y, n, row_width, lanes, stream);
}

extern "C" int laplacian_f32(const void* indptr, const void* indices, const void* data,
                             const void* x, const void* deg, void* y, int n, int row_width,
                             void* stream) {
  return laplacian<float>(indptr, indices, data, x, deg, y, n, row_width, stream);
}

extern "C" int laplacian_f64(const void* indptr, const void* indices, const void* data,
                             const void* x, const void* deg, void* y, int n, int row_width,
                             void* stream) {
  return laplacian<double>(indptr, indices, data, x, deg, y, n, row_width, stream);
}

// deg may be null: then Y = A @ X.
extern "C" int spmm_csr_f32(const void* indptr, const void* indices, const void* data,
                            const void* x, const void* deg, void* y, int n, int k,
                            int row_width, void* stream) {
  return spmm_csr<float>(indptr, indices, data, x, deg, y, n, k, row_width, stream);
}

extern "C" int spmm_csr_f64(const void* indptr, const void* indices, const void* data,
                            const void* x, const void* deg, void* y, int n, int k,
                            int row_width, void* stream) {
  return spmm_csr<double>(indptr, indices, data, x, deg, y, n, k, row_width, stream);
}

// z = dsinv * w (lazy_rescale's); u and c (both null, or both set): the
// epilogue 0.5 * (u * c + dsinv * Ax), c one value, its product fused.
extern "C" int lazy_walk_f32(const void* indptr, const void* indices, const void* data,
                             const void* w, const void* z, const void* dsinv, const void* u,
                             const void* c, void* y, int n, int row_width, void* stream) {
  return lazy_walk<float>(indptr, indices, data, w, z, dsinv, u, c, y, n, row_width, stream);
}

extern "C" int lazy_walk_f64(const void* indptr, const void* indices, const void* data,
                             const void* w, const void* z, const void* dsinv, const void* u,
                             const void* c, void* y, int n, int row_width, void* stream) {
  return lazy_walk<double>(indptr, indices, data, w, z, dsinv, u, c, y, n, row_width, stream);
}

// u_out = u * inv, w_out = w * inv (inv one value on the card) and z =
// dsinv * u_out, n values each: the momentum step's rescale and its next
// walk's z.
extern "C" int lazy_rescale_f32(const void* u, const void* w, const void* inv, const void* dsinv,
                                void* u_out, void* w_out, void* z, int n, void* stream) {
  return lazy_rescale<float>(u, w, inv, dsinv, u_out, w_out, z, n, stream);
}

extern "C" int lazy_rescale_f64(const void* u, const void* w, const void* inv, const void* dsinv,
                                void* u_out, void* w_out, void* z, int n, void* stream) {
  return lazy_rescale<double>(u, w, inv, dsinv, u_out, w_out, z, n, stream);
}

// The standalone z pass, z = dsinv * w: lazy_rescale's kernel with no inv.
extern "C" int lazy_z_f32(const void* w, const void* dsinv, void* z, int n, void* stream) {
  return lazy_rescale<float>(w, nullptr, nullptr, dsinv, nullptr, nullptr, z, n, stream);
}

extern "C" int lazy_z_f64(const void* w, const void* dsinv, void* z, int n, void* stream) {
  return lazy_rescale<double>(w, nullptr, nullptr, dsinv, nullptr, nullptr, z, n, stream);
}

// win_ptr/win_chunks: each y window's chunks in plan order (chunks in all);
// windows = P / 1024; x holds n values (or the padded state), y gets rows
// (n, or P) values; scratch holds chunks * 1,024 floats and tickets
// windows ints, zero (each launch leaves them zero), both the stream's own.
extern "C" int spmv_v1_f32(const void* x_base, const void* col_local, const void* row_local,
                           const void* w, const void* win_ptr, const void* win_chunks,
                           const void* x, void* y, void* scratch, void* tickets, int n, int rows,
                           int windows, int chunks, void* stream) {
  if (rows < n || rows > windows * kV1Window || chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (windows > 0) {
    spmv_v1_kernel<<<max(windows, chunks), kV1Chunk, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x_base), static_cast<const short*>(col_local),
        static_cast<const short*>(row_local), static_cast<const float*>(w),
        static_cast<const int*>(win_ptr), static_cast<const int*>(win_chunks),
        static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(scratch),
        static_cast<int*>(tickets), n, rows, windows, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The kept entries' CSR arrays (ptr, cols, w: float, or bf16 for the bf16w
// forms), their slots in their sub-chunks (slot, int16; read by the mxu2
// and vpu forms only, null for the others), the restart shift and the mxu2
// forms' lanes (2 or 4); the tail: a COO tail's triplets (tail_rows,
// tail_cols, tail_w) in CSR order and tail_warp, where the triplets of rows
// 32 i .. 32 i + 31 start (i up to ceil(n / 32)), or tail_y, the v1 tail's
// A @ x (at most one of the two, or neither).  x (the lazy walk: w) and y
// hold rows values (n, or the padded state's P); z and dsinv (the lazy
// walk's, null for the SpMV) as many.
template <bool kBf16, bool kLazy, int kReduce, class TW>
int spmv_v2(const void* ptr, const void* cols, const void* w, const void* slot, int shift, int lanes,
            const void* tail_warp, const void* tail_rows, const void* tail_cols, const void* tail_w,
            const void* tail_y, const void* x, const void* z, const void* dsinv, void* y, int n, int rows,
            void* stream) {
  const bool coo = tail_warp != nullptr;
  if (rows < n || (tail_y != nullptr && coo) || coo != (tail_rows != nullptr) ||
      coo != (tail_cols != nullptr) || coo != (tail_w != nullptr) || kLazy != (dsinv != nullptr) ||
      kLazy != (z != nullptr) ||
      (kReduce == kV2Seq) != (slot == nullptr) || (kReduce == kV2Lanes) != (lanes == 2 || lanes == 4) ||
      (kReduce != kV2Lanes && lanes != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    spmv_v2_kernel<kBf16, kLazy, kReduce, TW><<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(cols), static_cast<const TW*>(w),
        static_cast<const short*>(slot), shift, lanes, static_cast<const int*>(tail_warp),
        static_cast<const int*>(tail_rows), static_cast<const int*>(tail_cols),
        static_cast<const float*>(tail_w), static_cast<const float*>(tail_y), static_cast<const float*>(x),
        static_cast<const float*>(z), static_cast<const float*>(dsinv), static_cast<float*>(y), n, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The v2 entry points: spmv_v2[_mxu2 | _vpu][_bf16i | _bf16w]_f32 (ptr,
// cols, w, slot, shift, lanes, tail_warp, tail_rows, tail_cols, tail_w,
// tail_y, x, dsinv, y, n, rows, stream; dsinv null), y = A @ x with f32
// products, bf16 products, or bf16 products of bf16 weights, in the order
// of the default reduce, of _reduce_kernel_mxu2 or of _reduce_kernel;
// lazy_walk_v2..._f32 (x, z, dsinv in place of x, dsinv) the same with y =
// 0.5 * fma(dsinv, A z, w), x being w and z = dsinv * w, tail_y (if set)
// the v1 tail's A z.
#define V2_ENTRY(NAME, BF16, REDUCE, TW)                                                                \
  extern "C" int NAME(const void* ptr, const void* cols, const void* w, const void* slot, int shift,    \
                      int lanes, const void* tail_warp, const void* tail_rows, const void* tail_cols,   \
                      const void* tail_w, const void* tail_y, const void* x, const void* dsinv, void* y, \
                      int n, int rows, void* stream) {                                                  \
    return spmv_v2<BF16, false, REDUCE, TW>(ptr, cols, w, slot, shift, lanes, tail_warp, tail_rows,     \
                                            tail_cols, tail_w, tail_y, x, nullptr, dsinv, y, n, rows,    \
                                            stream);                                                    \
  }
#define V2_LAZY_ENTRY(NAME, BF16, REDUCE, TW)                                                           \
  extern "C" int NAME(const void* ptr, const void* cols, const void* w, const void* slot, int shift,    \
                      int lanes, const void* tail_warp, const void* tail_rows, const void* tail_cols,   \
                      const void* tail_w, const void* tail_y, const void* x, const void* z,             \
                      const void* dsinv, void* y, int n, int rows, void* stream) {                      \
    return spmv_v2<BF16, true, REDUCE, TW>(ptr, cols, w, slot, shift, lanes, tail_warp, tail_rows,       \
                                           tail_cols, tail_w, tail_y, x, z, dsinv, y, n, rows, stream);  \
  }

#define V2_FORMS(SPMV, LAZY_WALK, REDUCE)                                        \
  V2_ENTRY(SPMV##_f32, false, REDUCE, float)                                     \
  V2_ENTRY(SPMV##_bf16i_f32, true, REDUCE, float)                                \
  V2_ENTRY(SPMV##_bf16w_f32, true, REDUCE, __nv_bfloat16)                        \
  V2_LAZY_ENTRY(LAZY_WALK##_f32, false, REDUCE, float)                           \
  V2_LAZY_ENTRY(LAZY_WALK##_bf16i_f32, true, REDUCE, float)                      \
  V2_LAZY_ENTRY(LAZY_WALK##_bf16w_f32, true, REDUCE, __nv_bfloat16)

V2_FORMS(spmv_v2, lazy_walk_v2, kV2Seq)
V2_FORMS(spmv_v2_mxu2, lazy_walk_v2_mxu2, kV2Lanes)
V2_FORMS(spmv_v2_vpu, lazy_walk_v2_vpu, kV2Blocks)

extern "C" const char* spmv_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
