// K1: y = A @ x for the symmetric CSR adjacency, in float32.
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
// 3.4 us at 3.35 TB/s; its 2*nnz flops are negligible.
//
// Design: one thread per row, which adds the row in one fixed order with
// no atomics, so the result is deterministic.  The order is XLA's CPU
// order for the JAX package's f32 ELL SpMV, which depends on the ELL width
// W (the largest degree rounded up to a multiple of 8):
// * W <= 32: entry k of the row goes to lane k mod 8; each lane
//   accumulates with fused multiply-adds; the lanes combine as
//   ((l0+l4) + (l2+l6)) + ((l1+l5) + (l3+l7)).
// * W > 32: windows of 32 positions after (32*ceil(W/32) - W)/2 leading pad
//   positions; each window adds its rounded products in order, and the
//   window sums add in order.
// So K1, the plain version (ops/spmv.py) and the JAX package's CPU SpMV
// agree bit for bit.  Neighbouring threads walk neighbouring rows, whose
// spans are contiguous, and x (0.8 MB at gen 1.0x) stays in L2 across the
// gathers.  At a mean degree of 5.5 a thread's loads are short; a warp per
// group of rows with coalesced loads is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;
constexpr int kWindow = 32;

__global__ void spmv_csr_kernel(const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const float* __restrict__ data,
                                const float* __restrict__ x,
                                float* __restrict__ y, int n, int row_width) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int lo = indptr[row];
  const int hi = indptr[row + 1];
  float out = 0.0f;
  if (row_width <= kWindow) {
    float acc[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) acc[l] = 0.0f;
    for (int k0 = lo; k0 < hi; k0 += kLanes) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const int k = k0 + l;
        if (k < hi) acc[l] = __fmaf_rn(data[k], __ldg(x + indices[k]), acc[l]);
      }
    }
    out = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[4]), __fadd_rn(acc[2], acc[6])),
                    __fadd_rn(__fadd_rn(acc[1], acc[5]), __fadd_rn(acc[3], acc[7])));
  } else {
    const int windows = (row_width + kWindow - 1) / kWindow;
    const int pad = (windows * kWindow - row_width) / 2;
    for (int j = 0; j < windows; ++j) {
      const int a = max(lo + j * kWindow - pad, lo);
      const int b = min(lo + (j + 1) * kWindow - pad, hi);
      float s = 0.0f;
      for (int k = a; k < b; ++k) {
        s = __fadd_rn(s, __fmul_rn(data[k], __ldg(x + indices[k])));
      }
      out = __fadd_rn(out, s);
    }
  }
  y[row] = out;
}

}  // namespace

extern "C" int spmv_csr_f32(const void* indptr, const void* indices,
                            const void* data, const void* x, void* y, int n,
                            int row_width, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    spmv_csr_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const float*>(data), static_cast<const float*>(x),
        static_cast<float*>(y), n, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
