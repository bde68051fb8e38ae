// K4: x . y for float32 vectors as one chain of fused multiply-adds in
// index order, acc = fmaf(x[i], y[i], acc) from acc = +0.
//
// This is how XLA's CPU backend computes the JAX package's vector dot
// (jnp.vdot), which the power solve's Rayleigh quotient takes over the
// padded state of a v3-planned graph (eig_kl_tpu/spectral/power.py:413).
// It replaces no Pallas kernel: the JAX package leaves the dot to XLA.
// Its plain version is ops/reduce.py:fma_dot_plain, the same chain on the
// host.
//
// Bound on this card: bytes.  One call must read x and y once and write
// one float, 1.6 MB at gen 1.0x (P = 202,752), or 0.48 us at 3.35 TB/s.
// The chain itself is sequential: P dependent fused multiply-adds, about
// 4 cycles each, take far longer than that.
//
// Design: one block.  Its warps 1..7 stage the next tile of x and y in
// shared memory (coalesced loads) while thread 0 runs the chain through
// the current tile; the two tiles alternate.  The order of the adds is
// the index order whatever the tiling, so the result equals the host's
// chain bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__global__ void __launch_bounds__(kThreads)
    fma_dot_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int n) {
  __shared__ float sx[2][kTile];
  __shared__ float sy[2][kTile];
  const int t = threadIdx.x;
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int i = t; i < kTile && i < n; i += kThreads) {
    sx[0][i] = x[i];
    sy[0][i] = y[i];
  }
  __syncthreads();
  float acc = 0.0f;
  for (int k = 0; k < n_tiles; ++k) {
    const int cur = k & 1;
    if (t >= 32) {
      const int base = (k + 1) * kTile;
      for (int i = t - 32; i < kTile && base + i < n; i += kThreads - 32) {
        sx[cur ^ 1][i] = x[base + i];
        sy[cur ^ 1][i] = y[base + i];
      }
    } else if (t == 0) {
      const int len = min(kTile, n - k * kTile);
#pragma unroll 8
      for (int i = 0; i < len; ++i) acc = __fmaf_rn(sx[cur][i], sy[cur][i], acc);
    }
    __syncthreads();
  }
  if (t == 0) *out = acc;
}

}  // namespace

extern "C" int fma_dot_f32(const void* x, const void* y, void* out, int n,
                           void* stream) {
  fma_dot_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fma_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
