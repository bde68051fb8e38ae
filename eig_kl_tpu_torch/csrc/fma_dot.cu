// K4: x . y for float32 (fma_dot_f32) or float64 (fma_dot_f64) vectors in
// the order of XLA's CPU vector dot (jnp.vdot): from acc = +0, the first 8
// products rounded and added in index order, acc = acc + x[i] * y[i], then
// one chain of fused multiply-adds, acc = fma(x[i], y[i], acc), in index
// order over the rest.  That is how XLA's CPU backend compiles the JAX
// package's vector dot in both types (held against jax.jit(jnp.vdot) by
// tests/test_torch_spmv_v3.py at f32 and tests/test_torch_f64.py at x64).
//
// The dot serves the power solve: the Rayleigh quotient over the padded
// state of a v3-planned graph (eig_kl_tpu/spectral/power.py:413), and the
// momentum exit's deflation and Rayleigh quotient (power.py:309, :336), in
// f32 and f64.  It replaces no Pallas kernel: the JAX package leaves the
// dot to XLA.  Its plain version is ops/reduce.py:fma_dot_plain, the same
// chain on the host.
//
// Bound on this card: bytes.  One call must read x and y once and write
// one value, 1.6 MB at gen 1.0x (P = 202,752) in f32, or 0.48 us at 3.35
// TB/s (f64 at n = 184,406: 3.0 MB, 0.88 us).  The chain itself is
// sequential: n dependent fused multiply-adds, about 4 cycles each, take
// far longer than that.
//
// Design: one block.  Its warps 1..7 stage the next tile of x and y in
// shared memory (coalesced loads) while thread 0 runs the chain through
// the current tile; the two tiles alternate.  The order of the adds is
// the index order whatever the tiling, so the result equals the host's
// chain bit for bit.  A tile holds 8 KB of each vector: 2,048 floats or
// 1,024 doubles.

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnfused = 8;  // the products XLA rounds before adding them

template <class T>
constexpr int kTile = 8192 / static_cast<int>(sizeof(T));

template <class T>
__global__ void __launch_bounds__(kThreads)
    fma_dot_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
                   int n) {
  constexpr int kT = kTile<T>;
  __shared__ T sx[2][kT];
  __shared__ T sy[2][kT];
  const int t = threadIdx.x;
  const int n_tiles = (n + kT - 1) / kT;
  for (int i = t; i < kT && i < n; i += kThreads) {
    sx[0][i] = x[i];
    sy[0][i] = y[i];
  }
  __syncthreads();
  T acc = T(0);
  if (t == 0) {
    // The first products, rounded and added; then zeros in their place in
    // the first tile, whose fused steps fma(0, 0, acc) leave acc as it is
    // (acc is never -0: it starts at +0, and no add of an exact zero
    // turns +0 into -0), so the chain below runs from index 0 unchanged.
    for (int i = 0; i < min(n, kUnfused); ++i) {
      acc = add_rn(acc, mul_rn(sx[0][i], sy[0][i]));
      sx[0][i] = T(0);
      sy[0][i] = T(0);
    }
  }
  for (int k = 0; k < n_tiles; ++k) {
    const int cur = k & 1;
    if (t >= 32) {
      const int base = (k + 1) * kT;
      for (int i = t - 32; i < kT && base + i < n; i += kThreads - 32) {
        sx[cur ^ 1][i] = x[base + i];
        sy[cur ^ 1][i] = y[base + i];
      }
    } else if (t == 0) {
      const int len = min(kT, n - k * kT);
#pragma unroll 8
      for (int i = 0; i < len; ++i) acc = fma_rn(sx[cur][i], sy[cur][i], acc);
    }
    __syncthreads();
  }
  if (t == 0) *out = acc;
}

template <class T>
int fma_dot(const void* x, const void* y, void* out, int n, void* stream) {
  fma_dot_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fma_dot_f32(const void* x, const void* y, void* out, int n, void* stream) {
  return fma_dot<float>(x, y, out, n, stream);
}

extern "C" int fma_dot_f64(const void* x, const void* y, void* out, int n, void* stream) {
  return fma_dot<double>(x, y, out, n, stream);
}

extern "C" const char* fma_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
