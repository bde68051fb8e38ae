// K4: x . y for float32 (fma_dot_batch_f32) or float64 (fma_dot_batch_f64)
// vectors in the order of XLA's CPU vector dot (jnp.vdot): from acc = +0,
// the first 8 products rounded and added in index order, acc = acc + x[i]
// * y[i], then one chain of fused multiply-adds, acc = fma(x[i], y[i],
// acc), in index order over the rest.  That is how XLA's CPU backend
// compiles the JAX package's vector dot in both types (held against
// jax.jit(jnp.vdot) by tests/test_torch_spmv_v3.py at f32 and
// tests/test_torch_f64.py at x64).  One launch runs up to 4 such dots of
// one length, each its own chain (grid = (count,)).
//
// The dot serves the power solve: the Rayleigh quotient over the padded
// state of a v3-planned graph (eig_kl_tpu/spectral/power.py:413), and the
// momentum exit's deflation and Rayleigh quotient (power.py:309, :336), in
// f32 and f64; the two deflation dots of a check are one launch.  It
// replaces no Pallas kernel: the JAX package leaves the dot to XLA.  Its
// plain version is ops/reduce.py:fma_dot_plain, the same chain on the host.
//
// Bound on this card: bytes, 1.6 MB per dot at gen 1.0x (P = 202,752) in
// f32, 0.48 us at 3.35 TB/s (f64 at n = 184,406: 3.0 MB, 0.88 us).  The
// chain is sequential: its floor is n dependent fused multiply-adds, about
// 4.1 cycles each in f32 and 8.0 in f64 (tools/k1_k6_floors.py's probe).
//
// Design: one block per dot.  Warp 1 copies tiles of x and y into a ring of
// kStages stages in shared memory with cp.async (16 bytes at a time where
// both vectors are 16-byte aligned); each stage has an mbarrier that the
// copies complete ("full") and one that the chaining thread arrives on when
// it is done with the stage ("empty"), so neither side waits at a
// __syncthreads after the one that follows the barriers' set-up.  Thread 0
// runs the chain through each stage (fp.cuh's chain): groups of kGroup
// values of x and y come into registers 16 bytes at a time, the next
// group's loads spread between the current group's multiply-adds, so that
// only the multiply-add latency stands on the chain.  The first 8 products are
// rounded and added before the chain; their places in the first stage, and
// the places after n in the last group, hold x = -0, y = +0, whose fused
// step fma(-0, +0, acc) leaves every acc as it is (-0 included).  The
// order of the adds is the index order whatever the tiling, so the result
// equals the host's chain bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "fp.cuh"

namespace {

constexpr int kMaxPairs = 4;
constexpr int kUnfused = 8;  // the products XLA rounds before adding them
constexpr int kStages = 4;

// A stage holds 4 KB of each vector; the chain reads kGroup values of each
// per step (32 floats or 16 doubles: 8 loads of 16 bytes per vector).
template <class T>
constexpr int kTile = 4096 / static_cast<int>(sizeof(T));
template <class T>
constexpr int kGroup = 128 / static_cast<int>(sizeof(T));

template <class T>
struct Pairs {
  const T* x[kMaxPairs];
  const T* y[kMaxPairs];
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src), "n"(kBytes)
                 : "memory");
  }
}

// The arrive-on of `bar` once this thread's cp.async copies so far are done.
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

template <class T>
__global__ void __launch_bounds__(64)
    fma_dot_batch_kernel(Pairs<T> pairs, T* __restrict__ out, int n) {
  constexpr int kV = Vec16<T>::kWidth;
  constexpr int kT = kTile<T>;
  constexpr int kG = kGroup<T>;
  __shared__ __align__(16) T sx[kStages][kT];
  __shared__ __align__(16) T sy[kStages][kT];
  __shared__ uint64_t full[kStages], empty[kStages];
  const T* __restrict__ x = pairs.x[blockIdx.x];
  const T* __restrict__ y = pairs.y[blockIdx.x];
  const int n_tiles = (n + kT - 1) / kT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // one arrive per lane of the copying warp
      mbar_init(&empty[s], 1);  // the chaining thread
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    // The copying warp: tile k into stage k % kStages once the chain has
    // left that stage's previous tile.
    const int lane = threadIdx.x - 32;
    const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % kStages;
      if (k >= kStages) mbar_wait(&empty[s], ((k / kStages) + 1) & 1);
      const int base = k * kT;
      const int len = min(kT, n - base);
      int i = lane;
      if (vec) {
        for (int j = lane * kV; j + kV <= len; j += 32 * kV) {
          copy_async<16>(&sx[s][j], x + base + j);
          copy_async<16>(&sy[s][j], y + base + j);
        }
        i = len / kV * kV + lane;
      }
      for (; i < len; i += 32) {
        copy_async<sizeof(T)>(&sx[s][i], x + base + i);
        copy_async<sizeof(T)>(&sy[s][i], y + base + i);
      }
      copies_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  if (threadIdx.x != 0) return;
  T acc = T(0);
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], (k / kStages) & 1);
    T* tx = sx[s];
    T* ty = sy[s];
    const int len = min(kT, n - k * kT);
    const int used = (len + kG - 1) / kG * kG;
    if (k == 0) {
      // The rounded products first, then -0 * +0 in their places.
      for (int i = 0; i < min(len, kUnfused); ++i) {
        acc = add_rn(acc, mul_rn(tx[i], ty[i]));
        tx[i] = -T(0);
        ty[i] = T(0);
      }
    }
    for (int i = len; i < used; ++i) {
      tx[i] = -T(0);
      ty[i] = T(0);
    }
    // The chain over the stage, a group of kG ahead in registers; a full
    // stage's length a constant, which the compiler schedules better.
    const auto fma_step = [](T c, T a, T b) { return fma_rn(a, b, c); };
    acc = used == kT ? chain<kG, 2>(tx, ty, kT, acc, fma_step)
                     : chain<kG, 2>(tx, ty, used, acc, fma_step);
    mbar_arrive(&empty[s]);
  }
  out[blockIdx.x] = acc;
}

// xs, ys: host arrays of `count` device pointers (1 <= count <= 4), each
// vector n long; out: `count` values on the card.
template <class T>
int fma_dot_batch(const void* const* xs, const void* const* ys, void* out, int count, int n,
                  void* stream) {
  if (count < 1 || count > kMaxPairs || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Pairs<T> pairs{};
  for (int k = 0; k < count; ++k) {
    pairs.x[k] = static_cast<const T*>(xs[k]);
    pairs.y[k] = static_cast<const T*>(ys[k]);
  }
  fma_dot_batch_kernel<T><<<count, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      pairs, static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fma_dot_batch_f32(const void* const* xs, const void* const* ys, void* out, int count,
                                 int n, void* stream) {
  return fma_dot_batch<float>(xs, ys, out, count, n, stream);
}

extern "C" int fma_dot_batch_f64(const void* const* xs, const void* const* ys, void* out, int count,
                                 int n, void* stream) {
  return fma_dot_batch<double>(xs, ys, out, count, n, stream);
}

extern "C" const char* fma_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
