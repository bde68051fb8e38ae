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
//
// fused_dot_batch_f32: the dot XLA emits as a loop with an operand's
// element-wise producer fused in (below 4,096 values; ops/reduce.py:
// fused_dot_batch).  Up to chain_max values: one chain of fused
// multiply-adds from +0, no product rounded on its own ("chain" at every
// length).  The "rows" order (flag kRows, a graph of ELL width 8): 4 or 8
// lane chains (rows_dot_lanes) over n / lanes * lanes elements, lane 0 from
// +0 and the others from -0, folded in halves, then the scalar chain.
// Beyond, LLVM's vectorized loop, whose shape depends on the producer fused
// in (ops/reduce.py:LANES_FORMS, passed as chain_max,
// unrolled_max and flags): up to unrolled_max values unrolled fully and
// reassociated (unrolled_lanes); beyond, lane k of a warp chains the
// elements i = k (mod 32) of the whole groups of 32 from +0 (lane 0) or
// -0; thread 0 adds the four 8-lane accumulators, ((a1 + a0) + a2) + a3,
// folds the 8 lanes in halves, runs the vector epilogue of 8 or 4 lanes
// over the rest (started from that sum in its lane 0) and the scalar steps
// after it.  In a vectorized order one value is its product.  Bound:
// latency.
// fused_dot gives it at most 4,095 values of each vector, 32 KB in all, so
// the block (256 threads, grid = (count,)) stages both in shared memory in
// one coalesced pass of 16-byte loads, whose latencies overlap (a longer
// dot: 4,096 values at a time), and the chains then read shared memory: the
// "chain" through fp.cuh's chain (a group of 32 values ahead in registers,
// so that only the fused multiply-add's latency stands on it: its floor is
// n x 4.1 cycles), each lane chain eight steps' values at a time.

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

// Lanes of an accumulator's fold in halves: l[i] + l[i + h].
__device__ __forceinline__ float fold_lanes(float* a, int lanes) {
  for (int h = lanes / 2; h >= 1; h /= 2) {
    for (int j = 0; j < h; ++j) a[j] = add_rn(a[j], a[j + h]);
  }
  return a[0];
}

// The vector epilogue's lanes for r < 32 elements: the width of fewer
// steps r / w + r % w, on a tie 8 where `wide_ties`, else 4; none below 4
// (ops/reduce.py:dot_epilogue_width).
__device__ __forceinline__ int epilogue_width(int r, bool wide_ties) {
  const int steps8 = r / 8 + r % 8, steps4 = r / 4 + r % 4;
  if (r >= 8 && (steps8 < steps4 || (steps8 == steps4 && wide_ties))) return 8;
  return r >= 4 ? 4 : 0;
}

// The bits of fused_dot_batch_f32's flags (ops/reduce.py:_k4_form_args).
constexpr int kPairsAt6 = 1, kWideTies = 2, kVector = 4, kUnrolledTies = 8, kRows = 16;

// The "rows" order's lanes for n values, 0 for one scalar chain
// (ops/reduce.py:rows_dot_lanes): the vector loop LLVM gives the quotients
// of a graph of ELL width 8, vectorized across rows.
__device__ __forceinline__ int rows_dot_lanes(int n) {
  if (n == 4 || n == 8) return n;
  if (n < 16) return 0;
  return (n % 8 < 4 || n >= 84) ? 8 : 4;
}

constexpr int kFusedThreads = 256;
constexpr int kFusedTile = 4096;  // values of each vector a block stages at a time

// A vectorized order where LLVM unrolls the loop fully and reassociates it
// (ops/reduce.py:unrolled_lanes_plan), by one thread from shared memory:
// one 8-lane accumulator over the blocks of 8 in the plan's order, its
// fold in halves, the epilogue of 2, 4 or 8 lanes (8 at the tie of 28 to 31
// values where `unrolled_ties`) and the scalar steps.
__device__ float unrolled_lanes(const float* sx, const float* sy, int n, bool pairs_at_6, bool unrolled_ties) {
  const int inter = 48 <= n && n < 64 ? 2 : 4;
  const int trips = n / (8 * inter);
  float acc[8];
  for (int j = 0; j < 8; ++j) acc[j] = j == 0 ? 0.0f : -0.0f;
  auto block = [&](int b) {
    for (int j = 0; j < 8; ++j) acc[j] = fma_rn(sx[8 * b + j], sy[8 * b + j], acc[j]);
  };
  for (int t = 0; t < trips; ++t) block(inter * t);
  for (int k = 1; k < inter; ++k) {
    if (trips > 1) block(k + inter);
    block(k);
    for (int t = 2; t < trips; ++t) block(k + inter * t);
  }
  float total = fold_lanes(acc, 8);
  int i = 8 * inter * trips;
  const int r = n - i;
  const bool pair = r == 2 || r == 3 || (pairs_at_6 && (r == 6 || r == 7));
  const int width = pair ? 2 : r < 4 ? 0 : (unrolled_ties && r >= 28) ? 8 : (r / 4) % 2 ? 4 : 8;
  if (width > 0) {
    float e[8];
    for (int j = 0; j < width; ++j) e[j] = j == 0 ? total : -0.0f;
    for (; n - i >= width; i += width) {
      for (int j = 0; j < width; ++j) e[j] = fma_rn(sx[i + j], sy[i + j], e[j]);
    }
    total = fold_lanes(e, width);
  }
  for (; i < n; ++i) total = fma_rn(sx[i], sy[i], total);
  return total;
}

// Values base .. base + len - 1 of x and y into sx, sy (len a multiple of
// 32), by the whole block, 16 bytes a load where `vec`; past n, x = -0 and
// y = +0, whose fused step fma(-0, +0, acc) leaves every acc as it is.
__device__ __forceinline__ void stage_pair(const float* __restrict__ x, const float* __restrict__ y, int n,
                                           int base, int len, bool vec, float* sx, float* sy) {
  const int tid = threadIdx.x;
  const int whole4 = vec ? max(0, min(len, n - base)) / 4 * 4 : 0;
  for (int i = 4 * tid; i < whole4; i += 4 * kFusedThreads) {
    *reinterpret_cast<float4*>(sx + i) = __ldg(reinterpret_cast<const float4*>(x + base + i));
    *reinterpret_cast<float4*>(sy + i) = __ldg(reinterpret_cast<const float4*>(y + base + i));
  }
  for (int i = whole4 + tid; i < len; i += kFusedThreads) {
    sx[i] = base + i < n ? __ldg(x + base + i) : -0.0f;
    sy[i] = base + i < n ? __ldg(y + base + i) : 0.0f;
  }
}

__global__ void __launch_bounds__(kFusedThreads)
    fused_dot_batch_kernel(Pairs<float> pairs, float* __restrict__ out, int n, int chain_max,
                           int unrolled_max, int flags) {
  __shared__ __align__(16) float sx[kFusedTile];
  __shared__ __align__(16) float sy[kFusedTile];
  __shared__ float lanes[32];
  const float* __restrict__ x = pairs.x[blockIdx.x];
  const float* __restrict__ y = pairs.y[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int used = (n + 31) / 32 * 32;
  const bool rows = flags & kRows;
  const int stride = rows ? rows_dot_lanes(n) : 32;  // the lane chains of a vectorized loop
  const bool vector = rows ? stride > 0 : n > chain_max;
  const bool unrolled = !rows && vector && n <= unrolled_max;
  const bool lanes_order = vector && !unrolled;
  const int whole = lanes_order ? n / stride * stride : 0;  // the elements of the lane chains
  const auto fma_step = [](float c, float a, float b) { return fma_rn(a, b, c); };
  float acc = lanes_order && lane != 0 ? -0.0f : 0.0f;
  int base = 0;
  // One tile at a time (one for every dot that fused_dot gives it): the
  // whole block stages it, then thread 0 runs the chain from shared memory
  // (a group of 32 values of each vector ahead in registers, so that each
  // step waits only on the one before it), or each of the first `stride`
  // lanes of warp 0 its lane chain, eight steps' values loaded before their
  // steps.
  for (;; base += kFusedTile) {
    const int len = min(kFusedTile, used - base);
    stage_pair(x, y, n, base, max(len, 0), vec, sx, sy);
    __syncthreads();
    if (unrolled) {
      if (tid == 0) acc = unrolled_lanes(sx, sy, n, flags & kPairsAt6, flags & kUnrolledTies);
    } else if (!lanes_order) {
      if (tid == 0 && len > 0) acc = chain<32, 2>(sx, sy, len, acc, fma_step);
    } else if (tid < stride) {
      const int end = min(len, whole - base);
      int i = lane;
      for (; i + 7 * stride < end; i += 8 * stride) {
        float a[8], b[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          a[q] = sx[i + stride * q];
          b[q] = sy[i + stride * q];
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) acc = fma_rn(a[q], b[q], acc);
      }
      for (; i < end; i += stride) acc = fma_rn(sx[i], sy[i], acc);
    }
    if (base + kFusedTile >= used) break;
    __syncthreads();  // the tile's readers are done before the next staging
  }
  if ((flags & kVector) && n == 1) {  // a dot of one value is its product
    if (tid == 0) out[blockIdx.x] = mul_rn(sx[0], sy[0]);
    return;
  }
  if (!lanes_order) {
    if (tid == 0) out[blockIdx.x] = acc;
    return;
  }
  if (tid >= 32) return;
  lanes[lane] = acc;
  __syncwarp();
  if (lane != 0) return;
  float v[8];
  float total;
  if (rows) {  // the lanes folded in halves, then the scalar rest
    for (int j = 0; j < stride; ++j) v[j] = lanes[j];
    total = fold_lanes(v, stride);
  } else {
    for (int j = 0; j < 8; ++j) {
      v[j] = add_rn(lanes[8 + j], lanes[j]);
      v[j] = add_rn(lanes[16 + j], v[j]);
      v[j] = add_rn(lanes[24 + j], v[j]);
    }
    total = fold_lanes(v, 8);
  }
  // The rest, from the last tile (tiles are whole groups of 32, so it holds
  // elements whole .. n - 1).
  int i = whole;
  const int width = rows ? 0 : epilogue_width(n - whole, flags & kWideTies);
  if (width > 0) {
    float e[8];
    for (int j = 0; j < width; ++j) e[j] = j == 0 ? total : -0.0f;
    for (; n - i >= width; i += width) {
      for (int j = 0; j < width; ++j) e[j] = fma_rn(sx[i - base + j], sy[i - base + j], e[j]);
    }
    total = fold_lanes(e, width);
  }
  for (; i < n; ++i) total = fma_rn(sx[i - base], sy[i - base], total);
  out[blockIdx.x] = total;
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

int fused_dot_batch(const void* const* xs, const void* const* ys, void* out, int count, int n, int chain_max,
                    int unrolled_max, int flags, void* stream) {
  if (count < 1 || count > kMaxPairs || n < 0 || chain_max < 1 || unrolled_max < chain_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pairs<float> pairs{};
  for (int k = 0; k < count; ++k) {
    pairs.x[k] = static_cast<const float*>(xs[k]);
    pairs.y[k] = static_cast<const float*>(ys[k]);
  }
  fused_dot_batch_kernel<<<count, kFusedThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pairs, static_cast<float*>(out), n, chain_max, unrolled_max, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_dot_batch_f32(const void* const* xs, const void* const* ys, void* out, int count, int n,
                                   int chain_max, int unrolled_max, int flags, void* stream) {
  return fused_dot_batch(xs, ys, out, count, n, chain_max, unrolled_max, flags, stream);
}

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
