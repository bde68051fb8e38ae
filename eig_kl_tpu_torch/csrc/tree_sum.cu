// K6: the sum of a float32 or float64 vector or row-major matrix in XLA's
// CPU order, in one launch (tree_sum_f32, tree_sum_f64); and three
// element-wise entry points of the power solve: the step's scale by the
// norm (scale_by_f32/_f64), the padded step x - c * (2 x - 2 ax / deg) of a
// v3 plan's (P/128, 128) state (padded_step_f32: a v3 plan is f32 only, as
// the JAX package's is), and a * x + y (axpy_f32/_f64, the momentum exit's
// deflation).  In f32 the last two are fused multiply-adds where XLA's CPU
// fusion contracts a product into the add that takes it
// (eig_kl_tpu/spectral/power.py:184, :309-310; ROADMAP.md C7); in f64
// every product is rounded before its add, as the plain versions' f64
// branches do (csrc/fp.cuh: mul_add), and the root is the f64 root.
//
// It replaces no Pallas kernel.  The JAX package leaves its norms and sums
// to XLA: the power step's jnp.linalg.norm (eig_kl_tpu/spectral/power.py:185)
// and cut_size's degree sum (eig_kl_tpu/ops/partition.py:88).  XLA's CPU
// backend adds them in a tree order, which the port reproduces so that its
// f32 iterate equals the JAX package's bit for bit.  The plain versions are
// ops/reduce.py:tree_sum_plain and tree_sum_2d_plain, which run the order
// as about 100 element-wise launches per 1-D sum and 1,150 per 2-D one.
//
// The order (ops/reduce.py:reduce_rounds, which the host turns into the
// plan this kernel reads): each axis longer than 32 is cut into windows of
// 32 after a centred zero pad (the smaller half in front), an axis of at
// most 32 is one window.  Each window adds its values in row-major order
// from +0, and the window sums are the next round's input.  Rounds repeat
// until no axis is longer than 32; what is left is added in row-major
// order.  A vector is one row.  A product (v*v or v*w) is rounded before
// its add.  Where no round is taken, XLA fuses each product into its add:
// a chain of fused multiply-adds.  Each chain starts from +0, which no
// +0 or -0 can turn into -0, so the pad's zeros change no bit and -0
// inputs behave as in the plain a + x chain.
//
// Bound on this card: bytes.  A sum must read its input once, 808 KB for
// the 1-D norm at gen 1.0x (201,920 values), or 0.24 us at 3.35 TB/s
// (f64: 1.6 MB, 0.48 us).  Its
// real limit is latency: round 1's loads, the ticket, then each later
// round's loads and chain in the last block (a 2-D window's chain is 1,024
// dependent adds).
//
// Design: round 1 runs over the whole grid.  For windows of 32 values
// (a vector), a warp loads 32 windows coalesced into a padded tile in
// shared memory, and each lane adds one window from there.  For 2-D
// windows (32 x 32 at gen 1.0x), a warp loads one window and lane 0 adds
// it.  The window sums go to a scratch buffer.  The last block to finish
// takes the ticket (__threadfence, then atomicAdd), runs the later rounds
// with its own warps in the same way, adds what is left, takes the f32
// root in f64 if asked, writes the result and resets the ticket.  The
// order of every add is fixed whichever block comes last, so the result is
// deterministic.  The ticket belongs to one stream (the wrapper keeps one
// per stream), and the scratch is allocated per call.  An f64 block has 4
// warps instead of 8, so that its tiles (33.8 KB) fit the 48 KB of static
// shared memory as f32's 8 do.

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kWindow = 32;
constexpr int kTileStride = kWindow + 1;  // a padded tile row: no bank conflicts
constexpr int kTile = kWindow * kTileStride;
constexpr int kMaxRounds = 8;  // ops/reduce.py:_MAX_ROUNDS

// Warps per block of the sum: 8 in f32, 4 in f64 (the same tile bytes).
template <class T>
constexpr int kWarps = 32 / static_cast<int>(sizeof(T));
template <class T>
constexpr int kThreads = 32 * kWarps<T>;

enum Mode { kSum = 0, kSquare = 1, kProduct = 2 };

// One round of the plan: its input shape (row-major), its windows per
// axis (its output shape), a window's extent per axis and the lead pads.
struct Round {
  int rows, cols, win_rows, win_cols, wa, wb, la, lb;
};

struct Plan {
  int num_rounds;
  int final_count;  // the values left after the rounds
  Round round[kMaxRounds];
};

// Value i of round 1's input: v, or v*w rounded (w is v for a square).
// Both loads are issued whatever the mode, so that no branch stands
// between a lane's loads.
template <class T>
struct Input {
  const T* __restrict__ v;
  const T* __restrict__ w;
  int mode;
  __device__ T operator()(int i) const {
    const T a = __ldg(v + i);
    const T b = __ldg(w + i);
    return mode == kSum ? a : mul_rn(a, b);
  }
};

// Value i of a later round's input: partial sums written by this launch,
// read through L2 (not the non-coherent read-only path).
template <class T>
struct Partials {
  const T* p;
  __device__ T operator()(int i) const { return __ldcg(p + i); }
};

// Windows of 32 consecutive values of n, after `lead` zeros: warp `warp` of
// `warps` takes the groups of 32 windows first, first + 32 * warps, ...
// A lane's 32 loads go to registers first and to the tile after, so that
// all of them are in flight at once: each load is unconditional, at an
// index clamped into the input, and a select drops the pad's values (a
// load under a branch makes the lane wait for it before the next one).
template <class T, class Load>
__device__ void vector_round(Load load, int n, int m, int lead, T* dst, T* tile, int warp,
                             int warps, int lane) {
  for (int first = warp * kWindow; first < m; first += warps * kWindow) {
    T val[kWindow];
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      const int i = (first + k) * kWindow + lane - lead;  // window first+k, value `lane`
      const bool in = i >= 0 && i < n;
      const T value = load(in ? i : 0);
      val[k] = in ? value : T(0);
    }
#pragma unroll
    for (int k = 0; k < kWindow; ++k) tile[k * kTileStride + lane] = val[k];
    __syncwarp();
    if (first + lane < m) {
      T acc = T(0);
#pragma unroll
      for (int e = 0; e < kWindow; ++e) acc = add_rn(acc, tile[lane * kTileStride + e]);
      dst[first + lane] = acc;
    }
    __syncwarp();
  }
}

// A lane's values of one 2-D window into the warp's tile: value e = lane +
// 32 k of the window, for k < size / 32, is row row0 + a, column col0 + b
// of the input, where a and b step by 32 / wb rows and 32 % wb columns
// from one k to the next (a full window, 32 x 32, has a = k, b = lane).
// The loads go to registers first, as in vector_round.  Only a window that
// is not full stops early: the stop is a branch, which keeps the next
// loads from being issued before this one's select.
template <bool kFull, class T, class Load>
__device__ __forceinline__ void stage_window(Load load, const Round& r, int row0, int col0,
                                             int size, int lane, T* tile) {
  const int wb = kFull ? kWindow : max(r.wb, 1);  // a window of 0 columns has no value
  int a = kFull ? 0 : lane / wb;
  int b = kFull ? lane : lane % wb;
  T val[kWindow];
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    if (!kFull && 32 * k >= size) break;  // the same for every lane
    const bool in = row0 + a >= 0 && row0 + a < r.rows && col0 + b >= 0 && col0 + b < r.cols;
    const T value = load(in ? (row0 + a) * r.cols + col0 + b : 0);
    val[k] = in ? value : T(0);
    a += kWindow / wb;
    b += kWindow % wb;
    if (b >= wb) {
      b -= wb;
      ++a;
    }
  }
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    if (!kFull && 32 * k >= size) break;
    tile[lane + 32 * k] = val[k];
  }
}

// 2-D windows: warp `warp` of `warps` takes windows warp, warp + warps, ...
// (row-major over the windows); lane 0 adds each in row-major order.  A
// round with an axis longer than 32 has windows of 32 along it, so a
// window holds 32 * k values (k <= 32): lane 0 reads them 16 bytes at a
// time.
template <class T, class Load>
__device__ void tile_round(Load load, const Round& r, T* dst, T* tile, int warp, int warps,
                           int lane) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kWidth;
  const int count = r.win_rows * r.win_cols;
  const int size = r.wa * r.wb;
  for (int w = warp; w < count; w += warps) {
    const int row0 = (w / r.win_cols) * r.wa - r.la;
    const int col0 = (w % r.win_cols) * r.wb - r.lb;
    if (size == kWindow * kWindow) {
      stage_window<true>(load, r, row0, col0, size, lane, tile);
    } else {
      stage_window<false>(load, r, row0, col0, size, lane, tile);
    }
    __syncwarp();
    if (lane == 0) {
      const V* vec = reinterpret_cast<const V*>(tile);
      T acc = T(0);
#pragma unroll 8
      for (int e = 0; e < size / kV; ++e) {
        const V q = vec[e];
#pragma unroll
        for (int c = 0; c < kV; ++c) acc = add_rn(acc, vec_at(q, c));
      }
      dst[w] = acc;
    }
    __syncwarp();
  }
}

template <class T, class Load>
__device__ void run_round(Load load, const Round& r, T* dst, T* tile, int warp, int warps,
                          int lane) {
  if (r.rows == 1 || r.cols == 1) {
    vector_round(load, r.rows * r.cols, r.win_rows * r.win_cols, r.la + r.lb, dst, tile,
                 warp, warps, lane);
  } else {
    tile_round(load, r, dst, tile, warp, warps, lane);
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads<T>)
    tree_sum_kernel(const T* __restrict__ v, const T* __restrict__ w, int mode, Plan plan,
                    T* scratch, int second, unsigned* ticket, T* __restrict__ out, int root) {
  constexpr int kW = kWarps<T>;
  __shared__ __align__(16) T tiles[kW * kTile];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* tile = tiles + warp * kTile;
  const Input<T> input{v, w, mode};
  if (plan.num_rounds > 0) {
    run_round(input, plan.round[0], scratch, tile, blockIdx.x * kW + warp, gridDim.x * kW,
              lane);
    __threadfence();  // this block's window sums, before its ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  T* src = scratch;
  T* dst = scratch + second;
  for (int k = 1; k < plan.num_rounds; ++k) {
    // A copy in registers: reading the round's fields at a run-time index
    // of the kernel's parameters, as each use would, is slow.
    const Round round = plan.round[k];
    run_round(Partials<T>{src}, round, dst, tile, warp, kW, lane);
    __syncthreads();
    T* t = src;
    src = dst;
    dst = t;
  }
  // What is left (at most 32 x 32 values) goes to shared memory at once,
  // then thread 0 adds it in order.
  T* left = tiles;
  T* right = tiles + kWindow * kWindow;
  for (int i = threadIdx.x; i < plan.final_count; i += kThreads<T>) {
    if (plan.num_rounds > 0) {
      left[i] = __ldcg(src + i);
    } else {
      left[i] = __ldg(v + i);
      right[i] = mode == kSum ? T(0) : __ldg((mode == kSquare ? v : w) + i);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = T(0);
    if (plan.num_rounds == 0 && mode != kSum) {
      // No round taken: XLA fuses each product into its add in f32; f64
      // rounds the product first (mul_add).
      for (int i = 0; i < plan.final_count; ++i) acc = mul_add(left[i], right[i], acc);
    } else {
#pragma unroll 8
      for (int i = 0; i < plan.final_count; ++i) acc = add_rn(acc, left[i]);
    }
    *out = root ? root_rn(acc) : acc;
    *ticket = 0u;
  }
}

// x = y / nrm where nrm > 0, else y: the power step's scale.
template <class T>
__global__ void scale_by_kernel(const T* __restrict__ y, const T* __restrict__ nrm,
                                T* __restrict__ x, int n) {
  const T s = __ldg(nrm);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const T yi = y[i];
    x[i] = s > T(0) ? div_rn(yi, s) : yi;
  }
}

// x - inv_shift * (2 x - 2 ax / deg), each operation rounded as the plain
// version's PyTorch sequence does and the last one fused, as
// csrc/spmv_csr.cu's power step does for a CSR row.
__global__ void padded_step_kernel(const float* __restrict__ x, const float* __restrict__ ax,
                                   const float* __restrict__ deg, float inv_shift,
                                   float* __restrict__ y, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float xi = x[i];
    const float lap = __fsub_rn(__fmul_rn(2.0f, xi), __fdiv_rn(__fmul_rn(2.0f, ax[i]), deg[i]));
    y[i] = __fmaf_rn(-inv_shift, lap, xi);
  }
}

// out = a * x + y, one rounding in f32, the rounded product then the add in
// f64; a is one value (a_scalar) or a vector.
template <class T>
__global__ void axpy_kernel(const T* __restrict__ a, int a_scalar, const T* __restrict__ x,
                            const T* __restrict__ y, T* __restrict__ out, int n) {
  const T a0 = __ldg(a);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    out[i] = mul_add(a_scalar ? a0 : a[i], x[i], y[i]);
  }
}

int elementwise_blocks(int n) {
  const int threads = 256;
  return (n + threads - 1) / threads < 1056 ? (n + threads - 1) / threads : 1056;
}

// plan: host ints {num_rounds, final_count, then per round rows, cols,
// win_rows, win_cols, wa, wb, la, lb}; scratch holds round 1's sums from 0
// and round 2's from `second`, later rounds alternating between the two.
template <class T>
int tree_sum(const void* v, const void* w, int mode, const void* plan_host, void* scratch,
             int second, void* ticket, void* out, int root, void* stream) {
  const int* p = static_cast<const int*>(plan_host);
  Plan plan;
  plan.num_rounds = p[0];
  plan.final_count = p[1];
  if (plan.num_rounds < 0 || plan.num_rounds > kMaxRounds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < plan.num_rounds; ++k) {
    const int* q = p + 2 + 8 * k;
    plan.round[k] = Round{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
  }
  int blocks = 1;
  if (plan.num_rounds > 0) {
    const Round& r = plan.round[0];
    const int windows = r.win_rows * r.win_cols;
    const int warps = (r.rows == 1 || r.cols == 1) ? (windows + kWindow - 1) / kWindow : windows;
    blocks = warps > kWarps<T> ? (warps + kWarps<T> - 1) / kWarps<T> : 1;
  }
  tree_sum_kernel<T><<<blocks, kThreads<T>, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(w), mode, plan, static_cast<T*>(scratch),
      second, static_cast<unsigned*>(ticket), static_cast<T*>(out), root);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int scale_by(const void* y, const void* nrm, void* x, int n, void* stream) {
  if (n > 0) {
    scale_by_kernel<T><<<elementwise_blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(y), static_cast<const T*>(nrm), static_cast<T*>(x), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int axpy(const void* a, int a_scalar, const void* x, const void* y, void* out, int n,
         void* stream) {
  if (n > 0) {
    axpy_kernel<T><<<elementwise_blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), a_scalar, static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tree_sum_f32(const void* v, const void* w, int mode, const void* plan_host,
                            void* scratch, int second, void* ticket, void* out, int root,
                            void* stream) {
  return tree_sum<float>(v, w, mode, plan_host, scratch, second, ticket, out, root, stream);
}

extern "C" int tree_sum_f64(const void* v, const void* w, int mode, const void* plan_host,
                            void* scratch, int second, void* ticket, void* out, int root,
                            void* stream) {
  return tree_sum<double>(v, w, mode, plan_host, scratch, second, ticket, out, root, stream);
}

extern "C" int scale_by_f32(const void* y, const void* nrm, void* x, int n, void* stream) {
  return scale_by<float>(y, nrm, x, n, stream);
}

extern "C" int scale_by_f64(const void* y, const void* nrm, void* x, int n, void* stream) {
  return scale_by<double>(y, nrm, x, n, stream);
}

extern "C" int padded_step_f32(const void* x, const void* ax, const void* deg, float inv_shift,
                               void* y, int n, void* stream) {
  if (n > 0) {
    padded_step_kernel<<<elementwise_blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(ax),
        static_cast<const float*>(deg), inv_shift, static_cast<float*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int axpy_f32(const void* a, int a_scalar, const void* x, const void* y, void* out,
                        int n, void* stream) {
  return axpy<float>(a, a_scalar, x, y, out, n, stream);
}

extern "C" int axpy_f64(const void* a, int a_scalar, const void* x, const void* y, void* out,
                        int n, void* stream) {
  return axpy<double>(a, a_scalar, x, y, out, n, stream);
}

extern "C" const char* tree_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
