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
// from +0 (an f32 (32, 4) window with no lead pad: across lanes of rows,
// as XLA's vectorized loop adds it, window_lanes), and the window sums are
// the next round's input.  Rounds repeat until no axis is longer than 32;
// what is left is added in row-major order.  A vector is one row.  A product (v*v or v*w) is rounded before
// its add.  Where no round is taken, XLA fuses each product into its add:
// a chain of fused multiply-adds.  Each chain starts from +0, which no
// +0 or -0 can turn into -0, so the pad's zeros change no bit and -0
// inputs behave as in the plain a + x chain.
//
// Bound on this card: bytes.  A sum must read its input once, 808 KB for
// the 1-D norm at gen 1.0x (201,920 values), or 0.24 us at 3.35 TB/s
// (f64: 1.6 MB, 0.48 us).  Its real limit is latency: the loads, the
// chains of dependent adds (a 2-D window is 1,024 of them), the ticket and
// the L2 round trips of the rounds after it.
//
// Design.  The grid runs the first stage over the whole card.  A vector
// round whose next round is a vector too (or the final chain) is folded
// into it: the warp that makes window j of round r + 1 makes the 32 windows
// of round r that it adds, round r's windows 32 j - lead(r + 1) on, a
// window off either end being a pad window (all pad zeros, so its sum is
// the +0 of round r + 1's pad).  Its lanes load value `lane` of each of the
// 32 windows (coalesced), the warp writes them into its tile in shared
// memory swizzled (a window's 16-byte chunk q at chunk q ^ (window & 7), so
// that 8 lanes reading 16 bytes of 8 windows hit 8 different bank groups),
// each lane adds one window in order from +0 (8 or 16 loads of 16 bytes,
// then 32 adds), and lane 0 adds the 32 window sums in order through
// fp.cuh's chain.  A 2-D round takes a warp per window (at gen 1.0x 32 x
// 32 values): its lanes stage the window in the tile, and lane 0 adds it
// in row-major order through fp.cuh's chain (16 bytes per load, the next
// group's loads between the current group's adds).  Blocks have 1 to 8
// warps (1 to 4 in f64): for a vector's folds as few as give every SM a
// block (gen 1.0x's 1-D norm: 198 blocks of one warp, each making one of
// round 2's 198 sums), for 2-D windows as many as spread the blocks over
// the SMs once (the 2-D norm: 100 blocks of two warps), which leaves the
// last block a warp for each of round 2's two windows.  The stage's sums go
// to a scratch buffer; the last block to finish takes the ticket
// (__threadfence, then atomicAdd), runs the later stages with its warps in
// the same way (two vector rounds folded at a time, the last into the
// final chain; a 2-D last round's sums into shared memory), adds what is
// left through the chain (a 2-D order's last (k, 4) block across the
// lanes of rows that XLA's vectorized loop takes for some k, thread 0
// emulating them), takes the f32 root in f64 if asked, writes the
// result and resets the ticket.  At gen 1.0x the 1-D norm's last block
// folds round 3 into the final chain, and the 2-D norm's runs round 2:
// one L2 round trip after the ticket either way.  Where the grid's stage is
// the whole sum (at most one vector round, or none), one block writes the
// result and no ticket is taken.  The order of every add is fixed
// whichever block comes last, so the result is deterministic.  The ticket
// and the scratch belong to one stream (the wrapper keeps one of each per
// stream).

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kWindow = 32;
constexpr int kTileValues = kWindow * kWindow;  // a warp's tile in shared memory
constexpr int kMaxRounds = 8;  // ops/reduce.py:_MAX_ROUNDS

// At most 8 warps per block in f32, 4 in f64: a tile each and one for the
// final chain, 36 or 40 KB in all.
template <class T>
constexpr int kMaxWarps = 32 / static_cast<int>(sizeof(T));
// A chain's group: 16 bytes' loads of 128 bytes.
template <class T>
constexpr int kGroup = 128 / static_cast<int>(sizeof(T));

enum Mode { kSum = 0, kSquare = 1, kProduct = 2 };

// One round of the plan: its input shape (row-major), its windows per
// axis (its output shape), a window's extent per axis and the lead pads.
struct Round {
  int rows, cols, win_rows, win_cols, wa, wb, la, lb;
};

struct Plan {
  int num_rounds;
  int final_count;  // the values left after the rounds
  // The last block's lanes (1: added in row-major order) and columns: a
  // 2-D order's last (k, 4) block, which XLA's CPU loop adds across
  // lanes of rows for some k (ops/reduce.py:last_block_lanes).
  int final_lanes, final_cols;
  Round round[kMaxRounds];
};

__host__ __device__ __forceinline__ bool is_vector(const Round& r) { return r.rows == 1 || r.cols == 1; }

// Value i of the input: v, or v*w rounded (w is v for a square).  Both
// loads are issued whatever the mode, so that no branch stands between a
// lane's loads.
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

// Value i of a later stage's input: sums written by this launch, read
// through L2 (not the non-coherent read-only path).
template <class T>
struct Partials {
  const T* p;
  __device__ T operator()(int i) const { return __ldcg(p + i); }
};

template <class T>
struct ToScratch {
  T* dst;
  __device__ void operator()(int j, T acc) const { dst[j] = acc; }
};

template <class T>
struct ToOut {
  T* out;
  int root;
  __device__ void operator()(int, T acc) const { *out = root ? root_rn(acc) : acc; }
};

// acc + a, rounded: the step of an add chain.
struct AddStep {
  template <class T>
  __device__ __forceinline__ T operator()(T acc, T a) const {
    return add_rn(acc, a);
  }
};

// Where value e of window `row` of a fold's tile lies: chunk e / kV of the
// row at chunk (e / kV) ^ (row & 7).
template <class T>
__device__ __forceinline__ int swizzled(int row, int e) {
  constexpr int kV = Vec16<T>::kWidth;
  return row * kWindow + (((e / kV) ^ (row & 7)) * kV) + e % kV;
}

// Sums j = warp, warp + warps, ... of round B (m_b windows of 32 after
// lead_b zeros) over the vector input of round A (n values, windows of 32
// after lead_a zeros), each the 32 window sums of A that it adds, added
// in order; store(j, sum).  A lane's 32 loads go to registers first and to
// the tile after, so that all of them are in flight at once: each load is
// unconditional, at an index clamped into the input, and a select drops
// the pad's values (a load under a branch makes the lane wait for it
// before the next one).
template <class T, class Load, class Store>
__device__ void fold_round(Load load, int n, int lead_a, int m_b, int lead_b, Store store, T* tile,
                           int warp, int warps, int lane) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kWidth;
  for (int j = warp; j < m_b; j += warps) {
    const int first = kWindow * j - lead_b;  // round A's window of lane 0's sum
    T val[kWindow];
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      const int i = (first + k) * kWindow + lane - lead_a;  // window first+k, value `lane`
      const bool in = i >= 0 && i < n;
      const T value = load(in ? i : 0);
      val[k] = in ? value : T(0);
    }
#pragma unroll
    for (int k = 0; k < kWindow; ++k) tile[swizzled<T>(k, lane)] = val[k];
    __syncwarp();
    const V* row = reinterpret_cast<const V*>(tile + lane * kWindow);
    V chunk[kWindow / kV];
#pragma unroll
    for (int q = 0; q < kWindow / kV; ++q) load16(chunk[q], row + (q ^ (lane & 7)));
    T s = T(0);
#pragma unroll
    for (int e = 0; e < kWindow; ++e) s = add_rn(s, vec_at(chunk[e / kV], e % kV));
    // The 32 window sums, in order, by lane 0 from the tile's first row.
    __syncwarp();
    tile[lane] = s;
    __syncwarp();
    if (lane == 0) store(j, chain<kGroup<T>, 1>(tile, tile, kWindow, T(0), AddStep{}));
    __syncwarp();
  }
}

// A lane's values of one 2-D window into the warp's tile: value e = lane +
// 32 k of the window, for k < size / 32, is row row0 + a, column col0 + b
// of the input, where a and b step by 32 / wb rows and 32 % wb columns
// from one k to the next (a full window, 32 x 32, has a = k, b = lane).
// The loads go to registers first, as in fold_round.  Only a window that
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

// XLA's loop over a (32, 4) window of an f32 round over (rows, 4) rows
// with no lead pad (rows = 0 or 31 mod 32): LLVM vectorizes it over the
// window's rows, `lanes` lanes over the first `in_lanes` rows (8 over 32
// for no pad, 4 over 28 for a pad of 1), lane j from +0 (the others from
// -0) adding the 4 values of rows j, j + lanes, ... in order; the lanes
// fold in halves, then the window's other real rows add in row-major
// order (ops/reduce.py:window_lanes).  0 lanes: the row-major chain.
__device__ __forceinline__ int window_lanes(const Round& r, bool f32, int& in_lanes) {
  const int pad = r.win_rows * kWindow - r.rows;
  if (!f32 || r.cols != 4 || r.wa != kWindow || r.wb != 4 || r.la != 0 || pad > 1) return 0;
  in_lanes = pad == 0 ? 32 : 28;
  return pad == 0 ? 8 : 4;
}

template <class T>
__device__ T lanes_window(const T* tile, int lanes, int in_lanes, int real_rows) {
  constexpr int kMaxLanes = 8;
  T acc[kMaxLanes];
  for (int j = 0; j < kMaxLanes; ++j) acc[j] = j == 0 ? T(0) : -T(0);
  for (int i = 0; i < in_lanes; i += lanes) {
    for (int j = 0; j < lanes; ++j) {
      for (int c = 0; c < 4; ++c) acc[j] = add_rn(acc[j], tile[(i + j) * 4 + c]);
    }
  }
  for (int h = lanes / 2; h >= 1; h /= 2) {
    for (int j = 0; j < h; ++j) acc[j] = add_rn(acc[j], acc[j + h]);
  }
  T sum = acc[0];
  for (int e = in_lanes * 4; e < real_rows * 4; ++e) sum = add_rn(sum, tile[e]);
  return sum;
}

// 2-D windows: warp `warp` of `warps` takes windows warp, warp + warps, ...
// (row-major over the windows); lane 0 adds each in row-major order, or
// across lanes as window_lanes says.  A round with an axis longer than 32
// has windows of 32 along it, so a window holds 32 * k values (k <= 32),
// whole groups of the chain.
template <class T, class Load>
__device__ void tile_round(Load load, const Round& r, T* dst, T* tile, int warp, int warps,
                           int lane) {
  const int count = r.win_rows * r.win_cols;
  const int size = r.wa * r.wb;
  int in_lanes = 0;
  const int lanes = window_lanes(r, sizeof(T) == sizeof(float), in_lanes);
  for (int w = warp; w < count; w += warps) {
    const int row0 = (w / r.win_cols) * r.wa - r.la;
    const int col0 = (w % r.win_cols) * r.wb - r.lb;
    if (lanes > 0) {
      stage_window<false>(load, r, row0, col0, size, lane, tile);
      __syncwarp();
      if (lane == 0) dst[w] = lanes_window(tile, lanes, in_lanes, min(kWindow, r.rows - row0));
      __syncwarp();
      continue;
    }
    // A full window's length is a constant, which the compiler schedules
    // better.
    if (size == kTileValues) {
      stage_window<true>(load, r, row0, col0, size, lane, tile);
      __syncwarp();
      if (lane == 0) dst[w] = chain<kGroup<T>, 1>(tile, tile, kTileValues, T(0), AddStep{});
    } else {
      stage_window<false>(load, r, row0, col0, size, lane, tile);
      __syncwarp();
      if (lane == 0) dst[w] = chain<kGroup<T>, 1>(tile, tile, size, T(0), AddStep{});
    }
    __syncwarp();
  }
}

// The chain over the last `count` (<= 1,024) values, in order, by thread
// 0, from `left` in shared memory, padded here to whole groups with -0,
// which leaves any sum as it is.  `fused` (no round taken, a square or a
// product): the values are pairs, left[i] * right[i] added by one fused
// multiply-add in f32 (the rounded product, then the add, in f64:
// mul_add), the pad -0 * +0.
// The last block of `count` values in `cols` columns, added across
// `lanes` lanes by thread 0 as XLA's vector loop adds it: lane j, from +0
// (the others from -0, which changes no sum), adds the values of rows j,
// j + lanes, ... in order; the lanes fold in halves (l[i] + l[i + h]); the
// rows past the last whole group of lanes add in row-major order.
template <class T>
__device__ void final_lanes(const T* left, int count, int lanes, int cols, ToOut<T> store) {
  if (threadIdx.x != 0) return;
  constexpr int kMaxLanes = 8;
  T acc[kMaxLanes];
  for (int j = 0; j < kMaxLanes; ++j) acc[j] = j == 0 ? T(0) : -T(0);
  const int rows = count / cols;
  const int whole = rows / lanes * lanes;
  for (int i = 0; i < whole; i += lanes) {
    for (int j = 0; j < lanes; ++j) {
      for (int c = 0; c < cols; ++c) acc[j] = add_rn(acc[j], left[(i + j) * cols + c]);
    }
  }
  for (int h = lanes / 2; h >= 1; h /= 2) {
    for (int j = 0; j < h; ++j) acc[j] = add_rn(acc[j], acc[j + h]);
  }
  T sum = acc[0];
  for (int i = whole * cols; i < count; ++i) sum = add_rn(sum, left[i]);
  store(0, sum);
}

template <class T>
__device__ void final_chain(T* left, T* right, int count, bool fused, ToOut<T> store) {
  const int padded = (count + kGroup<T> - 1) / kGroup<T> * kGroup<T>;
  for (int i = count + threadIdx.x; i < padded; i += blockDim.x) {
    left[i] = -T(0);
    if (fused) right[i] = T(0);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const T acc = fused ? chain<kGroup<T>, 2>(left, right, padded, T(0),
                                              [](T c, T a, T b) { return mul_add(a, b, c); })
                        : chain<kGroup<T>, 1>(left, left, padded, T(0), AddStep{});
    store(0, acc);
  }
}

template <class T>
__global__ void __launch_bounds__(32 * kMaxWarps<T>)
    tree_sum_kernel(const T* __restrict__ v, const T* __restrict__ w, int mode, Plan plan,
                    T* scratch, int second, unsigned* ticket, T* __restrict__ out, int root) {
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  T* tiles = reinterpret_cast<T*>(shared_bytes);
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  T* tile = tiles + warp * kTileValues;
  const Input<T> input{v, w, mode};
  const ToOut<T> to_out{out, root};
  const int k = plan.num_rounds;
  if (k == 0) {  // one block: the chain over the input
    const bool fused = mode != kSum;
    for (int i = threadIdx.x; i < plan.final_count; i += blockDim.x) {
      tiles[i] = __ldg(v + i);
      if (fused) tiles[kTileValues + i] = __ldg((mode == kSquare ? v : w) + i);
    }
    final_chain(tiles, tiles + kTileValues, plan.final_count, fused, to_out);
    return;
  }
  // The grid's stage: rounds 1 and 2 folded, round 1 folded into the final
  // chain, or a 2-D round 1.  `next` is the first round left.
  const Round r1 = plan.round[0];
  int next = 1;
  if (is_vector(r1)) {
    const int n = r1.rows * r1.cols;
    if (k == 1) {  // one block: the whole sum
      fold_round(input, n, r1.la + r1.lb, 1, 0, to_out, tile, warp, warps, lane);
      return;
    }
    const Round r2 = plan.round[1];
    fold_round(input, n, r1.la + r1.lb, r2.win_rows * r2.win_cols, r2.la + r2.lb,
               ToScratch<T>{scratch}, tile, blockIdx.x * warps + warp, gridDim.x * warps, lane);
    next = 2;
  } else {
    tile_round(input, r1, scratch, tile, blockIdx.x * warps + warp, gridDim.x * warps, lane);
  }
  __threadfence();  // this block's sums, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  T* src = scratch;
  T* dst = scratch + second;
  // What the final chain adds, in shared memory past the warps' tiles: a
  // 2-D last round writes its sums there.
  T* left = tiles + warps * kTileValues;
  bool done = false, in_left = false;
  while (next < k) {
    // A copy in registers: reading the round's fields at a run-time index
    // of the kernel's parameters, as each use would, is slow.
    const Round ra = plan.round[next];
    if (!is_vector(ra)) {
      in_left = next + 1 == k;
      tile_round(Partials<T>{src}, ra, in_left ? left : dst, tile, warp, warps, lane);
      next += 1;
    } else if (next + 1 < k) {
      const Round rb = plan.round[next + 1];
      fold_round(Partials<T>{src}, ra.rows * ra.cols, ra.la + ra.lb, rb.win_rows * rb.win_cols,
                 rb.la + rb.lb, ToScratch<T>{dst}, tile, warp, warps, lane);
      next += 2;
    } else {
      fold_round(Partials<T>{src}, ra.rows * ra.cols, ra.la + ra.lb, 1, 0, to_out, tile, warp, warps,
                 lane);
      next += 1;
      done = true;
    }
    __syncthreads();  // the stage's sums, before the next stage reads them
    T* t = src;
    src = dst;
    dst = t;
  }
  if (!done) {
    for (int i = threadIdx.x; i < plan.final_count && !in_left; i += blockDim.x) left[i] = __ldcg(src + i);
    if (plan.final_lanes > 1) {
      __syncthreads();
      final_lanes(left, plan.final_count, plan.final_lanes, plan.final_cols, to_out);
    } else {
      final_chain(left, left, plan.final_count, false, to_out);
    }
  }
  if (threadIdx.x == 0) {
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

int multiprocessors() {
  static int count = 0;
  if (count == 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    count = sms > 0 ? sms : 1;
  }
  return count;
}

// plan: host ints {num_rounds, final_count, then per round rows, cols,
// win_rows, win_cols, wa, wb, la, lb, then final_lanes, final_cols}; scratch holds the grid's sums from 0
// and the next stage's from `second`, later stages alternating between the
// two (ops/reduce.py:k6_plan sizes it).
template <class T>
int tree_sum(const void* v, const void* w, int mode, const void* plan_host, void* scratch,
             int second, void* ticket, void* out, int root, void* stream) {
  const int* p = static_cast<const int*>(plan_host);
  Plan plan;
  plan.num_rounds = p[0];
  plan.final_count = p[1];
  if (plan.num_rounds < 0 || plan.num_rounds > kMaxRounds || plan.final_count > kTileValues) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < plan.num_rounds; ++k) {
    const int* q = p + 2 + 8 * k;
    plan.round[k] = Round{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
  }
  plan.final_lanes = p[2 + 8 * plan.num_rounds];
  plan.final_cols = p[3 + 8 * plan.num_rounds];
  if (plan.final_lanes > 1 && (plan.final_lanes > 8 || (plan.final_lanes & (plan.final_lanes - 1)) != 0 ||
                               plan.final_cols < 1 || plan.final_count % plan.final_cols != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The grid's warps of work: round 2's windows (rounds 1 and 2 folded),
  // round 1's (2-D), or one.  Warps per block: as few as give every SM a
  // block of a vector's folds (each warp's loads fill its SM's memory
  // pipe well enough); for 2-D windows, as many as spread the blocks over
  // the SMs once (two warps of chains run side by side on one SM as fast
  // as on two), which leaves the last block warps for a 2-D round 2's
  // windows.
  int work = 1;
  bool vector_work = true;
  if (plan.num_rounds > 0) {
    const Round& r = plan.round[0];
    if (!is_vector(r)) {
      work = r.win_rows * r.win_cols;
      vector_work = false;
    } else if (plan.num_rounds > 1) {
      work = plan.round[1].win_rows * plan.round[1].win_cols;
    }
  }
  const int sms = multiprocessors();
  const int wanted = vector_work ? work / sms : (work + sms - 1) / sms;
  const int warps = max(1, min(kMaxWarps<T>, wanted));
  const int blocks = (work + warps - 1) / warps;
  // A tile per warp and one for the final chain's values.
  const size_t shared = static_cast<size_t>(warps + 1) * kTileValues * sizeof(T);
  tree_sum_kernel<T><<<blocks, 32 * warps, shared, static_cast<cudaStream_t>(stream)>>>(
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
