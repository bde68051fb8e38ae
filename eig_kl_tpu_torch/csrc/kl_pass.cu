// K2: S independent KL passes in one launch, one persistent thread block
// per start, in float32 (kl_pass_f32) or float64 (kl_pass_f64).
//
// Replaces eig_kl_tpu/kl/megakernel.py:_kernel (:144) in both its forms:
// batched (launched by _run_batched, :602, the pallas_call at :638, a grid
// over the starts) and single-start (launched by _run, :507), which is
// S = 1 of the same kernel here.  Per start: first-max selection per side,
// the two row updates of A@s, the lock, the Kahan-summed cut, the four swap
// logs and the termination rule.  Each start brings its own cut0, best0
// (the best cut of earlier chunks of the same pass), cap and term0 (the
// termination count carried in), so a pass can be re-entered after a
// from-scratch refresh of A@s (megakernel.py:459-468, :1207).  The f64
// instantiation stands for the JAX package's f64 KL engine off the TPU,
// the XLA while-loop pass of eig_kl_tpu/kl/engine.py:206 (refine) and its
// vmap over starts (eig_kl_tpu/parallel/multi_start.py:44): the same
// selection, updates and bookkeeping, in f64.
//
// Bound on this card: latency.  The swap chain is serial (each selection
// reads the state the previous swap wrote), as the TPU kernel's single
// core makes it.  Counted once per call, the bytes the pass must move
// (CSR, sf, a_s, logs) take microseconds at 3.35 TB/s; the chain of some
// ten thousand dependent swaps, each paying L2 and barrier latency, is
// what takes the time.  Starts share nothing but the read-only graph, so
// S blocks run side by side on S of the card's SMs (and queue beyond
// that).
//
// Design:
// * Grid: blockIdx.x is the start.  Blocks never talk to each other (no
//   atomics across blocks, no grid sync), so a start's bits do not depend
//   on S or on the other starts, and S may exceed the number of SMs.  The
//   per-start parameters are read from device arrays, so a batch is
//   launched without the host ever reading a cut.
// * State: sf = side sign * free (0 = locked or padding) and a_s = A@s,
//   both of the pass's type in global memory, one stripe per start.  The node count is
//   padded to a multiple of 128 with sf = 0: row r is nodes 128r..128r+127.
// * Row-max cache (the TPU kernel's hierarchical selection,
//   megakernel.py:265-351): per start and row, rm_l[r] and rm_r[r], the
//   maximum of D = -(sf * a_s) over the row's nodes with sf > 0 and with
//   sf < 0 (-inf if none).  It lives in dynamic shared memory (12.7 KB at
//   gen 1.0x in f32, 25.8 KB in f64; the 227 KB opt-in holds about 3.5M
//   nodes in f32 and 1.8M in f64) or, for larger graphs, in a
//   global-memory stripe per start, through the same pointers; the wrapper chooses from n (and, below K2_CACHE_MIN_NODES,
//   the flat scan, see below).  Beside it: one dirty bit per
//   row and a list of dirty rows.  Each launch fills it from the sf and
//   a_s it is given (one warp per row), so a re-entry needs nothing more.
// * Selection, per swap and side: a block-wide first maximum over the
//   cached rows, "larger, or equal (+0 == -0) at a lower row"; then one
//   warp loads the winning row's 128 nodes and takes the first whose
//   masked D equals that maximum, and reports that node's own D.  This is
//   the flat first maximum over nodes: every node holding the maximum
//   value lies in a row whose cached value equals it, so the first such
//   node lies in the first such row, and is that row's first node with
//   D == max.  The cache is computed with the lane search's expression,
//   and fmax returns one of its arguments, so the equality is exact.  A
//   locked node has sf = 0 and is in no side's maximum, so once its row
//   is refreshed it is never handed out; the loop stops before a side
//   runs out (nf0, nf1), as before.
// * Row updates: row a's entries add -2*s_a*w into a_s in parallel, then a
//   barrier, then row b's (megakernel.py:385-415's order); neighbours in
//   one row are distinct, so no two threads touch one entry.  The thread
//   that meets b in row a records w_ab.  Each thread that updates a_s[j]
//   marks row j >> 7 dirty; the first to set a row's bit appends the row
//   to the list (rows beyond the list's capacity: every flagged row is
//   found by a walk over all rows instead).  Thread 0 marks the rows of
//   a and b after locking them.  After a barrier, one warp per dirty row
//   recomputes both sides' maxima, and the dirty bits are cleared: at
//   most 2 * 43 + 2 rows at gen 1.0x, three rounds of 32 warps.
// * Bookkeeping on thread 0: lock both nodes, gain = m_l + m_r - 2*w_ab,
//   Kahan-compensated cut (megakernel.py:424-431), the four logs written
//   straight to global memory at index it, and the termination counter
//   (gain <= gain_eps counts; stop when it exceeds terminate_limit).
// * Five block barriers per swap: after the row scan, after the lane
//   search, between the two rows, before and after the refresh.
// * Small graphs: the cache's refresh costs one more barrier and one more
//   round trip to L2 per swap, which the flat scan's few float4s per
//   thread do not; below K2_CACHE_MIN_NODES (kl/megakernel.py, the
//   crossover measured on the card) the same kernel, instantiated with
//   kCache = false, scans all nodes per swap: each thread keeps a strict-
//   > first maximum of its nodes in increasing order, and the same
//   (value, index) reductions give the first maximum.
// * Every add and multiply is explicitly rounded (no FMA contraction), so
//   the pass reproduces the plain PyTorch version's bits.
// * The selection helpers (the tie rule, the cache's refresh, the marks and
//   the row updates) are csrc/kl_common.cuh's, which K5 shares.  In f64 a
//   lane's 4 nodes are two 16-byte loads (Hopper has no 32-byte load), the
//   cache's maxima take 8 bytes, and its words per start are rounded up to
//   an even count so that every start's maxima stay 8-byte aligned.

#include <cuda_runtime.h>

#include <climits>

#include "kl_common.cuh"

namespace {

// Words of one start's cache: both sides' maxima per row (T each), a dirty
// bit per row, the list; even in f64 (each start's doubles 8-byte aligned).
template <class T>
__host__ __device__ __forceinline__ size_t cache_words(int rows, int list_cap) {
  const size_t words = 2 * static_cast<size_t>(rows) * (sizeof(T) / 4) + (rows + 31) / 32 + list_cap;
  return sizeof(T) == 8 ? words + (words & 1) : words;
}

// kCache: selection through the row-max cache; else the flat scan.
template <class T, bool kCache>
__global__ void __launch_bounds__(kThreads, 1)
    kl_pass_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                   const T* __restrict__ data, T* sf_all, T* as_all, int rows, int list_cap,
                   unsigned* cache_global, const T* __restrict__ cut0s,
                   const T* __restrict__ best0s, const int* __restrict__ caps,
                   const int* __restrict__ term0s, int terminate_limit, T gain_eps, int log_len,
                   T* __restrict__ log_cut_all, T* __restrict__ log_gain_all,
                   int* __restrict__ log_a_all, int* __restrict__ log_b_all,
                   T* __restrict__ out_all) {
  // This block's start: its state stripe, its cache, its logs, its
  // parameters.
  const size_t start = blockIdx.x;
  const size_t n_pad = static_cast<size_t>(rows) * kRow;
  T* sf = sf_all + start * n_pad;
  T* as = as_all + start * n_pad;
  const int dirty_words = (rows + 31) / 32;
  const size_t value_words = 2 * static_cast<size_t>(rows) * (sizeof(T) / 4);
  extern __shared__ __align__(16) unsigned cache_shared[];
  unsigned* cw = cache_global != nullptr ? cache_global + start * cache_words<T>(rows, list_cap)
                                         : cache_shared;
  const Cache<T> cache{reinterpret_cast<T*>(cw), reinterpret_cast<T*>(cw) + rows,
                       cw + value_words, reinterpret_cast<int*>(cw + value_words + dirty_words)};
  T* log_cut = log_cut_all + start * log_len;
  T* log_gain = log_gain_all + start * log_len;
  int* log_a = log_a_all + start * log_len;
  int* log_b = log_b_all + start * log_len;
  T* out = out_all + start * 8;
  const T cut0 = cut0s[start];
  const int cap = caps[start];

  __shared__ T red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ int cnt[2][kWarps];
  __shared__ int sh_sel[2], sh_go, sh_count;
  __shared__ T sh_m[2], sh_wab;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Free nodes per side at the start (padding has sf = 0), the cache
  // filled, no row dirty.
  int c0 = 0, c1 = 0;
  for (size_t q = tid; q < n_pad / 4; q += kThreads) {
    T f[4];
    load4(sf, q, f);
    c0 += (f[0] > T(0)) + (f[1] > T(0)) + (f[2] > T(0)) + (f[3] > T(0));
    c1 += (f[0] < T(0)) + (f[1] < T(0)) + (f[2] < T(0)) + (f[3] < T(0));
  }
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  if (lane == 0) {
    cnt[0][warp] = c0;
    cnt[1][warp] = c1;
  }
  if constexpr (kCache) {
    for (int r = warp; r < rows; r += kWarps) refresh_row(sf, as, cache, r, lane);
    for (int w = tid; w < dirty_words; w += kThreads) cache.dirty[w] = 0u;
  }
  __syncthreads();

  // The scalar state lives in thread 0's registers.
  int it = 0, term = 0, stop = 0, nf0 = 0, nf1 = 0;
  T cut = cut0, comp = T(0), best = cut0;
  if (tid == 0) {
    best = min_of(cut0, best0s[start]);
    term = term0s[start];
    log_cut[0] = cut0;
    for (int w = 0; w < kWarps; ++w) {
      nf0 += cnt[0][w];
      nf1 += cnt[1][w];
    }
    sh_go = it < cap && nf0 > 0 && nf1 > 0;
  }
  __syncthreads();

  while (sh_go) {
    // Selection, 1: the first row holding each side's maximum (or, flat,
    // the first node).
    if (tid == 0) sh_count = 0;  // every thread read it before the last barrier
    T vl = neg_inf<T>(), vr = neg_inf<T>();
    int il = INT_MAX, ir = INT_MAX;
    if constexpr (kCache) {
      for (int r = tid; r < rows; r += kThreads) {
        const T ml = cache.rm_l[r];
        const T mr = cache.rm_r[r];
        if (ml > vl) {
          vl = ml;
          il = r;
        }
        if (mr > vr) {
          vr = mr;
          ir = r;
        }
      }
    } else {
#pragma unroll 4
      for (int q = tid; q < rows * (kRow / 4); q += kThreads) {
        T f[4], a[4];
        load4(sf, q, f);
        load4(as, q, a);
#pragma unroll
        for (int e = 0; e < 4; ++e) consider(f[e], a[e], 4 * q + e, vl, il, vr, ir);
      }
    }
    warp_argmax(vl, il);
    warp_argmax(vr, ir);
    if (lane == 0) {
      red_v[0][warp] = vl;
      red_i[0][warp] = il;
      red_v[1][warp] = vr;
      red_i[1][warp] = ir;
    }
    __syncthreads();

    // Selection, 2: warp 0 for side 0, warp 1 for side 1; with the cache,
    // the first node of the winning row whose masked D equals the maximum.
    if (warp < 2) {
      T v = red_v[warp][lane];
      int r = red_i[warp][lane];
      warp_argmax(v, r);
      v = __shfl_sync(kFull, v, 0);
      r = __shfl_sync(kFull, r, 0);
      if (r == INT_MAX) __trap();  // no candidate: nf0 and nf1 say otherwise
      if constexpr (!kCache) {
        if (lane == 0) {
          sh_sel[warp] = r;
          sh_m[warp] = v;
          if (warp == 0) sh_wab = T(0);
        }
      } else {
        T fs[4], as4[4];
        load4(sf, static_cast<size_t>(r) * (kRow / 4) + lane, fs);
        load4(as, static_cast<size_t>(r) * (kRow / 4) + lane, as4);
        int first = 4;
        T d_first = T(0);
#pragma unroll
        for (int k = 3; k >= 0; --k) {
          const T d = gain_d(fs[k], as4[k]);
          if ((warp == 0 ? fs[k] > T(0) : fs[k] < T(0)) && d == v) {
            first = k;
            d_first = d;
          }
        }
        const unsigned hit = __ballot_sync(kFull, first < 4);
        if (hit == 0u) __trap();  // the cache disagrees with the row
        const int src = __ffs(hit) - 1;
        const int k = __shfl_sync(kFull, first, src);
        const T d = __shfl_sync(kFull, d_first, src);
        if (lane == 0) {
          sh_sel[warp] = r * kRow + 4 * src + k;
          sh_m[warp] = d;
          if (warp == 0) sh_wab = T(0);
        }
      }
    }
    __syncthreads();

    // Row updates: all of row a, then all of row b.  The chosen nodes are
    // free, so sf holds their signs.
    const int a = sh_sel[0];
    const int b = sh_sel[1];
    const T coef_a = mul_rn(T(-2), sf[a]);
    const T coef_b = mul_rn(T(-2), sf[b]);
    const int n_nodes = rows * kRow;
    update_row<kCache>(indptr, indices, data, as, a, 0, n_nodes, coef_a, b, &sh_wab, cache,
                       list_cap, &sh_count);
    __syncthreads();
    update_row<kCache>(indptr, indices, data, as, b, 0, n_nodes, coef_b, b,
                       static_cast<T*>(nullptr), cache, list_cap, &sh_count);

    if (tid == 0) {
      sf[a] = T(0);
      sf[b] = T(0);
      if constexpr (kCache) {
        mark(cache, a / kRow, list_cap, &sh_count);
        mark(cache, b / kRow, list_cap, &sh_count);
      }
      const T gain = sub_rn(add_rn(sh_m[0], sh_m[1]), mul_rn(T(2), sh_wab));
      const T y = sub_rn(-gain, comp);
      const T t = add_rn(cut, y);
      comp = sub_rn(sub_rn(t, cut), y);
      cut = t;
      best = min_of(cut, best);
      ++it;
      log_cut[it] = cut;
      log_gain[it] = gain;
      log_a[it] = a;
      log_b[it] = b;
      term = gain <= gain_eps ? term + 1 : 0;
      stop = term > terminate_limit;
      --nf0;
      --nf1;
      sh_go = !stop && it < cap && nf0 > 0 && nf1 > 0;
    }
    __syncthreads();
    if constexpr (!kCache) continue;

    // Refresh: one warp per dirty row, both sides.  Every flagged row is
    // in the list (or, past its capacity, found by the walk), so all dirty
    // bits are clear after this phase.
    const int dirty = sh_count;
    if (dirty <= list_cap) {
      for (int k = warp; k < dirty; k += kWarps) {
        const int r = cache.list[k];
        refresh_row(sf, as, cache, r, lane);
        if (lane == 0) cache.dirty[r >> 5] = 0u;  // its word's rows are all listed
      }
    } else {
      for (int r = warp; r < rows; r += kWarps) {
        if (!((cache.dirty[r >> 5] >> (r & 31)) & 1u)) continue;
        refresh_row(sf, as, cache, r, lane);
      }
    }
    __syncthreads();
    if (dirty > list_cap) {
      for (int w = tid; w < dirty_words; w += kThreads) cache.dirty[w] = 0u;
      __syncthreads();
    }
  }

  if (tid == 0) {
    out[0] = cut;
    out[1] = best;
    out[2] = static_cast<T>(it);
    out[3] = static_cast<T>(term);
    out[4] = static_cast<T>(nf0);
    out[5] = static_cast<T>(nf1);
    out[6] = cut0;
    out[7] = static_cast<T>(stop);
  }
}

template <class T>
int kl_pass(const void* indptr, const void* indices, const void* data, void* sf, void* as,
            int n_padded, int use_cache, int list_cap, void* cache, int num_starts,
            const void* cut0, const void* best0, const void* cap, const void* term0,
            int terminate_limit, T gain_eps, int log_len, void* log_cut, void* log_gain,
            void* log_a, void* log_b, void* out, void* stream) {
  if (n_padded % kRow != 0 || n_padded < kRow || list_cap < 0 || num_starts < 1 ||
      log_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = n_padded / kRow;
  const size_t smem = use_cache && cache == nullptr ? 4 * cache_words<T>(rows, list_cap) : 0;
  auto kernel = use_cache ? kl_pass_kernel<T, true> : kl_pass_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<num_starts, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<T*>(sf), static_cast<T*>(as), rows, list_cap,
      static_cast<unsigned*>(cache), static_cast<const T*>(cut0), static_cast<const T*>(best0),
      static_cast<const int*>(cap), static_cast<const int*>(term0), terminate_limit, gain_eps,
      log_len, static_cast<T*>(log_cut), static_cast<T*>(log_gain), static_cast<int*>(log_a),
      static_cast<int*>(log_b), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sf and a_s hold num_starts stripes of n_padded values (a multiple of 128)
// and are updated in place; cut0, best0 (the pass's type) and cap, term0
// (int) hold one value per start; each log holds num_starts stripes of
// log_len entries (log_len > every cap), of which a pass writes
// 0..iterations; out receives 8 scalars per start, those of
// megakernel.py:486-494.  With use_cache, the row cache takes
// kl/megakernel.py:k2_cache_words words per start (2 * rows maxima of the
// pass's type, ceil(rows / 32) dirty words, list_cap, rounded up to even
// in f64; rows = n_padded / 128): in dynamic shared memory if cache is
// null, else in num_starts stripes of that many words at cache.  Without,
// the flat scan runs and cache and list_cap are unused.
extern "C" int kl_pass_f32(const void* indptr, const void* indices, const void* data, void* sf,
                           void* as, int n_padded, int use_cache, int list_cap, void* cache,
                           int num_starts, const void* cut0, const void* best0, const void* cap,
                           const void* term0, int terminate_limit, float gain_eps, int log_len,
                           void* log_cut, void* log_gain, void* log_a, void* log_b, void* out,
                           void* stream) {
  return kl_pass<float>(indptr, indices, data, sf, as, n_padded, use_cache, list_cap, cache,
                        num_starts, cut0, best0, cap, term0, terminate_limit, gain_eps, log_len,
                        log_cut, log_gain, log_a, log_b, out, stream);
}

extern "C" int kl_pass_f64(const void* indptr, const void* indices, const void* data, void* sf,
                           void* as, int n_padded, int use_cache, int list_cap, void* cache,
                           int num_starts, const void* cut0, const void* best0, const void* cap,
                           const void* term0, int terminate_limit, double gain_eps, int log_len,
                           void* log_cut, void* log_gain, void* log_a, void* log_b, void* out,
                           void* stream) {
  return kl_pass<double>(indptr, indices, data, sf, as, n_padded, use_cache, list_cap, cache,
                         num_starts, cut0, best0, cap, term0, terminate_limit, gain_eps, log_len,
                         log_cut, log_gain, log_a, log_b, out, stream);
}

extern "C" const char* kl_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
