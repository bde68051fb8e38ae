// K5: the node-sharded KL pass (smega) on one card, its S shards the S
// blocks of one thread-block cluster, in float32.
//
// Replaces eig_kl_tpu/parallel/smega.py:_kernel (:166), launched by
// _smega_call (:613, the pallas_call at :633).  There every shard is a TPU
// core with its own VMEM, running the whole swap loop over its 1/S of the
// nodes; per swap two rounds of remote DMA exchange each shard's first-max
// candidate per side (round A, :310-362) and the owner's w_ab (round B,
// :480-559), and each shard updates only its own rows of A@s
// (owner-computes, :439-514).  Here a shard is a block of 1,024 threads,
// and the cluster's distributed shared memory (map_shared_rank) carries
// both rounds between two cluster barriers.  The protocol, the per-shard
// state and the owner-computes updates are the TPU kernel's, so the
// trajectory does not depend on S, and equals K2's (csrc/kl_pass.cu).
//
// Bound on this card: latency.  The swap chain is serial.  Each swap a
// block selects its candidates, crosses two cluster barriers, and walks
// two CSR rows (indptr -> indices -> a_s, dependent loads).  The bytes the
// whole pass must move take microseconds at 3.35 TB/s.
//
// Design:
// * Launch: grid = S blocks = one cluster of S (1, 2, 4 or 8, the portable
//   sizes); block r is shard r (cluster.block_rank()).
// * State: sf = side sign * free (0 = locked or padding) and a_s = A@s,
//   f32; shard r owns nodes [r * n_local, (r + 1) * n_local) and reads and
//   writes only that stripe.  Three layouts, one instantiation each, chosen
//   by the wrapper from n_local (parallel/smega.py:k5_layout):
//   - kFlat: the state in global memory; every swap each thread scans its
//     float4s of the stripe (n_local a multiple of 4).  Below the measured
//     crossover (K5_CACHE_MIN_NODES) this is the fastest.
//   - kCacheGlobal: the state in global memory, and a row-max cache of the
//     stripe in shared memory (n_local a multiple of 128).
//   - kCacheShared: the block loads its stripe of sf and a_s into dynamic
//     shared memory, runs the whole loop there beside the cache, and writes
//     both back at the end: the TPU kernel's VMEM-resident state
//     (smega.py:662-663).  8 B per node: up to 28,544 nodes per shard in
//     the 227 KB opt-in (S = 8 at gen 1.0x: 25,600 nodes, 207 KB).
// * Row-max cache (K2's, csrc/kl_pass.cu, over the shard's own rows; the
//   TPU kernel's `hierarchical` mode, smega.py:257-308): rm_l[r] and
//   rm_r[r], the maximum of D = -(sf * a_s) over local row r's 128 nodes
//   with sf > 0 and with sf < 0 (-inf if none); a dirty bit per row and a
//   list of dirty rows with room for every row (so it never overflows).
//   Local selection: a block-wide first maximum over the cached rows,
//   "larger, or equal (+0 == -0) at a lower row"; then one warp per side
//   searches the winning row's lanes and reports the first node whose D
//   equals the maximum, with that node's own D.  That is the flat first
//   maximum over the shard's nodes (K2's proof, per shard).  A shard with
//   no free node on a side reports (-inf, INT_MAX), as the flat scan does.
//   Owner-computes refresh (smega.py:439-446): a block marks the local rows
//   of the entries it added, the owners of a and b mark a's and b's rows
//   after locking them, and one warp per listed row recomputes both sides'
//   maxima.  The refresh ends before the round-B cluster.sync(), so the
//   one-slot argument below still holds and every block leaves the loop at
//   the same swap.
// * Adjacency: A is symmetric, so the rows of shard r that neighbour node
//   v are the entries of CSR row v whose columns lie in shard r's stripe.
//   Each block walks the whole row and keeps those entries.  That replaces
//   the TPU kernel's column-transpose layout (_build_colT), a shape for its
//   DMA engine: the same entries, each node receiving the same adds.
// * Round A: each block finds its first maximum of D per side (flat: strict
//   > along a thread, "larger, or equal at a lower index" across threads;
//   cached: as above), writes (m_l, a, m_r, b) into its own shared slot,
//   cluster.sync(), and warp 0 of every block reads the S slots (lane k
//   reads block k's) and combines them by the same rule.  Indices are
//   global and a shard's are above a lower shard's, so "lower index" is the
//   TPU kernel's "lower shard, then lower local index".  Indices travel as
//   int32: the TPU's 12/12-bit split exists only because its lanes are f32.
// * Column updates: each block applies -2w to its entries of row a, a
//   block barrier, then +2w to its entries of row b (the order of K2 and of
//   :446-514).  In b's owner, the thread that meets b in row a records
//   w_ab.  The owners lock a and b.
// * Round B: b's owner writes w_ab into its slot, cluster.sync(), every
//   block reads it from the owner.
// * One slot each for the candidate and w_ab is enough: a peer reads a
//   block's candidate between the round-A and the round-B cluster.sync()
//   of a swap, and the block writes the next candidate only after that
//   round-B barrier; w_ab is read after the round-B barrier, and written
//   next only after the following round-A barrier.
// * Barriers per swap: flat six (a block barrier after the local
//   reduction, cluster A, one after the exchange, one between the rows,
//   cluster B, one after the bookkeeping); the cache adds one before its
//   refresh.
// * Bookkeeping on thread 0 of every block: the gain, the Kahan-summed cut,
//   the best cut and the termination counter, computed from the same bits
//   with the same code in every block, so every block leaves the loop at
//   the same swap (a block that left early would hang its peers at the
//   next cluster.sync()).  Block 0 alone writes the four logs and the 8
//   scalars.  A final cluster.sync() keeps every block's shared memory
//   alive until its peers' last reads.
// * Every add and multiply is explicitly rounded (no FMA contraction), so
//   the pass reproduces the plain PyTorch version's bits.
// * The selection helpers (the tie rule, the flat scan's step, the cache's
//   refresh, the marks and the row updates) are K2's, from
//   csrc/kl_common.cuh, instantiated for f32: K5 stays f32, as the JAX
//   package's smega kernel is (eig_kl_tpu/parallel/smega.py:107).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

#include "kl_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxShards = 8;

// The three layouts of the state and the selection.
constexpr int kFlat = 0;
constexpr int kCacheGlobal = 1;
constexpr int kCacheShared = 2;

struct Candidate {
  float m_l;
  int a;
  float m_r;
  int b;
};

template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
    smega_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                 const float* __restrict__ data, float* sf, float* as, int n_local,
                 int n_shards, float cut0, int cap, int nf0_in, int nf1_in,
                 int terminate_limit, float gain_eps,
                 float* __restrict__ log_cut, float* __restrict__ log_gain,
                 int* __restrict__ log_a, int* __restrict__ log_b,
                 float* __restrict__ out) {
  constexpr bool kCache = kLayout != kFlat;
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());

  __shared__ Candidate cand;
  __shared__ float wab_slot;
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ int sh_a, sh_b, sh_go, sh_count;
  __shared__ float sh_ml, sh_mr, sh_wab;
  extern __shared__ float4 dyn[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = me * n_local;
  const int n4 = n_local / 4;
  const int rows = n_local / kRow;
  const int dirty_words = (rows + 31) / 32;

  // This shard's stripe, at local offsets: in global memory or, with
  // kCacheShared, loaded into the dynamic shared memory ahead of the cache.
  float* sfl = sf + r0;
  float* asl = as + r0;
  unsigned* cw = reinterpret_cast<unsigned*>(dyn);
  if constexpr (kLayout == kCacheShared) {
    float4* sf4s = dyn;
    float4* as4s = dyn + n4;
    const float4* sf4g = reinterpret_cast<const float4*>(sf + r0);
    const float4* as4g = reinterpret_cast<const float4*>(as + r0);
    for (int q = tid; q < n4; q += kThreads) {
      sf4s[q] = sf4g[q];
      as4s[q] = as4g[q];
    }
    sfl = reinterpret_cast<float*>(sf4s);
    asl = reinterpret_cast<float*>(as4s);
    cw = reinterpret_cast<unsigned*>(dyn + 2 * n4);
  }
  const Cache<float> cache{reinterpret_cast<float*>(cw), reinterpret_cast<float*>(cw + rows),
                           cw + 2 * rows, reinterpret_cast<int*>(cw + 2 * rows + dirty_words)};
  if constexpr (kCache) {
    __syncthreads();  // the stripe is loaded
    for (int r = warp; r < rows; r += kWarps) refresh_row(sfl, asl, cache, r, lane);
    for (int w = tid; w < dirty_words; w += kThreads) cache.dirty[w] = 0u;
  }

  // The scalar state lives in thread 0's registers, the same in every block.
  int term = 0, stop = 0, nf0 = nf0_in, nf1 = nf1_in;
  float cut = cut0, comp = 0.0f, best = cut0;
  int it = 0;  // every thread counts the swaps
  if (tid == 0) {
    if (me == 0) log_cut[0] = cut0;
    sh_go = cap > 0 && nf0 > 0 && nf1 > 0;
    sh_count = 0;
  }
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  while (sh_go) {
    // Round A, local part: this shard's first maximum of D per side (with
    // the cache: of the row maxima, the row's index).
    float vl = neg_inf, vr = neg_inf;
    int il = INT_MAX, ir = INT_MAX;
    if constexpr (kCache) {
      for (int r = tid; r < rows; r += kThreads) {
        const float ml = cache.rm_l[r];
        const float mr = cache.rm_r[r];
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
      const float4* sf4 = reinterpret_cast<const float4*>(sfl);
      const float4* as4 = reinterpret_cast<const float4*>(asl);
#pragma unroll 4
      for (int q = tid; q < n4; q += kThreads) {
        const float4 f = sf4[q];
        const float4 a = as4[q];
        const int base = r0 + 4 * q;
        consider(f.x, a.x, base, vl, il, vr, ir);
        consider(f.y, a.y, base + 1, vl, il, vr, ir);
        consider(f.z, a.z, base + 2, vl, il, vr, ir);
        consider(f.w, a.w, base + 3, vl, il, vr, ir);
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
    if constexpr (kCache) {
      // Warp 0 for side 0, warp 1 for side 1: the winning row, then the
      // first node in it whose masked D equals the maximum.
      if (warp < 2) {
        float v = red_v[warp][lane];
        int r = red_i[warp][lane];
        warp_argmax(v, r);
        v = __shfl_sync(kFull, v, 0);
        r = __shfl_sync(kFull, r, 0);
        int node = INT_MAX;
        float m = neg_inf;
        if (r != INT_MAX) {
          const float4 f = reinterpret_cast<const float4*>(sfl)[r * (kRow / 4) + lane];
          const float4 a = reinterpret_cast<const float4*>(asl)[r * (kRow / 4) + lane];
          const float fs[4] = {f.x, f.y, f.z, f.w};
          const float as4[4] = {a.x, a.y, a.z, a.w};
          int first = 4;
          float d_first = 0.0f;
#pragma unroll
          for (int k = 3; k >= 0; --k) {
            const float d = gain_d(fs[k], as4[k]);
            if ((warp == 0 ? fs[k] > 0.0f : fs[k] < 0.0f) && d == v) {
              first = k;
              d_first = d;
            }
          }
          const unsigned hit = __ballot_sync(kFull, first < 4);
          if (hit == 0u) __trap();  // the cache disagrees with the row
          const int src = __ffs(hit) - 1;
          node = r0 + r * kRow + 4 * src + __shfl_sync(kFull, first, src);
          m = __shfl_sync(kFull, d_first, src);
        }
        if (lane == 0) {
          if (warp == 0) {
            cand.m_l = m;
            cand.a = node;
          } else {
            cand.m_r = m;
            cand.b = node;
          }
        }
      }
    } else {
      if (warp == 0) {
        vl = red_v[0][lane];
        il = red_i[0][lane];
        vr = red_v[1][lane];
        ir = red_i[1][lane];
        warp_argmax(vl, il);
        warp_argmax(vr, ir);
        if (lane == 0) cand = Candidate{vl, il, vr, ir};
      }
    }
    cluster.sync();

    // Round A, exchange: every block combines the S candidates alike.
    if (warp == 0) {
      vl = vr = neg_inf;
      il = ir = INT_MAX;
      if (lane < n_shards) {
        const Candidate c = *cluster.map_shared_rank(&cand, lane);
        vl = c.m_l;
        il = c.a;
        vr = c.m_r;
        ir = c.b;
      }
      warp_argmax(vl, il);
      warp_argmax(vr, ir);
      if (lane == 0) {
        sh_a = il;
        sh_ml = vl;
        sh_b = ir;
        sh_mr = vr;
        sh_wab = 0.0f;
      }
    }
    __syncthreads();
    const int a = sh_a;
    const int b = sh_b;
    // No free node on a side: only if the caller's free counts disagree
    // with sf0.  Every block sees the same a and b, so all leave together.
    if (a == INT_MAX || b == INT_MAX) break;
    const int owner_a = a / n_local;
    const int owner_b = b / n_local;

    // Owner-computes: my entries of row a (s_a = +1), then of row b (s_b = -1).
    update_row<kCache>(indptr, indices, data, asl, a, r0, n_local, -2.0f, b,
                       owner_b == me ? &sh_wab : nullptr, cache, rows, &sh_count);
    __syncthreads();
    update_row<kCache>(indptr, indices, data, asl, b, r0, n_local, 2.0f, b,
                       static_cast<float*>(nullptr), cache, rows, &sh_count);
    if (tid == 0) {
      if (owner_a == me) {
        sfl[a - r0] = 0.0f;
        if constexpr (kCache) mark(cache, (a - r0) / kRow, rows, &sh_count);
      }
      if (owner_b == me) {
        sfl[b - r0] = 0.0f;
        if constexpr (kCache) mark(cache, (b - r0) / kRow, rows, &sh_count);
        wab_slot = sh_wab;
      }
    }
    if constexpr (kCache) {
      // Refresh: one warp per dirty row of this shard, both sides; every
      // flagged row is listed, so all dirty bits are clear after it.
      __syncthreads();
      const int dirty = sh_count;
      for (int k = warp; k < dirty; k += kWarps) {
        const int r = cache.list[k];
        refresh_row(sfl, asl, cache, r, lane);
        if (lane == 0) cache.dirty[r >> 5] = 0u;  // its word's rows are all listed
      }
    }
    cluster.sync();

    // Round B: w_ab from b's owner, then the replicated bookkeeping.
    ++it;
    if (tid == 0) {
      sh_count = 0;  // read by every thread before the barrier above
      const float w_ab = *cluster.map_shared_rank(&wab_slot, owner_b);
      const float gain = __fsub_rn(__fadd_rn(sh_ml, sh_mr), __fmul_rn(2.0f, w_ab));
      const float y = __fsub_rn(-gain, comp);
      const float t = __fadd_rn(cut, y);
      comp = __fsub_rn(__fsub_rn(t, cut), y);
      cut = t;
      best = fminf(cut, best);
      if (me == 0) {
        log_cut[it] = cut;
        log_gain[it] = gain;
        log_a[it] = a;
        log_b[it] = b;
      }
      term = gain <= gain_eps ? term + 1 : 0;
      stop = term > terminate_limit;
      --nf0;
      --nf1;
      sh_go = !stop && it < cap && nf0 > 0 && nf1 > 0;
    }
    __syncthreads();
  }
  // No block leaves while a peer may still read its shared memory.
  cluster.sync();

  if constexpr (kLayout == kCacheShared) {
    float4* sf4g = reinterpret_cast<float4*>(sf + r0);
    float4* as4g = reinterpret_cast<float4*>(as + r0);
    for (int q = tid; q < n4; q += kThreads) {
      sf4g[q] = dyn[q];
      as4g[q] = dyn[n4 + q];
    }
  }
  if (tid == 0 && me == 0) {
    out[0] = cut;
    out[1] = best;
    out[2] = static_cast<float>(it);
    out[3] = static_cast<float>(term);
    out[4] = static_cast<float>(nf0);
    out[5] = static_cast<float>(nf1);
    out[6] = cut0;
    out[7] = static_cast<float>(stop);
  }
}

bool valid_shards(int n_shards) {
  return n_shards == 1 || n_shards == 2 || n_shards == 4 || n_shards == kMaxShards;
}

// Dynamic shared memory of one block in a layout: the cache's 3 words per
// row and a dirty bit per row, and with kCacheShared the stripe's sf and
// a_s (parallel/smega.py:k5_shared_bytes chooses the layout from it).
long long shared_bytes(int n_local, int layout) {
  if (layout == kFlat) return 0;
  const long long rows = n_local / kRow;
  const long long cache = 4 * (3 * rows + (rows + 31) / 32);
  return layout == kCacheShared ? 8LL * n_local + cache : cache;
}

}  // namespace

// One pass over n_shards * n_local nodes of a graph of at most that many
// nodes, in a layout (0 flat: n_local a multiple of 4; 1 and 2, the row-max
// cache: n_local a multiple of 128).  sf and as hold the padded state and
// are updated in place; each log holds log_len entries (log_len > cap), of
// which the pass writes 0..iterations; out receives the 8 scalars of
// smega.py:603-610.  Returns cudaErrorLaunchOutOfResources, launching
// nothing, if the card cannot hold one cluster of n_shards blocks with the
// layout's shared memory.
extern "C" int smega_pass_f32(const void* indptr, const void* indices,
                              const void* data, void* sf, void* as, int n_local,
                              int n_shards, int layout, float cut0, int cap, int nf0,
                              int nf1, int terminate_limit, float gain_eps,
                              int log_len, void* log_cut,
                              void* log_gain, void* log_a, void* log_b, void* out,
                              void* stream) {
  const int unit = layout == kFlat ? 4 : kRow;
  if (n_local < unit || n_local % unit != 0 || !valid_shards(n_shards) ||
      layout < kFlat || layout > kCacheShared || log_len < 1 || cap >= log_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = layout == kFlat          ? smega_kernel<kFlat>
                : layout == kCacheGlobal ? smega_kernel<kCacheGlobal>
                                         : smega_kernel<kCacheShared>;
  const long long smem = shared_bytes(n_local, layout);
  if (smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // The opt-in first, so that the occupancy query sees the real footprint.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_shards, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_shards;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel),
                                       &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const int*>(indptr),
      static_cast<const int*>(indices), static_cast<const float*>(data),
      static_cast<float*>(sf), static_cast<float*>(as), n_local, n_shards, cut0,
      cap, nf0, nf1, terminate_limit, gain_eps,
      static_cast<float*>(log_cut), static_cast<float*>(log_gain),
      static_cast<int*>(log_a), static_cast<int*>(log_b), static_cast<float*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
