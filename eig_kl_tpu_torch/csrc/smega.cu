// K5: the node-sharded KL pass (smega) on one card, its S shards the S
// blocks of one thread-block cluster, in float32; and K5R, the same pass
// across the S ranks of a process group, one block per rank, its two
// rounds per swap through peer memory (the TPU kernel's multi-device form).
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

// K5R (smega_ranks_pass_f32): the same block body, templated on its
// exchange (PeerExchange below, ClusterExchange for K5), one persistent
// block of 1,024 threads per rank, each rank on its own card, or several
// ranks on one card (CUDA IPC works between processes of one device; the
// card then time-slices between their contexts, so a round can wait for a
// whole time slice).  A rank holds only what a TPU shard holds: its stripe
// of sf and a_s, and its column slice, for every node v the entries of row
// v whose column lies in its stripe (the content of _build_colT, :93, in
// CSR form), so update_row's range test always passes.
// * Exchange buffer: each rank cudaMallocs one PeerBuffer (below) and
//   exports it (cudaIpcGetMemHandle); every rank maps every peer's
//   (cudaIpcOpenMemHandle with lazy peer access) and gets the S pointers
//   (its own among them) as a kernel argument.  Every rank writes into its
//   peers' buffers and reads only its own.
// * Epochs: a flag holds (call << 32) | (swap + 1), the call numbered by
//   the wrapper alike on every rank, so no flag is ever reset and a stale
//   flag of an earlier call, or of an aborted one, never matches.
// * Round A: lane k < S of warp 0 stores this rank's candidate into slot
//   [swap & 1][me] of peer k's buffer, __threadfence_system(), then the
//   flag with st.release.sys; then lane k spins with ld.acquire.sys on its
//   own buffer's flag [swap & 1][k] and reads candidate k.
// * Round B: b's owner alone stores w_ab into slot [swap & 1] of every
//   buffer, fences, and releases the flags; thread 0 of every rank spins on
//   its own.
// * Slot reuse: a rank writes slot parity p again at swap i + 2, which it
//   reaches only after swap i + 1's round A, that is after every peer wrote
//   its swap i + 1 candidate, which a peer does only once it has finished
//   swap i, its reads of swap i's candidates and w_ab included.  So two
//   slots per round are enough (the TPU kernel's "round B's wait
//   transitively fences slot reuse two iterations apart", smega.py:34-37).
//   Across calls the wrapper's launch barrier (a group collective after
//   each rank's previous launch finished) stands in for the TPU's barrier
//   semaphore (smega.py:210-216).
// * No hang: every spin is bounded by %globaltimer; on expiry the rank
//   records (code, round, swap, peer) in its status words, leaves the loop
//   with its peers' state unknown, and the wrapper raises naming the rank
//   and the round.
// * Every rank writes the logs and scalars into its own outputs (they are
//   the same bits on every rank), and its final stripe of sf.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstring>

#include "kl_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxShards = 8;

// The three layouts of the state and the selection.
constexpr int kFlat = 0;
constexpr int kCacheGlobal = 1;
constexpr int kCacheShared = 2;

struct alignas(16) Candidate {
  float m_l;
  int a;
  float m_r;
  int b;
};

// K5's exchange: the blocks of one cluster, through distributed shared
// memory between cluster barriers.  Its reads never fail.
struct ClusterExchange {
  // The blocks share one launch's arrays: the state holds every shard's
  // stripe, and block 0 alone writes the logs and scalars.
  static constexpr bool kShared = true;
  __device__ int rank() const { return static_cast<int>(cg::this_cluster().block_rank()); }
  // All threads, once this block's candidate is in `cand`.
  __device__ void publish_a(const Candidate*, int) const { cg::this_cluster().sync(); }
  // Lane k of warp 0: block k's candidate.
  __device__ bool read_a(const Candidate* cand, int k, int, Candidate* c) const {
    *c = *cg::this_cluster().map_shared_rank(cand, k);
    return true;
  }
  // Thread 0 of b's owner.
  __device__ void publish_b(float* slot, float w, int) const { *slot = w; }
  // All threads, after the row updates.
  __device__ void sync_b() const { cg::this_cluster().sync(); }
  // Thread 0: the owner's w_ab.
  __device__ bool read_b(float* slot, int owner, int, float* w) const {
    *w = *cg::this_cluster().map_shared_rank(slot, owner);
    return true;
  }
  // No block leaves while a peer may still read its shared memory.
  __device__ void finish(unsigned long long) const { cg::this_cluster().sync(); }
  __device__ void fail(int, int, int) const {}
};

// K5R's exchange buffer, one per rank, written by its peers.
struct PeerBuffer {
  Candidate cand[2][kMaxShards];
  unsigned long long cand_flag[2][kMaxShards];
  float wab[2][2];  // [parity][0]; 16-byte rows
  unsigned long long wab_flag[2];
};

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// K5R's status words: 0 or kTimedOut, the round (0 A, 1 B), the swap and
// the peer waited for; then the kernel's own duration in ns (thread 0's
// %globaltimer from its start to its end).
constexpr long long kTimedOut = 1;

// K5R's exchange: the ranks of a group, through their PeerBuffers.
struct PeerExchange {
  static constexpr bool kShared = false;  // every rank has its own arrays
  PeerBuffer* peer[kMaxShards];  // every rank's buffer, this rank's own at [me]
  int me;
  int n_ranks;
  unsigned call;
  unsigned long long timeout_ns;
  long long* status;

  __device__ int rank() const { return me; }
  __device__ unsigned long long epoch(int swap) const {
    return (static_cast<unsigned long long>(call) << 32) | static_cast<unsigned>(swap + 1);
  }
  // Spins until *flag holds the epoch; false when the bound expires.
  __device__ bool wait(const unsigned long long* flag, unsigned long long e) const {
    const unsigned long long t0 = global_ns();
    while (load_acquire_sys(flag) != e) {
      if (global_ns() - t0 > timeout_ns) return false;
    }
    return true;
  }
  __device__ void publish_a(const Candidate* cand, int swap) const {
    __syncthreads();  // the candidate is in shared memory
    const int lane = threadIdx.x;
    if (lane < n_ranks) {
      const int p = swap & 1;
      PeerBuffer* to = peer[lane];
      *reinterpret_cast<int4*>(&to->cand[p][me]) = *reinterpret_cast<const int4*>(cand);
      __threadfence_system();
      store_release_sys(&to->cand_flag[p][me], epoch(swap));
    }
  }
  __device__ bool read_a(const Candidate*, int k, int swap, Candidate* c) const {
    const int p = swap & 1;
    if (!wait(&peer[me]->cand_flag[p][k], epoch(swap))) return false;
    const int4 v = __ldcv(reinterpret_cast<const int4*>(&peer[me]->cand[p][k]));
    *c = Candidate{__int_as_float(v.x), v.y, __int_as_float(v.z), v.w};
    return true;
  }
  __device__ void publish_b(float*, float w, int swap) const {
    const int p = swap & 1;
    for (int k = 0; k < n_ranks; ++k) peer[k]->wab[p][0] = w;
    __threadfence_system();
    for (int k = 0; k < n_ranks; ++k) store_release_sys(&peer[k]->wab_flag[p], epoch(swap));
  }
  __device__ void sync_b() const { __syncthreads(); }
  __device__ bool read_b(float*, int, int swap, float* w) const {
    const int p = swap & 1;
    if (!wait(&peer[me]->wab_flag[p], epoch(swap))) return false;
    *w = __ldcv(&peer[me]->wab[p][0]);
    return true;
  }
  __device__ void finish(unsigned long long t_start) const {
    if (threadIdx.x == 0) status[4] = static_cast<long long>(global_ns() - t_start);
  }
  __device__ void fail(int round, int swap, int waited_for) const {
    status[0] = kTimedOut;
    status[1] = round;
    status[2] = swap;
    status[3] = waited_for;
  }
};

// The pass of one shard, nodes [r0, r0 + n_local) with r0 = me * n_local.
// sf and as hold the whole padded state (K5) or the rank's stripe (K5R);
// indptr, indices and data are rows whose entries the shard keeps where
// their column lies in its stripe (K5: the whole CSR; K5R: its column
// slice).
template <int kLayout, class Exchange>
__global__ void __launch_bounds__(kThreads, 1)
    smega_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                 const float* __restrict__ data, float* sf, float* as, int n_local,
                 int n_shards, float cut0, int cap, int nf0_in, int nf1_in,
                 int terminate_limit, float gain_eps,
                 float* __restrict__ log_cut, float* __restrict__ log_gain,
                 int* __restrict__ log_a, int* __restrict__ log_b,
                 float* __restrict__ out, const Exchange ex) {
  constexpr bool kCache = kLayout != kFlat;
  const int me = ex.rank();
  const bool logs = !Exchange::kShared || me == 0;

  __shared__ Candidate cand;
  __shared__ float wab_slot;
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ int sh_a, sh_b, sh_go, sh_count, sh_err;
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
  if constexpr (Exchange::kShared) {
    sf += r0;
    as += r0;
  }
  float* sfl = sf;
  float* asl = as;
  unsigned* cw = reinterpret_cast<unsigned*>(dyn);
  if constexpr (kLayout == kCacheShared) {
    float4* sf4s = dyn;
    float4* as4s = dyn + n4;
    const float4* sf4g = reinterpret_cast<const float4*>(sf);
    const float4* as4g = reinterpret_cast<const float4*>(as);
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
  const unsigned long long t_start = global_ns();
  if (tid == 0) {
    if (logs) log_cut[0] = cut0;
    sh_go = cap > 0 && nf0 > 0 && nf1 > 0;
    sh_count = 0;
    sh_err = 0;
  }
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  while (sh_go) {
    const int swap = it;
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
    ex.publish_a(&cand, swap);

    // Round A, exchange: every block combines the S candidates alike.
    if (warp == 0) {
      vl = vr = neg_inf;
      il = ir = INT_MAX;
      bool late = false;
      if (lane < n_shards) {
        Candidate c;
        late = !ex.read_a(&cand, lane, swap, &c);
        if (!late) {
          vl = c.m_l;
          il = c.a;
          vr = c.m_r;
          ir = c.b;
        }
      }
      const unsigned missing = __ballot_sync(kFull, late);
      warp_argmax(vl, il);
      warp_argmax(vr, ir);
      if (lane == 0 && missing != 0u) {
        sh_err = 1;
        ex.fail(0, swap, __ffs(missing) - 1);
      }
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
    // (A rank whose wait expired leaves alone, and raises.)
    if (sh_err || a == INT_MAX || b == INT_MAX) break;
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
        ex.publish_b(&wab_slot, sh_wab, swap);
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
    ex.sync_b();

    // Round B: w_ab from b's owner, then the replicated bookkeeping.
    ++it;
    float w_ab;
    if (tid == 0 && !ex.read_b(&wab_slot, owner_b, swap, &w_ab)) {
      sh_err = 1;
      sh_go = 0;
      ex.fail(1, swap, owner_b);
    } else if (tid == 0) {
      sh_count = 0;  // read by every thread before the barrier above
      const float gain = __fsub_rn(__fadd_rn(sh_ml, sh_mr), __fmul_rn(2.0f, w_ab));
      const float y = __fsub_rn(-gain, comp);
      const float t = __fadd_rn(cut, y);
      comp = __fsub_rn(__fsub_rn(t, cut), y);
      cut = t;
      best = fminf(cut, best);
      if (logs) {
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
  ex.finish(t_start);

  if constexpr (kLayout == kCacheShared) {
    float4* sf4g = reinterpret_cast<float4*>(sf);
    float4* as4g = reinterpret_cast<float4*>(as);
    for (int q = tid; q < n4; q += kThreads) {
      sf4g[q] = dyn[q];
      as4g[q] = dyn[n4 + q];
    }
  }
  if (tid == 0 && logs) {
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

bool valid_pass(int n_local, int layout, int cap, int log_len) {
  const int unit = layout == kFlat ? 4 : kRow;
  return n_local >= unit && n_local % unit == 0 && layout >= kFlat && layout <= kCacheShared &&
         log_len >= 1 && cap < log_len;
}

// Launches the pass in a layout on `blocks` blocks, as one cluster of that
// many where `cluster` is set (K5), else as a plain grid (K5R's one block).
// Returns cudaErrorLaunchOutOfResources, launching nothing, where the card
// cannot hold the blocks with the layout's shared memory.
template <class Exchange>
int launch(int layout, int blocks, bool cluster, const void* stream, const int* indptr,
           const int* indices, const float* data, float* sf, float* as, int n_local,
           int n_shards, float cut0, int cap, int nf0, int nf1, int terminate_limit,
           float gain_eps, float* log_cut, float* log_gain, int* log_a, int* log_b, float* out,
           const Exchange& ex) {
  auto kernel = layout == kFlat          ? smega_kernel<kFlat, Exchange>
                : layout == kCacheGlobal ? smega_kernel<kCacheGlobal, Exchange>
                                         : smega_kernel<kCacheShared, Exchange>;
  const long long smem = shared_bytes(n_local, layout);
  if (smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // The opt-in first, so that the occupancy query sees the real footprint.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(const_cast<void*>(stream));
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = cluster ? &attr : nullptr;
  config.numAttrs = cluster ? 1 : 0;
  int fits = 0;
  if (cluster) {
    err = cudaOccupancyMaxActiveClusters(&fits, reinterpret_cast<const void*>(kernel), &config);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, kernel, kThreads, static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fits < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&config, kernel, indptr, indices, data, sf, as, n_local, n_shards, cut0,
                           cap, nf0, nf1, terminate_limit, gain_eps, log_cut, log_gain, log_a,
                           log_b, out, ex);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  if (!valid_shards(n_shards) || !valid_pass(n_local, layout, cap, log_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(layout, n_shards, true, stream, static_cast<const int*>(indptr),
                static_cast<const int*>(indices), static_cast<const float*>(data),
                static_cast<float*>(sf), static_cast<float*>(as), n_local, n_shards, cut0, cap,
                nf0, nf1, terminate_limit, gain_eps, static_cast<float*>(log_cut),
                static_cast<float*>(log_gain), static_cast<int*>(log_a),
                static_cast<int*>(log_b), static_cast<float*>(out), ClusterExchange{});
}

// K5R: rank `rank` of n_ranks (1..8) runs its shard of n_ranks * n_local
// nodes, one block.  indptr, indices and data are its column slice (rows
// of every node, columns in its stripe); sf and as its stripe, updated in
// place; the logs and out as smega_pass_f32's, written by every rank.
// buffers holds the n_ranks ranks' exchange buffers, mapped into this
// process (this rank's own at [rank]); call numbers this call alike on
// every rank (from 1); a spin gives up after timeout_ns.  status receives
// 5 int64 words (see PeerExchange::fail and finish), zeroed by the caller.
extern "C" int smega_ranks_pass_f32(const void* indptr, const void* indices, const void* data,
                                    void* sf, void* as, int n_local, int rank, int n_ranks,
                                    int layout, float cut0, int cap, int nf0, int nf1,
                                    int terminate_limit, float gain_eps, int log_len,
                                    void* log_cut, void* log_gain, void* log_a, void* log_b,
                                    void* out, void* const* buffers, unsigned call,
                                    long long timeout_ns, void* status, void* stream) {
  if (n_ranks < 1 || n_ranks > kMaxShards || rank < 0 || rank >= n_ranks || call == 0 ||
      timeout_ns <= 0 || !valid_pass(n_local, layout, cap, log_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PeerExchange ex = {};
  for (int k = 0; k < n_ranks; ++k) ex.peer[k] = static_cast<PeerBuffer*>(buffers[k]);
  ex.me = rank;
  ex.n_ranks = n_ranks;
  ex.call = call;
  ex.timeout_ns = static_cast<unsigned long long>(timeout_ns);
  ex.status = static_cast<long long*>(status);
  return launch(layout, 1, false, stream, static_cast<const int*>(indptr),
                static_cast<const int*>(indices), static_cast<const float*>(data),
                static_cast<float*>(sf), static_cast<float*>(as), n_local, n_ranks, cut0, cap, nf0,
                nf1, terminate_limit, gain_eps, static_cast<float*>(log_cut),
                static_cast<float*>(log_gain), static_cast<int*>(log_a),
                static_cast<int*>(log_b), static_cast<float*>(out), ex);
}

// K5R's exchange buffer on `device`: allocated by cudaMalloc (so that its
// IPC handle maps the base of the allocation), zeroed, and exported into
// the 64 bytes at handle.
extern "C" int smega_exchange_alloc(int device, void** buffer, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(buffer, sizeof(PeerBuffer));
  if (err == cudaSuccess) err = cudaMemset(*buffer, 0, sizeof(PeerBuffer));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *buffer);
  }
  return static_cast<int>(err);
}

// A peer's exchange buffer, mapped into this process from its handle.
extern "C" int smega_exchange_open(int device, const void* handle, void** buffer) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(buffer, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int smega_exchange_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

extern "C" const char* smega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
