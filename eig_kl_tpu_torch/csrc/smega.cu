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
// block scans 8 bytes per node of its stripe (8 n / S bytes per swap over
// the cluster) from L2, reduces it, crosses two cluster barriers, and walks
// two CSR rows (indptr -> indices -> a_s, dependent loads).  The bytes the
// whole pass must move take microseconds at 3.35 TB/s.
//
// Design:
// * Launch: grid = S blocks = one cluster of S (1, 2, 4 or 8, the portable
//   sizes); block r is shard r (cluster.block_rank()).
// * State: sf = side sign * free (0 = locked or padding) and a_s = A@s, f32
//   in global memory; shard r owns nodes [r * n_local, (r + 1) * n_local)
//   and reads and writes only that stripe.  n_local is a multiple of 128,
//   so the scan reads float4s.
// * Adjacency: A is symmetric, so the rows of shard r that neighbour node
//   v are the entries of CSR row v whose columns lie in shard r's stripe.
//   Each block walks the whole row and keeps those entries.  That replaces
//   the TPU kernel's column-transpose layout (_build_colT), a shape for its
//   DMA engine: the same entries, each node receiving the same adds.
// * Round A: each block finds its first maximum of D = -(sf * a_s) per side
//   (as K2 does, strict > along a thread, "larger, or equal (+0 == -0) at a
//   lower index" across threads), writes (m_l, a, m_r, b) into its own
//   shared slot, cluster.sync(), and warp 0 of every block reads the
//   S slots (lane k reads block k's) and combines them by the same rule.
//   Indices are global and a shard's are above a lower shard's, so "lower
//   index" is the TPU kernel's "lower shard, then lower local index".
//   Indices travel as int32: the TPU's 12/12-bit split exists only because
//   its lanes are f32.
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
// * Bookkeeping on thread 0 of every block: the gain, the Kahan-summed cut,
//   the best cut and the termination counter, computed from the same bits
//   with the same code in every block, so every block leaves the loop at
//   the same swap (a block that left early would hang its peers at the
//   next cluster.sync()).  Block 0 alone writes the four logs and the 8
//   scalars.  A final cluster.sync() keeps every block's shared memory
//   alive until its peers' last reads.
// * Every add and multiply is explicitly rounded (no FMA contraction), so
//   the pass reproduces the plain PyTorch version's bits.
// Left for later: keeping a shard's state in shared memory (at S = 8 and
// gen 1.0x a shard's 25,600 nodes x 8 B = 200 KB fit one block's 227 KB,
// the counterpart of the TPU kernel's VMEM-resident state), and the TPU
// kernel's per-row max cache (used there above 2^17 nodes per shard).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Candidate {
  float m_l;
  int a;
  float m_r;
  int b;
};

// (v2, i2) beats (v1, i1): a larger value, or an equal one at a lower index.
__device__ __forceinline__ bool beats(float v2, int i2, float v1, int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(kFull, v, off);
    const int i2 = __shfl_down_sync(kFull, i, off);
    if (beats(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
}

// Indices reach a thread in increasing order, so a strict > keeps the first.
__device__ __forceinline__ void consider(float f, float a, int idx, float& vl,
                                         int& il, float& vr, int& ir) {
  const float d = -(f * a);
  if (f > 0.0f) {
    if (d > vl) {
      vl = d;
      il = idx;
    }
  } else if (f < 0.0f) {
    if (d > vr) {
      vr = d;
      ir = idx;
    }
  }
}

// Adds coef * w into a_s over the entries of one CSR row whose columns lie
// in the stripe [r0, r0 + n_local); where wab is given, the thread that
// meets column b records its weight there.
__device__ __forceinline__ void update_row(const int* indptr, const int* indices,
                                           const float* data, float* as, int row,
                                           int r0, int n_local, float coef, int b,
                                           float* wab) {
  const int lo = indptr[row];
  const int deg = indptr[row + 1] - lo;
  for (int k = threadIdx.x; k < deg; k += kThreads) {
    const int j = indices[lo + k];
    if (static_cast<unsigned>(j - r0) >= static_cast<unsigned>(n_local)) continue;
    const float w = data[lo + k];
    as[j] = __fadd_rn(as[j], __fmul_rn(coef, w));
    if (wab != nullptr && j == b) *wab = w;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    smega_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                 const float* __restrict__ data, float* sf, float* as, int n_local,
                 int n_shards, float cut0, int cap, int nf0_in, int nf1_in,
                 int terminate_limit, float gain_eps,
                 float* __restrict__ log_cut, float* __restrict__ log_gain,
                 int* __restrict__ log_a, int* __restrict__ log_b,
                 float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());

  __shared__ Candidate cand;
  __shared__ float wab_slot;
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ int sh_a, sh_b, sh_go;
  __shared__ float sh_ml, sh_mr, sh_wab;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = me * n_local;
  const int n4 = n_local / 4;
  const float4* sf4 = reinterpret_cast<const float4*>(sf + r0);
  const float4* as4 = reinterpret_cast<const float4*>(as + r0);

  // The scalar state lives in thread 0's registers, the same in every block.
  int term = 0, stop = 0, nf0 = nf0_in, nf1 = nf1_in;
  float cut = cut0, comp = 0.0f, best = cut0;
  int it = 0;  // every thread counts the swaps
  if (tid == 0) {
    if (me == 0) log_cut[0] = cut0;
    sh_go = cap > 0 && nf0 > 0 && nf1 > 0;
  }
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  while (sh_go) {
    // Round A, local part: this shard's first maximum of D per side.
    float vl = neg_inf, vr = neg_inf;
    int il = INT_MAX, ir = INT_MAX;
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
    warp_argmax(vl, il);
    warp_argmax(vr, ir);
    if (lane == 0) {
      red_v[0][warp] = vl;
      red_i[0][warp] = il;
      red_v[1][warp] = vr;
      red_i[1][warp] = ir;
    }
    __syncthreads();
    if (warp == 0) {
      vl = red_v[0][lane];
      il = red_i[0][lane];
      vr = red_v[1][lane];
      ir = red_i[1][lane];
      warp_argmax(vl, il);
      warp_argmax(vr, ir);
      if (lane == 0) cand = Candidate{vl, il, vr, ir};
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
    update_row(indptr, indices, data, as, a, r0, n_local, -2.0f, b,
               owner_b == me ? &sh_wab : nullptr);
    __syncthreads();
    update_row(indptr, indices, data, as, b, r0, n_local, 2.0f, b, nullptr);
    if (tid == 0) {
      if (owner_a == me) sf[a] = 0.0f;
      if (owner_b == me) {
        sf[b] = 0.0f;
        wab_slot = sh_wab;
      }
    }
    cluster.sync();

    // Round B: w_ab from b's owner, then the replicated bookkeeping.
    ++it;
    if (tid == 0) {
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

// How many clusters of n_shards blocks the card holds at once, asked once
// per size (0: not asked yet).
int max_clusters[kMaxShards + 1] = {};

}  // namespace

// One pass over n_shards * n_local nodes (n_local a multiple of 4), of a
// graph of at most that many nodes.  sf and as hold the padded state and
// are updated in place; each log holds log_len entries (log_len > cap), of
// which the pass writes 0..iterations; out receives the 8 scalars of
// smega.py:603-610.  Returns cudaErrorLaunchOutOfResources, launching
// nothing, if the card cannot hold one cluster of n_shards blocks.
extern "C" int smega_pass_f32(const void* indptr, const void* indices,
                              const void* data, void* sf, void* as, int n_local,
                              int n_shards, float cut0, int cap, int nf0,
                              int nf1, int terminate_limit, float gain_eps,
                              int log_len, void* log_cut,
                              void* log_gain, void* log_a, void* log_b, void* out,
                              void* stream) {
  if (n_local < 4 || n_local % 4 != 0 || !valid_shards(n_shards) || log_len < 1 ||
      cap >= log_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_shards, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_shards;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  if (max_clusters[n_shards] == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &max_clusters[n_shards], reinterpret_cast<const void*>(smega_kernel), &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_clusters[n_shards] < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  const cudaError_t err = cudaLaunchKernelEx(
      &config, smega_kernel, static_cast<const int*>(indptr),
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
