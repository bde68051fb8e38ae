// K3a, K3b, K3c: the v3 SpMV y = A @ x through a Benes permutation, f32.
//
// Replace the TPU kernels of eig_kl_tpu/ops/spmv_pallas.py's v3 path
// (_spmv_v3_call, :1841): _gather_v3_kernel (:1698) -> K3a,
// _benes_kernel (:1718) -> K3b, _reduce_v3_kernel (:1802) -> K3c.  The plan
// (ops/spmv_v3.py) holds the matrix's entries twice in 512-slot chunks:
// in column order for the gather, each chunk reading one 1,024-wide window
// of x; in CSR order for the reduce, each chunk adding into one 1,024-row
// window of y.  The Benes network moves each product from its gather slot
// to its CSR slot.
//
// Bound on this card: bytes.  At gen 1.0x (N = 2^21 slots, 4,096 chunks,
// P = 202,752 padded nodes) K3a must move 10N + 4P + 4C bytes (21.8 MB,
// 6.5 us at 3.35 TB/s), the network 8N bytes of values plus 41 rows of
// N/8 bytes of switch bits (27.5 MB, 8.2 us), K3c 10N + 4P + 4C bytes
// (21.8 MB, 6.5 us); the flops are negligible.
//
// Design: exact.  K3a and K3c are simple; K3b runs each group of stages
// on tiles held in shared memory and registers.
// * K3a: one thread per slot.  The TPU kernel selects x by a sum of masked
//   candidates starting from +0, so a -0 becomes +0 before the product:
//   e = (0 + x) * w, with explicit _rn intrinsics (no contraction).
// * K3b: the 2m - 1 stages (distances N/2, ..., 2, 1, 2, ..., N/2) in
//   groups, each group one launch of N / T blocks over tiles of T = 2^t
//   slots held in shared memory (t = 14: 64 KB of f32, one block per SM
//   at N = 2^21; measured faster than t = 13's two blocks per SM).  A
//   block loads its tile and its tile's switch words of every stage of
//   the group, runs the stages with a barrier between them and writes the
//   tile back.
//   An exchange is done in place: one thread owns the pair (i, i ^ e) of
//   tile positions, reads both values and writes both.
//   - The low group, the 2t - 1 middle stages with d < T: tile b is the
//     T contiguous slots from b * T.
//   - The two high groups, the first and the last m - t stages (d >= T):
//     block b owns the 2^(m-t) slots that differ only in bits t..m-1,
//     each times a run of L = 2^(t-(m-t)) contiguous slots from b * L, so
//     a distance d = 2^(t+j) is the tile distance L * 2^j.  A run must
//     be at least 32 slots (one switch word, coalesced loads): m <= 2t - 5
//     (t = 14: m <= 23; the plans stop at BENES_MAX = 2^21, runs of 128).
//     The wrapper checks it (ops/spmv_v3.py:benes_groups, which also makes
//     the groups).
//   - N <= T: one group of all stages on one tile of N slots.
//   Tile position i of block b is slot ((i >> l) << t) + (b << l) +
//   (i & (L - 1)), with L = 2^l (L = T for the low group); its switch bit
//   is bit i & 31 of the tile's word i >> 5, since runs are whole words.
//   A block's loads are issued eight at a time per thread, so their
//   latencies overlap.
//   With T = 8 or 16 slots per thread, the stages at short tile
//   distances run out of shared memory: each thread holds kP = T / 1,024
//   consecutive tile positions in registers, so a stage at tile distance
//   e < kP is an exchange between its own registers and one at kP <= e <
//   32 kP a warp shuffle; a thread's kP switch bits lie in one word.  At
//   t = 14 that is 17 of the low group's 27 stages (e = 256, ..., 1, ...,
//   256) and 2 of each high group's 7 (e = 128, 256); the others run
//   pairwise in shared memory (per pair two value reads, two bit-word
//   reads, two writes).
//   Three launches per network at gen 1.0x, one entry point that issues
//   them on the stream.  A cooperative launch with a grid barrier between
//   the groups would save two launches' latency (a few us); the host
//   issues the three in one call, so it is not taken.  Tiles below 2^13
//   slots have no register mode, and their shared-memory exchanges at
//   e < 32 meet bank conflicts (2-way at e = 1); left as they are.  What
//   bounds K3b now is the pairwise shared-memory stages (PERF.md).
// * K3c: one 512-thread block per chunk.  The scan is the TPU kernel's:
//   step k (1, 2, ..., 256) sets e[f] += (f >= k && rl[f-k] == rl[f]) ?
//   e[f-k] : +0 (that +0 add turns a -0 into +0; the bits depend on it).
//   Steps 1..16 run within each warp, in registers and shuffles: each lane
//   holds its slot and the slot 32 below it (a halo the warp recomputes),
//   so no barrier; steps 32..256 run in shared memory, double-buffered,
//   one barrier each: five block barriers per chunk.  y must equal the TPU
//   kernel's chunk-ordered accumulation ((+0 + p1) + p2) + ... over the
//   chunks holding part of a row, so there are no atomics: a row inside
//   one chunk is written by that chunk's block; a row that crosses chunk
//   boundaries is summed, in chunk order, by the block of the chunk where
//   it starts.  What it reads of a following chunk is the scan's value at
//   the end of that chunk's first segment, which depends only on the
//   segment's own slots (the chunk start is the segment start, and every
//   step's mask is relative to the position): warp 0 scans those slots
//   alone, in registers up to 32 of them, else in a scratch buffer.  A row
//   of degree > 512 spans three or more chunks and takes that loop more
//   than once.

#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::block_scan_steps;
using seg_scan::warp_scan_steps;

constexpr int kChunk = 512;
constexpr int kWindow = 1024;
constexpr int kBenesThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void gather_v3_kernel(const int* __restrict__ cw8,
                                 const short* __restrict__ col_local,
                                 const float* __restrict__ w,
                                 const float* __restrict__ x,
                                 float* __restrict__ e, int n_slots) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const float xv = x[128 * cw8[s / kChunk] + col_local[s]];
  e[s] = __fmul_rn(__fadd_rn(0.0f, xv), w[s]);
}

// One exchange stage at tile distance e < kP inside each thread's kP
// registers: v[r] takes v[r ^ e] where bit r of `bits` is set.
template <int kP, int kE>
__device__ __forceinline__ void register_stage(float (&v)[kP], unsigned bits) {
  float w[kP];
#pragma unroll
  for (int r = 0; r < kP; ++r) w[r] = ((bits >> r) & 1u) ? v[r ^ kE] : v[r];
#pragma unroll
  for (int r = 0; r < kP; ++r) v[r] = w[r];
}

// Stages s0 .. s0 + ns - 1 of the network on N = 2^m slots, on tiles of
// 2^t slots in runs of 2^l (see the header).  in may equal out: a block
// reads and writes only its own tile's slots.  With kP > 0 (a tile of
// exactly kP * kBenesThreads slots), the stages at tile distance
// e < 32 kP run in registers: thread (warp, lane) holds the kP slots from
// (warp * 32 + lane) * kP, so e < kP is a register exchange and
// kP <= e < 32 kP a warp shuffle at lane distance e / kP; the others run
// pairwise in shared memory.
template <int kP>
__global__ void __launch_bounds__(kBenesThreads)
    benes_group_kernel(const unsigned* __restrict__ masks, const float* in,
                       float* out, int m, int t, int l, int s0, int ns) {
  constexpr int kUnroll = 8;  // loads in flight per thread
  extern __shared__ float tile[];
  const int T = 1 << t;
  const int words = T >> 5;  // switch words per stage in one tile
  unsigned* bits = reinterpret_cast<unsigned*>(tile + T);
  const size_t row_words = size_t{1} << (m - 5);
  const int run_mask = (1 << l) - 1;
  const int base = blockIdx.x << l;
  auto slot = [&](int i) { return ((i >> l) << t) + base + (i & run_mask); };

  for (int i0 = threadIdx.x; i0 < T; i0 += kUnroll * kBenesThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kBenesThreads;
      if (i < T) v[u] = in[slot(i)];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kBenesThreads;
      if (i < T) tile[i] = v[u];
    }
  }
  for (int k0 = threadIdx.x; k0 < ns * words; k0 += kUnroll * kBenesThreads) {
    unsigned w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kBenesThreads;
      const int st = k / words;
      if (k < ns * words) {
        w[u] = masks[(s0 + st) * row_words + (slot((k - st * words) << 5) >> 5)];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kBenesThreads;
      if (k < ns * words) bits[k] = w[u];
    }
  }
  __syncthreads();

  constexpr int kP1 = kP > 0 ? kP : 1;
  float v[kP1];
  bool in_regs = false;
  const int first = threadIdx.x * kP;  // this thread's slots in register mode
  for (int st = 0; st < ns; ++st) {
    const int s = s0 + st;
    const int d = s < m ? 1 << (m - 1 - s) : 2 << (s - m);
    const int e = d < T ? d : (d >> t) << l;  // the distance in the tile
    const unsigned* sb = bits + st * words;
    if (kP > 0 && e < 32 * kP) {
      if (!in_regs) {  // the last shared-memory stage ended with a barrier
#pragma unroll
        for (int r = 0; r < kP1; ++r) v[r] = tile[first + r];
        in_regs = true;
      }
      const unsigned my = sb[first >> 5] >> (first & 31);
      if (e >= kP1) {
#pragma unroll
        for (int r = 0; r < kP1; ++r) {
          const float other = __shfl_xor_sync(0xffffffffu, v[r], e / kP1);
          if ((my >> r) & 1u) v[r] = other;
        }
      } else if (e == 1) {
        register_stage<kP1, 1 % kP1>(v, my);
      } else if (e == 2) {
        register_stage<kP1, 2 % kP1>(v, my);
      } else if (e == 4) {
        register_stage<kP1, 4 % kP1>(v, my);
      } else if (e == 8) {
        register_stage<kP1, 8 % kP1>(v, my);
      }
      continue;
    }
    if (in_regs) {
#pragma unroll
      for (int r = 0; r < kP1; ++r) tile[first + r] = v[r];
      in_regs = false;
      __syncthreads();
    }
    const int k = __ffs(e) - 1;
    for (int q = threadIdx.x; q < T / 2; q += kBenesThreads) {
      const int i = ((q >> k) << (k + 1)) | (q & (e - 1));
      const int j = i | e;
      const float vi = tile[i];
      const float vj = tile[j];
      const bool si = (sb[i >> 5] >> (i & 31)) & 1u;
      const bool sj = (sb[j >> 5] >> (j & 31)) & 1u;
      tile[i] = si ? vj : vi;
      tile[j] = sj ? vi : vj;
    }
    __syncthreads();
  }
  if (in_regs) {
#pragma unroll
    for (int r = 0; r < kP1; ++r) tile[first + r] = v[r];
    __syncthreads();
  }
  for (int i = threadIdx.x; i < T; i += kBenesThreads) out[slot(i)] = tile[i];
}

// The scan's value at position src of chunk c whose positions 0..src are
// one row (the chunk's first segment), computed by one warp: the same
// steps on those slots alone.  Within the segment every step's mask is
// "position >= k", so no row offsets are read.  Up to 32 slots in
// registers (steps 32..256 then add +0, as the block's scan does there);
// longer segments in the warp's scratch, 32 slots per lane step.
__device__ float first_segment_end(const float* __restrict__ e, int c, int src,
                                   float (*scratch)[kChunk], int lane) {
  const float* ec = e + c * kChunk;
  if (src < 32) {
    float v = lane <= src ? ec[lane] : 0.0f;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const float up = __shfl_up_sync(kFullMask, v, k);
      v = __fadd_rn(v, lane >= k ? up : 0.0f);
    }
#pragma unroll
    for (int k = 32; k < kChunk; k <<= 1) v = __fadd_rn(v, 0.0f);
    return __shfl_sync(kFullMask, v, src);
  }
  for (int j = lane; j <= src; j += 32) scratch[0][j] = ec[j];
  __syncwarp();
  float* cur = scratch[0];
  float* nxt = scratch[1];
  for (int k = 1; k < kChunk; k <<= 1) {
    for (int j = lane; j <= src; j += 32) {
      nxt[j] = __fadd_rn(cur[j], j >= k ? cur[j - k] : 0.0f);
    }
    __syncwarp();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  const float v = cur[src];
  __syncwarp();  // the scratch is free for the next chunk
  return v;
}

__device__ __forceinline__ int row_at(const int* rw8, const short* row_local,
                                      int c, int pos) {
  return 128 * rw8[c] + row_local[c * kChunk + pos];
}

// A chunk holds entries iff it routes its last slot (a padding chunk
// routes nothing).
__device__ __forceinline__ bool chunk_valid(const short* row_local,
                                            const short* route_src, int c) {
  return route_src[c * kWindow + row_local[c * kChunk + kChunk - 1]] >= 0;
}

__global__ void __launch_bounds__(kChunk)
    reduce_v3_kernel(const int* __restrict__ rw8,
                     const short* __restrict__ row_local,
                     const short* __restrict__ route_src,
                     const float* __restrict__ e, float* __restrict__ y,
                     int n_chunks) {
  __shared__ float buf[2][kChunk];
  __shared__ float scratch[2][kChunk];
  __shared__ short rl[kChunk];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  // The thread's own loads (its slot and the one 32 below, the two window
  // rows it routes) travel while the block checks its chunk (two dependent
  // loads), and the warp steps use them before the check's answer is
  // needed: a padding chunk leaves before its first barrier.
  const int base = c * kChunk;
  const int rhi = row_local[base + t];
  const int src0 = route_src[c * kWindow + t];
  const int src1 = route_src[c * kWindow + kChunk + t];
  const int window = 128 * rw8[c];
  const bool valid = chunk_valid(row_local, route_src, c);
  const float v0 = warp_scan_steps(e[base + t], t >= 32 ? e[base + t - 32] : 0.0f, rhi,
                                   t >= 32 ? row_local[base + t - 32] : -1, t & 31);
  if (!valid) return;  // uniform per block
  const int head_row = row_at(rw8, row_local, c, 0);
  const int tail_row = row_at(rw8, row_local, c, kChunk - 1);
  const bool head_cont = c > 0 && row_at(rw8, row_local, c - 1, kChunk - 1) == head_row;
  const bool tail_cont = c + 1 < n_chunks &&
                         chunk_valid(row_local, route_src, c + 1) &&
                         row_at(rw8, row_local, c + 1, 0) == tail_row;
  const float* v = block_scan_steps(v0, rhi, buf, rl);

  // Rows that lie in this chunk alone: y = +0 + (+0 + segment sum).
  const int srcs[2] = {src0, src1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int src = srcs[k];
    if (src < 0) continue;
    const int row = window + t + k * kChunk;
    if ((head_cont && row == head_row) || (tail_cont && row == tail_row)) continue;
    y[row] = __fadd_rn(0.0f, v[src]);
  }

  // The row that leaves this chunk and started here: its partials from
  // this chunk and the following ones, added in chunk order; warp 0 scans
  // only each following chunk's first segment.
  if (tail_cont && !(head_cont && head_row == tail_row) && t < 32) {
    const int lane = t;
    float acc = __fadd_rn(0.0f, v[kChunk - 1]);
    int cc = c + 1;
    while (true) {
      const int src = route_src[cc * kWindow + (tail_row - 128 * rw8[cc])];
      acc = __fadd_rn(acc, __fadd_rn(0.0f, first_segment_end(e, cc, src, scratch, lane)));
      const bool more = src == kChunk - 1 && cc + 1 < n_chunks &&
                        chunk_valid(row_local, route_src, cc + 1) &&
                        row_at(rw8, row_local, cc + 1, 0) == tail_row;
      if (!more) break;
      ++cc;
    }
    if (lane == 0) y[tail_row] = acc;
  }
}

}  // namespace

extern "C" int gather_v3_f32(const void* cw8, const void* col_local,
                             const void* w, const void* x, void* e,
                             int n_slots, void* stream) {
  const int threads = 256;
  gather_v3_kernel<<<(n_slots + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cw8), static_cast<const short*>(col_local),
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<float*>(e), n_slots);
  return static_cast<int>(cudaGetLastError());
}

// The whole network on N = 2^m slots from in to out (in is not
// modified): groups holds 4 ints per group, (first stage, number of
// stages, log2 tile, log2 run), in stage order.  One launch per group.
extern "C" int benes_v3_f32(const void* masks, const void* in, void* out,
                            int m, const int* groups, int num_groups,
                            void* stream) {
  const float* src = static_cast<const float*>(in);
  for (int g = 0; g < num_groups; ++g) {
    const int* grp = groups + 4 * g;
    const int s0 = grp[0], ns = grp[1], t = grp[2], l = grp[3];
    if (t < 5 || t > m || l < 5 || l > t || ns < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = (size_t{4} << t) + size_t(ns) * ((size_t{1} << t) / 8);
    // Register mode for tiles of 8 or 16 slots per thread.
    auto kernel = (1 << t) == 8 * kBenesThreads    ? benes_group_kernel<8>
                  : (1 << t) == 16 * kBenesThreads ? benes_group_kernel<16>
                                                   : benes_group_kernel<0>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<1 << (m - t), kBenesThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(masks), src, static_cast<float*>(out), m, t, l,
        s0, ns);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = static_cast<const float*>(out);
  }
  return 0;
}

extern "C" int reduce_v3_f32(const void* rw8, const void* row_local,
                             const void* route_src, const void* e, void* y,
                             int n_chunks, void* stream) {
  reduce_v3_kernel<<<n_chunks, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rw8), static_cast<const short*>(row_local),
      static_cast<const short*>(route_src), static_cast<const float*>(e),
      static_cast<float*>(y), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_v3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
