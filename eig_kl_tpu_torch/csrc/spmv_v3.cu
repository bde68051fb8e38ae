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
// Design: simple and exact, not fast.
// * K3a: one thread per slot.  The TPU kernel selects x by a sum of masked
//   candidates starting from +0, so a -0 becomes +0 before the product:
//   e = (0 + x) * w, with explicit _rn intrinsics (no contraction).
// * K3b: one launch per stage, between two buffers (an in-place exchange
//   would race between p and p ^ d).  41 launches per SpMV at gen 1.0x;
//   both buffers (8 MB each) stay in the 50 MB L2.  Fusing the
//   short-distance stages in shared memory is later work.
// * K3c: one 512-thread block per chunk.  The scan is the TPU kernel's:
//   step k (1, 2, ..., 256) sets e[f] += (f >= k && rl[f-k] == rl[f]) ?
//   e[f-k] : +0, double-buffered in shared memory.  y must equal the TPU
//   kernel's chunk-ordered accumulation ((+0 + p1) + p2) + ... over the
//   chunks holding part of a row, so there are no atomics: a row inside
//   one chunk is written by that chunk's block; a row that crosses chunk
//   boundaries is summed, in chunk order, by the block of the chunk where
//   it starts, which scans the following chunks itself (a chunk's first
//   segment depends only on its own slots).  A row of degree > 512 spans
//   three or more chunks and takes that loop more than once.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;
constexpr int kWindow = 1024;

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

__global__ void benes_v3_kernel(const unsigned* __restrict__ mask_row,
                                const float* __restrict__ in,
                                float* __restrict__ out, int n_slots,
                                int dist) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_slots) return;
  const bool swap = (mask_row[p >> 5] >> (p & 31)) & 1u;
  out[p] = swap ? in[p ^ dist] : in[p];
}

// Segmented inclusive scan of chunk c into shared memory; returns the
// buffer that holds the result.  Every thread of the block calls it.
__device__ float* scan_chunk(const float* __restrict__ e,
                             const short* __restrict__ row_local, int c,
                             float (*buf)[kChunk], short* rl) {
  const int t = threadIdx.x;
  __syncthreads();  // the previous chunk's values are no longer read
  buf[0][t] = e[c * kChunk + t];
  rl[t] = row_local[c * kChunk + t];
  __syncthreads();
  float* cur = buf[0];
  float* nxt = buf[1];
  for (int k = 1; k < kChunk; k <<= 1) {
    const float add = (t >= k && rl[t - k] == rl[t]) ? cur[t - k] : 0.0f;
    nxt[t] = __fadd_rn(cur[t], add);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
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
  __shared__ short rl[kChunk];
  const int c = blockIdx.x;
  if (!chunk_valid(row_local, route_src, c)) return;  // uniform per block
  const int head_row = row_at(rw8, row_local, c, 0);
  const int tail_row = row_at(rw8, row_local, c, kChunk - 1);
  const bool head_cont = c > 0 && row_at(rw8, row_local, c - 1, kChunk - 1) == head_row;
  const bool tail_cont = c + 1 < n_chunks &&
                         chunk_valid(row_local, route_src, c + 1) &&
                         row_at(rw8, row_local, c + 1, 0) == tail_row;
  const float* v = scan_chunk(e, row_local, c, buf, rl);

  // Rows that lie in this chunk alone: y = +0 + (+0 + segment sum).
  for (int r = threadIdx.x; r < kWindow; r += kChunk) {
    const int src = route_src[c * kWindow + r];
    if (src < 0) continue;
    const int row = 128 * rw8[c] + r;
    if ((head_cont && row == head_row) || (tail_cont && row == tail_row)) continue;
    y[row] = __fadd_rn(0.0f, v[src]);
  }

  // The row that leaves this chunk and started here: its partials from
  // this chunk and the following ones, added in chunk order.
  if (tail_cont && !(head_cont && head_row == tail_row)) {
    float acc = __fadd_rn(0.0f, v[kChunk - 1]);
    int cc = c + 1;
    while (true) {
      const float* u = scan_chunk(e, row_local, cc, buf, rl);
      const int src = route_src[cc * kWindow + (tail_row - 128 * rw8[cc])];
      acc = __fadd_rn(acc, __fadd_rn(0.0f, u[src]));
      const bool more = src == kChunk - 1 && cc + 1 < n_chunks &&
                        chunk_valid(row_local, route_src, cc + 1) &&
                        row_at(rw8, row_local, cc + 1, 0) == tail_row;
      if (!more) break;
      ++cc;
    }
    if (threadIdx.x == 0) y[tail_row] = acc;
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

extern "C" int benes_v3_f32(const void* mask_row, const void* in, void* out,
                            int n_slots, int dist, void* stream) {
  const int threads = 256;
  benes_v3_kernel<<<(n_slots + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(mask_row), static_cast<const float*>(in),
      static_cast<float*>(out), n_slots, dist);
  return static_cast<int>(cudaGetLastError());
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
