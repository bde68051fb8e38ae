// K2: S independent KL passes in one launch, one persistent thread block
// per start, in float32.
//
// Replaces eig_kl_tpu/kl/megakernel.py:_kernel (:144) in both its forms:
// batched (launched by _run_batched, :602, the pallas_call at :638, a grid
// over the starts) and single-start (launched by _run, :507), which is
// S = 1 of the same kernel here.  Per start: first-max selection per side,
// the two row updates of A@s, the lock, the Kahan-summed cut, the four swap
// logs and the termination rule.  Each start brings its own cut0, best0
// (the best cut of earlier chunks of the same pass), cap and term0 (the
// termination count carried in), so a pass can be re-entered after a
// from-scratch refresh of A@s (megakernel.py:459-468, :1207).
//
// Bound on this card: latency.  The swap chain is serial (each selection
// reads the state the previous swap wrote), as the TPU kernel's single
// core makes it.  Each swap's flat selection scan reads sf and a_s once,
// 8 bytes per node (1.6 MB at gen 1.0x), from L2 into one SM, followed by
// two block-wide reductions, two row updates and four barriers.  Counted
// once per call, the bytes the pass must move (CSR, sf, a_s, logs) take
// microseconds at 3.35 TB/s; the chain of some ten thousand dependent
// swaps, each paying L2 and barrier latency, is what takes the time.
// Starts share nothing but the read-only graph, so S blocks run side by
// side on S of the card's SMs (and queue beyond that); what they compete
// for is L2: 8 bytes per node and start of state, scanned once per swap.
//
// Design:
// * Grid: blockIdx.x is the start.  Blocks never talk to each other (no
//   atomics, no grid sync), so a start's bits do not depend on S or on the
//   other starts, and S may exceed the number of SMs.  The per-start
//   parameters are read from device arrays, so a batch is launched without
//   the host ever reading a cut.
// * State: sf = side sign * free (0 = locked or padding) and a_s = A@s,
//   both f32 in global memory, one stripe per start (1.6 MB per start at
//   gen 1.0x, resident in L2 while the batch's stripes fit there).  The
//   node count is padded to a multiple of 4 with sf = 0 so the scan reads
//   float4s.
// * Selection: each thread scans its nodes in increasing order, keeping a
//   strict-> first maximum of D = -(sf * a_s) over sf > 0 and over sf < 0;
//   warp shuffles and one shared-memory round combine (value, index) pairs
//   by "larger value, or equal value (+0 == -0) at a lower index".  That
//   is the TPU kernel's first maximum, in both its flat form and its
//   hierarchical form (megakernel.py:313-351), and torch.argmax's.
// * Row updates: row a's entries add -2*s_a*w into a_s in parallel, then a
//   barrier, then row b's (megakernel.py:385-415's order); neighbours in
//   one row are distinct, so no two threads touch one entry.  The thread
//   that meets b in row a records w_ab.
// * Bookkeeping on thread 0: lock both nodes, gain = m_l + m_r - 2*w_ab,
//   Kahan-compensated cut (megakernel.py:424-431), the four logs written
//   straight to global memory at index it, and the termination counter
//   (gain <= gain_eps counts; stop when it exceeds terminate_limit).
// * Every add and multiply is explicitly rounded (no FMA contraction), so
//   the pass reproduces the plain PyTorch version's bits.
// The TPU kernel's per-row max cache (megakernel.py:265-324) is a later
// optimisation: it would cut the per-swap scan from n to n/128 values.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ int warp_sum(int c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(kFull, c, off);
  return c;
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

// Adds coef * w into a_s over one CSR row; returns nothing, records w_ab.
__device__ __forceinline__ void update_row(const int* indptr, const int* indices,
                                           const float* data, float* as, int row,
                                           float coef, int b, float* wab) {
  const int lo = indptr[row];
  const int deg = indptr[row + 1] - lo;
  for (int k = threadIdx.x; k < deg; k += kThreads) {
    const int j = indices[lo + k];
    const float w = data[lo + k];
    as[j] = __fadd_rn(as[j], __fmul_rn(coef, w));
    if (wab != nullptr && j == b) *wab = w;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    kl_pass_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                   const float* __restrict__ data, float* sf_all, float* as_all,
                   int n4, const float* __restrict__ cut0s,
                   const float* __restrict__ best0s, const int* __restrict__ caps,
                   const int* __restrict__ term0s, int terminate_limit,
                   float gain_eps, int log_len, float* __restrict__ log_cut_all,
                   float* __restrict__ log_gain_all, int* __restrict__ log_a_all,
                   int* __restrict__ log_b_all, float* __restrict__ out_all) {
  // This block's start: its state stripe, its logs, its parameters.
  const size_t start = blockIdx.x;
  float* sf = sf_all + start * 4 * static_cast<size_t>(n4);
  float* as = as_all + start * 4 * static_cast<size_t>(n4);
  float* log_cut = log_cut_all + start * log_len;
  float* log_gain = log_gain_all + start * log_len;
  int* log_a = log_a_all + start * log_len;
  int* log_b = log_b_all + start * log_len;
  float* out = out_all + start * 8;
  const float cut0 = cut0s[start];
  const int cap = caps[start];

  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ int cnt[2][kWarps];
  __shared__ int sh_a, sh_b, sh_go;
  __shared__ float sh_ml, sh_mr, sh_wab;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* sf4 = reinterpret_cast<const float4*>(sf);
  const float4* as4 = reinterpret_cast<const float4*>(as);

  // Free nodes per side at the start (padding has sf = 0).
  int c0 = 0, c1 = 0;
  for (int q = tid; q < n4; q += kThreads) {
    const float4 f = sf4[q];
    c0 += (f.x > 0.0f) + (f.y > 0.0f) + (f.z > 0.0f) + (f.w > 0.0f);
    c1 += (f.x < 0.0f) + (f.y < 0.0f) + (f.z < 0.0f) + (f.w < 0.0f);
  }
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  if (lane == 0) {
    cnt[0][warp] = c0;
    cnt[1][warp] = c1;
  }
  __syncthreads();

  // The scalar state lives in thread 0's registers.
  int it = 0, term = 0, stop = 0, nf0 = 0, nf1 = 0;
  float cut = cut0, comp = 0.0f, best = cut0;
  if (tid == 0) {
    best = fminf(cut0, best0s[start]);
    term = term0s[start];
    log_cut[0] = cut0;
    for (int w = 0; w < kWarps; ++w) {
      nf0 += cnt[0][w];
      nf1 += cnt[1][w];
    }
    sh_go = it < cap && nf0 > 0 && nf1 > 0;
  }
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  while (sh_go) {
    // Selection: first maximum of D per side.
    float vl = neg_inf, vr = neg_inf;
    int il = INT_MAX, ir = INT_MAX;
#pragma unroll 4
    for (int q = tid; q < n4; q += kThreads) {
      const float4 f = sf4[q];
      const float4 a = as4[q];
      const int base = 4 * q;
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
      if (lane == 0) {
        sh_a = il;
        sh_ml = vl;
        sh_b = ir;
        sh_mr = vr;
        sh_wab = 0.0f;
      }
    }
    __syncthreads();

    // Row updates: all of row a, then all of row b.  The chosen nodes are
    // free, so sf holds their signs.
    const int a = sh_a;
    const int b = sh_b;
    const float coef_a = __fmul_rn(-2.0f, sf[a]);
    const float coef_b = __fmul_rn(-2.0f, sf[b]);
    update_row(indptr, indices, data, as, a, coef_a, b, &sh_wab);
    __syncthreads();
    update_row(indptr, indices, data, as, b, coef_b, b, nullptr);

    if (tid == 0) {
      sf[a] = 0.0f;
      sf[b] = 0.0f;
      const float gain =
          __fsub_rn(__fadd_rn(sh_ml, sh_mr), __fmul_rn(2.0f, sh_wab));
      const float y = __fsub_rn(-gain, comp);
      const float t = __fadd_rn(cut, y);
      comp = __fsub_rn(__fsub_rn(t, cut), y);
      cut = t;
      best = fminf(cut, best);
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
  }

  if (tid == 0) {
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

}  // namespace

// sf and a_s hold num_starts stripes of n_padded floats (a multiple of 4)
// and are updated in place; cut0, best0 (float) and cap, term0 (int) hold
// one value per start; each log holds num_starts stripes of log_len entries
// (log_len > every cap), of which a pass writes 0..iterations; out receives
// 8 scalars per start, those of megakernel.py:486-494.
extern "C" int kl_pass_f32(const void* indptr, const void* indices,
                           const void* data, void* sf, void* as, int n_padded,
                           int num_starts, const void* cut0, const void* best0,
                           const void* cap, const void* term0,
                           int terminate_limit, float gain_eps, int log_len,
                           void* log_cut, void* log_gain, void* log_a,
                           void* log_b, void* out, void* stream) {
  if (n_padded % 4 != 0 || num_starts < 1 || log_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kl_pass_kernel<<<num_starts, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const float*>(data), static_cast<float*>(sf),
      static_cast<float*>(as), n_padded / 4, static_cast<const float*>(cut0),
      static_cast<const float*>(best0), static_cast<const int*>(cap),
      static_cast<const int*>(term0), terminate_limit, gain_eps, log_len,
      static_cast<float*>(log_cut), static_cast<float*>(log_gain),
      static_cast<int*>(log_a), static_cast<int*>(log_b),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kl_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
