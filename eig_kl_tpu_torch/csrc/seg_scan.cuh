// The segmented Hillis-Steele scan of the TPU SpMV kernels over a chunk of
// 512 slots, as one 512-thread block runs it: step k (1, 2, ..., 256) sets
// e[f] += (f >= k && rl[f-k] == rl[f]) ? e[f-k] : +0, from the values of
// the step before (that +0 add turns a -0 into +0; the bits depend on it).
// Steps 1..16 run within each warp, in registers and shuffles, with a halo
// of the 32 slots below the warp that the warp recomputes; steps 32..256 in
// shared memory, double-buffered, one block barrier each.  The v3 reduce
// (spmv_v3.cu, K3c) and the v1 SpMV (spmv_csr.cu:spmv_v1_f32) both take it.
#pragma once

namespace seg_scan {

constexpr int kChunk = 512;
constexpr unsigned kFullMask = 0xffffffffu;

// Steps 1..16 of the segmented scan within one warp.  Lane l holds chunk
// position p = 32w + l (hi, row rhi) and the position 32 slots below it
// (lo, row rlo; below the chunk: 0 and row -1, which no real row equals).
// Step k adds to every position the value k slots below it if that lies in
// the same row, else +0, from the values of the step before.  For hi at a
// lane l < k that value is lo's at lane l - k + 32, which is right after
// steps 1..k/2 because it needs nothing below the warp's 64 positions
// (32 - k >= k - 1 for k <= 16).  Returns hi after step 16.
__device__ __forceinline__ float warp_scan_steps(float hi, float lo, int rhi,
                                                 int rlo, int lane) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int src = (lane - k) & 31;
    const float hi_s = __shfl_sync(kFullMask, hi, src);
    const float lo_s = __shfl_sync(kFullMask, lo, src);
    const int rhi_s = __shfl_sync(kFullMask, rhi, src);
    const int rlo_s = __shfl_sync(kFullMask, rlo, src);
    const bool in_warp = lane >= k;
    const float up = in_warp ? hi_s : lo_s;
    const int r_up = in_warp ? rhi_s : rlo_s;
    hi = __fadd_rn(hi, r_up == rhi ? up : 0.0f);
    lo = __fadd_rn(lo, (in_warp && rlo_s == rlo) ? lo_s : 0.0f);
  }
  return hi;
}

// Steps 32..256 of the segmented scan of a chunk, after warp_scan_steps
// gave thread t its slot's value v (row rhi): in shared memory,
// double-buffered, one block barrier each.  Returns the buffer that holds
// the result; rl then holds the chunk's rows.  Every thread of the block
// calls it, once.
__device__ __forceinline__ float* block_scan_steps(float v, int rhi, float (*buf)[kChunk], short* rl) {
  const int t = threadIdx.x;
  buf[0][t] = v;
  rl[t] = static_cast<short>(rhi);
  __syncthreads();
  float* cur = buf[0];
  float* nxt = buf[1];
  for (int k = 32; k < kChunk; k <<= 1) {
    v = __fadd_rn(v, (t >= k && rl[t - k] == rhi) ? cur[t - k] : 0.0f);
    nxt[t] = v;
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

}  // namespace seg_scan
