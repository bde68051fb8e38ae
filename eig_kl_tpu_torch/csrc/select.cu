// K7: the exact rank select kth_smallest (kth_smallest_f32, kth_smallest_f64):
// out = sort(v)[k] for a float32 or float64 vector v of n values, without a
// sort, in one launch, the result left on the card.  Replaces
// eig_kl_tpu/ops/select.py:kth_smallest (:118; the bit search
// _kth_key_bits, :53, and the radix select _kth_key_radix, :68): plain XLA,
// not Pallas, but the select of every median on the main path.
//
// Keys: the bits b of each value as an unsigned integer, ~b where the sign
// bit is set, else b with the sign bit flipped (_f32_keys, :42, on 32 or 64
// bits); their unsigned order is the float order, -0.0 just below +0.0, a
// NaN above +inf or, with its sign bit set, below -inf.
//
// Design: a radix select of 8-bit digits from the top, at most 4 rounds in
// f32 and 8 in f64.  Each round counts the digit of every key whose higher
// digits equal the resolved prefix into a 256-bin histogram in shared memory
// (the lanes of a warp that hold one digit add once, __match_any_sync), then
// one warp scans the 256 totals and picks the bin that holds rank k_left.
// The rounds stop early where that bin holds one key: it is the key of rank
// k, and the thread that holds it writes its value.  Two forms:
//
// * up to kSmallMax values (gen 0.02x's 4,038 among them): one block of
//   1,024 threads in a plain launch, each thread's keys read once into
//   registers, one histogram a round (two, zeroed in turns), two block
//   barriers a round;
// * above: a cooperative grid of up to one block per SM (all blocks
//   resident at once, which the cooperative launch guarantees).  Each round
//   every block reads its share of v, 8 loads in flight per thread (the
//   vector stays in L2 after the first round), counts into its warps'
//   histograms, adds its 256 sums into the round's histogram in global
//   memory, and the grid meets at a barrier (a counter in global memory);
//   then every block reads the 256 totals and picks the same digit, so no
//   second barrier.  The last block to finish zeroes the histograms and the
//   counters for the next launch on the stream (they share the scratch).  A
//   barrier that waits past a few seconds traps: a launch error, not a hang.
//
// Counts are integers, so the result does not depend on the schedule: it is
// the key of rank k, the same as the bit search's.  With K7_STAMPS defined
// (tools/k7_phases.py) thread 0 of block 0 stamps its clock at each phase.
//
// Bound on this card: bytes.  One read of v and one write of the result:
// 0.8 MB at 201,920 f32 values, 0.24 us at 3.35 TB/s (f64 0.48 us).  Each
// round of the grid form re-reads v from L2 and ends in a grid barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kUnroll = 8;        // loads in flight per thread (grid form)
constexpr int kPerBlock = 2048;   // values per block at least (the grid's size)
#ifndef K7_SMALL_MAX
#define K7_SMALL_MAX 8192
#endif
constexpr int kSmallMax = K7_SMALL_MAX;  // the one-block form up to here
constexpr int kPerThread = 8;            // its keys in registers per thread
static_assert(kSmallMax <= kThreads * kPerThread, "the one-block form holds 8 keys a thread");
constexpr int kMaxRounds = 8;     // f64
// Scratch layout (unsigned ints): kMaxRounds histograms, the barrier count,
// the finished-block count.
constexpr int kBarrier = kMaxRounds * kBins;
constexpr int kDone = kBarrier + 1;
constexpr int kScratch = kDone + 1;

// Stamps (K7_STAMPS): slot 0 the start, 1 + 3r round r counted, 2 + 3r its
// totals merged (grid form), 3 + 3r its digit picked, 25 the result written;
// clock64 cycles.  Slots 26 and 27: %globaltimer at the start and the end.
#ifdef K7_STAMPS
__device__ unsigned long long* k7_stamps;
__device__ __forceinline__ void k7_stamp(int slot) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    k7_stamps[slot] = clock64();
    if (slot == 0 || slot == 25) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      k7_stamps[slot == 0 ? 26 : 27] = t;
    }
  }
}
#else
__device__ __forceinline__ void k7_stamp(int) {}
#endif

template <typename T>
struct KeyOf;

template <>
struct KeyOf<float> {
  using K = uint32_t;
  static __device__ K key(float v) {
    const K b = __float_as_uint(v);
    return (b & 0x80000000u) ? ~b : (b ^ 0x80000000u);
  }
  static __device__ float value(K key) {
    return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
  }
};

template <>
struct KeyOf<double> {
  using K = unsigned long long;
  static __device__ K key(double v) {
    const K b = static_cast<K>(__double_as_longlong(v));
    return (b & 0x8000000000000000ull) ? ~b : (b ^ 0x8000000000000000ull);
  }
  static __device__ double value(K key) {
    const K b = (key & 0x8000000000000000ull) ? (key ^ 0x8000000000000000ull) : ~key;
    return __longlong_as_double(static_cast<long long>(b));
  }
};

// Every block waits until `target` blocks have arrived at the counter.
__device__ void grid_barrier(unsigned int* count, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned int spins = 0;
    while (atomicAdd(count, 0u) < target) {
      __nanosleep(64);
      if (++spins > (1u << 22)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Warp 0: pick the bin of rank k_left among the 256 totals; the prefix
// gains its digit, k_left loses the keys below, `single` says whether the
// bin holds one key.  Lane l holds bins 8l .. 8l + 7.
template <typename Key>
__device__ void pick_digit(const unsigned int* total, int shift, Key& prefix, int& k_left, bool& single) {
  const int lane = threadIdx.x & 31;
  unsigned int mine = 0;
  for (int b = 0; b < 8; ++b) mine += total[8 * lane + b];
  unsigned int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  unsigned int below = incl - mine;
  const unsigned int kl = static_cast<unsigned int>(k_left);
  if (below <= kl && kl < incl) {
    int b = 8 * lane;
    while (below + total[b] <= kl) below += total[b++];
    prefix |= Key(b) << shift;
    k_left = static_cast<int>(kl - below);
    single = total[b] == 1;
  }
}

// Count one key's digit into `hist` (all lanes of the warp call it).
__device__ __forceinline__ void count_digit(unsigned int* hist, bool keep, unsigned int digit) {
  const unsigned int voters = __ballot_sync(0xffffffffu, keep);
  if (keep) {
    const unsigned int same = __match_any_sync(voters, digit);
    if ((threadIdx.x & 31) == __ffs(same) - 1) atomicAdd(hist + digit, __popc(same));
  }
}

// The digits above round `round`'s (shift = its lowest bit): all resolved.
template <typename Key>
__device__ __forceinline__ Key high_mask(int round, int shift) {
  return round == 0 ? Key(0) : ~((Key(1) << (shift + 8)) - 1);
}

// The one-block form: n <= kSmallMax, keys in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
kth_small_kernel(const T* __restrict__ v, int n, int k, T* __restrict__ out) {
  using Key = typename KeyOf<T>::K;
  constexpr int kKeyBits = 8 * sizeof(Key);
  constexpr int kRounds = kKeyBits / 8;
  __shared__ unsigned int hist[2][kBins];
  __shared__ Key prefix_s;
  __shared__ int k_left_s;
  __shared__ bool single_s;
  const int t = threadIdx.x;
  k7_stamp(0);
  Key key[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = u * kThreads + t;
    key[u] = i < n ? KeyOf<T>::key(__ldg(v + i)) : Key(0);
  }
  if (t < kBins) hist[0][t] = hist[1][t] = 0;
  if (t == 0) {
    prefix_s = 0;
    k_left_s = k;
    single_s = false;
  }
  __syncthreads();
  int round = 0, shift = kKeyBits - 8;
  for (; round < kRounds; ++round, shift -= 8) {
    const Key prefix = prefix_s;
    const Key high = high_mask<Key>(round, shift);
    unsigned int* h = hist[round & 1];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if (u * kThreads >= n) break;  // the same for the whole block
      const bool keep = u * kThreads + t < n && (key[u] & high) == prefix;
      count_digit(h, keep, static_cast<unsigned int>(key[u] >> shift) & (kBins - 1));
    }
    __syncthreads();
    k7_stamp(1 + 3 * round);
    if (t < 32) {
      pick_digit(h, shift, prefix_s, k_left_s, single_s);
    } else if (t < 32 + kBins) {
      hist[(round + 1) & 1][t - 32] = 0;  // the next round's histogram
    }
    __syncthreads();
    k7_stamp(3 + 3 * round);
    if (single_s) break;
  }
  if (round < kRounds) {
    // The bin of rank k held one key: the thread holding it writes it.
    const Key mask = ~((Key(1) << shift) - 1);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if (u * kThreads + t < n && (key[u] & mask) == prefix_s) *out = KeyOf<T>::value(key[u]);
    }
  } else if (t == 0) {
    *out = KeyOf<T>::value(prefix_s);
  }
  k7_stamp(25);
}

// The grid form: a cooperative launch of `gridDim.x` blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
kth_smallest_kernel(const T* __restrict__ v, int n, int k, T* __restrict__ out,
                    unsigned int* __restrict__ scratch) {
  using Key = typename KeyOf<T>::K;
  constexpr int kKeyBits = 8 * sizeof(Key);
  constexpr int kRounds = kKeyBits / 8;
  __shared__ unsigned int hist[kWarps][kBins];
  __shared__ unsigned int total[kBins];
  __shared__ Key prefix_s;
  __shared__ int k_left_s;
  __shared__ bool single_s;
  const int t = threadIdx.x, warp = t >> 5;
  const int stride = gridDim.x * kThreads;
  k7_stamp(0);
  if (t == 0) {
    prefix_s = 0;
    k_left_s = k;
    single_s = false;
  }
  int round = 0, shift = kKeyBits - 8;
  for (; round < kRounds; ++round, shift -= 8) {
    for (int i = t; i < kWarps * kBins; i += kThreads) (&hist[0][0])[i] = 0;
    __syncthreads();
    const Key prefix = prefix_s;
    const Key high = high_mask<Key>(round, shift);
    for (int base = blockIdx.x * kThreads; base < n; base += stride * kUnroll) {
      T x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * stride + t;
        x[u] = i < n ? __ldg(v + i) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Key key = KeyOf<T>::key(x[u]);
        const bool keep = base + u * stride + t < n && (key & high) == prefix;
        count_digit(hist[warp], keep, static_cast<unsigned int>(key >> shift) & (kBins - 1));
      }
    }
    __syncthreads();
    k7_stamp(1 + 3 * round);
    unsigned int* ghist = scratch + round * kBins;
    if (t < kBins) {
      unsigned int s = 0;
      for (int w = 0; w < kWarps; ++w) s += hist[w][t];
      if (s) atomicAdd(ghist + t, s);
    }
    grid_barrier(scratch + kBarrier, (round + 1) * gridDim.x);
    if (t < kBins) total[t] = __ldcg(ghist + t);
    __syncthreads();
    k7_stamp(2 + 3 * round);
    if (warp == 0) pick_digit(total, shift, prefix_s, k_left_s, single_s);
    __syncthreads();
    k7_stamp(3 + 3 * round);
    if (single_s) break;
  }
  if (round < kRounds) {
    // The bin of rank k held one key: the thread holding it writes it.
    const Key mask = ~((Key(1) << shift) - 1);
    for (int i = blockIdx.x * kThreads + t; i < n; i += stride) {
      const T x = __ldg(v + i);
      if ((KeyOf<T>::key(x) & mask) == prefix_s) *out = x;
    }
  } else if (blockIdx.x == 0 && t == 0) {
    *out = KeyOf<T>::value(prefix_s);
  }
  k7_stamp(25);
  // Every block has read every histogram: the last one to get here leaves
  // the scratch zeroed for the next launch, all its threads at once.
  __shared__ bool last;
  if (t == 0) {
    __threadfence();
    last = atomicAdd(scratch + kDone, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    for (int i = t; i < kRounds * kBins; i += kThreads) scratch[i] = 0;
    if (t == 0) {
      scratch[kBarrier] = 0;
      scratch[kDone] = 0;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename T>
int kth_smallest(const void* v, int n, int k, void* out, void* scratch, void* stream) {
  if (n > 0 && k >= 0 && k < n) {
    const T* vp = static_cast<const T*>(v);
    T* op = static_cast<T*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    if (n <= kSmallMax) {
      kth_small_kernel<T><<<1, kThreads, 0, st>>>(vp, n, k, op);
      return static_cast<int>(cudaGetLastError());
    }
    const int sms = sm_count();
    if (sms <= 0) return static_cast<int>(cudaGetLastError());
    int blocks = (n + kPerBlock - 1) / kPerBlock;
    blocks = blocks < sms ? blocks : sms;
    unsigned int* sp = static_cast<unsigned int*>(scratch);
    void* args[] = {&vp, &n, &k, &op, &sp};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&kth_smallest_kernel<T>), dim3(blocks), dim3(kThreads), args, 0, st));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: kScratch unsigned ints (ops/select.py:K7_SCRATCH_WORDS), zero
// before the first launch on a stream; every launch leaves it zero.
extern "C" int kth_smallest_f32(const void* v, int n, int k, void* out, void* scratch, void* stream) {
  return kth_smallest<float>(v, n, k, out, scratch, stream);
}

extern "C" int kth_smallest_f64(const void* v, int n, int k, void* out, void* scratch, void* stream) {
  return kth_smallest<double>(v, n, k, out, scratch, stream);
}

extern "C" const char* select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef K7_STAMPS
extern "C" int k7_set_stamps(void* p) {
  cudaMemcpyToSymbol(k7_stamps, &p, sizeof(p));
  return static_cast<int>(cudaGetLastError());
}
#endif
