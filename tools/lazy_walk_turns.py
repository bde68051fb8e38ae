"""The earlier design of the two lazy walks of ``csrc/spmv_csr.cu``, built
from the strings below and timed beside the kernels in one process, in
turns (new, earlier, earlier, new), on the same inputs, with equal bits:

* ``lazy_walk_earlier_f32`` / ``_f64``: K1's ELL lazy walk as it gathered
  ``dsinv[j] * w[j]`` per entry (``GatherScaled``), two random gathers per
  entry;
* ``lazy_walk_v2[_mxu2 | _vpu][_bf16i | _bf16w]_earlier_f32``: the v2
  order's lazy walks from the v2 template as it multiplied
  ``dsinv[j] * x[j]`` in its gather (and in its COO tail's).

The kernels now gather ``z = dsinv * w``, made once per node beforehand
(``ops/rescale.py:lazy_rescale``, ``lazy_z``); both designs give the same bits.
The source includes ``csrc/spmv_csr.cu`` for what the walks share and did
not change (the row walk ``row_sum``, the block shape, the bf16 products),
then adds the earlier kernels verbatim under their own names.  Each entry
point takes the arguments of the port's entry point it stands beside, ``z``
among them, and ignores ``z``.  Nothing here is imported by the port.
Run on a machine with one CUDA card (``nvcc`` on the path or under
``/usr/local/cuda``)::

    python3 tools/lazy_walk_turns.py [--calls N]

It builds the port's kernels and the earlier designs, then times every
lazy walk given z at the shapes ``chip_smoke.py`` holds it: the ELL walk
(f32, f64) on the KL graph of gen 1.0x's largest component (184,406
nodes), the v2 order's forms ("mxu" and "vpu"; f32, bf16 products, bf16
weights) on gen 1.0x's padded state (row block 16,384), and the "mxu2"
forms on the 6,000-node graph at row block 512.  Device microseconds per
launch come from the profiler, ``N`` launches (default 50) per turn.  It
prints the card's name and power limit, a line per walk, and last one
JSON object of them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "eig_kl_tpu_torch" / "_build" / "turns"
CSRC = REPO / "eig_kl_tpu_torch" / "csrc"

#: K1's ELL lazy walk as it stood, with its gather, verbatim under its own name.
ELL = r"""
template <class T>
struct GatherScaled {
  const T* __restrict__ w;
  const T* __restrict__ s;
  __device__ __forceinline__ T operator()(int j) const {
    return mul_rn(__ldg(s + j), __ldg(w + j));
  }
};

template <class T>
__global__ void __launch_bounds__(kThreads)
    lazy_walk_earlier_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                     const T* __restrict__ data, const T* __restrict__ w,
                     const T* __restrict__ dsinv, const T* __restrict__ u,
                     const T* __restrict__ c, T* __restrict__ y, int n, int row_width) {
  int r0;
  T* buf = warp_buffer<T>(row_width, r0);
  if (r0 >= n) return;
  const int row = r0 + (threadIdx.x & 31);
  const T wr = __ldg(w + min(row, n - 1));
  const T sr = __ldg(dsinv + min(row, n - 1));
  const T ax = row_sum(indptr, indices, data, GatherScaled<T>{w, dsinv}, buf, r0, n, row_width);
  if (row >= n) return;
  if (u != nullptr) {
    // w = u * c, recomputed in the epilogue: its product is the one fused.
    y[row] = mul_rn(T(0.5), mul_add(__ldg(u + row), __ldg(c), mul_rn(sr, ax)));
  } else {
    y[row] = mul_rn(T(0.5), mul_add(sr, ax, wr));
  }
}
"""

#: The v2 template as it stood, verbatim under its own name.
V2 = r"""
template <bool kBf16, bool kLazy, int kReduce, class TW>
__global__ void __launch_bounds__(kThreads)
spmv_v2_earlier_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
               const TW* __restrict__ w, const short* __restrict__ slot, int shift, int lanes,
               const int* __restrict__ tail_warp,
               const int* __restrict__ tail_rows, const int* __restrict__ tail_cols,
               const float* __restrict__ tail_w, const float* __restrict__ tail_y,
               const float* __restrict__ x,
               const float* __restrict__ dsinv, float* __restrict__ y, int n, int rows) {
  static_assert(kBf16 || std::is_same_v<TW, float>, "bf16 weights come with bf16 products");
  constexpr int kSlotBits = kReduce == kV2Seq ? 0 : 9;
  __shared__ float e_s[kWarps][kV2Chunk];
  __shared__ int g_s[kWarps][kV2Chunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= rows) return;
  const int row = r0 + lane;
  auto gather = [&](int j) {
    if constexpr (kLazy) {
      return __fmul_rn(__ldg(dsinv + j), __ldg(x + j));
    } else {
      return __ldg(x + j);
    }
  };
  float sum = 0.0f;
  if (r0 < n) {  // whole warps: the __syncwarp calls below see every lane
    const int lo = __ldg(ptr + min(row, n - 1));
    const int hi = row < n ? __ldg(ptr + min(row, n - 1) + 1) : lo;
    const int span_lo = __ldg(ptr + r0);
    const int span_hi = __ldg(ptr + min(r0 + 32, n));
    const int t_lo = tail_warp != nullptr ? __ldg(tail_warp + (r0 >> 5)) : 0;
    const int t_hi = tail_warp != nullptr ? __ldg(tail_warp + (r0 >> 5) + 1) : 0;
    // The partials of the current sub-chunk: part (kV2Lanes: p0 .. p3, one
    // per slot % lanes; kV2Blocks: the block sums so far, blk the current
    // 32-slot block's).
    float part = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f, blk = 0.0f;
    int group = -1;  // the first entry's flush adds +0 to +0
    int block = -1;
    auto flush = [&]() {
      if constexpr (kReduce == kV2Lanes) {
        const float pair = __fadd_rn(part, p1);
        sum = __fadd_rn(sum, lanes == 4 ? __fadd_rn(pair, __fadd_rn(p2, p3)) : pair);
        p1 = p2 = p3 = 0.0f;
      } else if constexpr (kReduce == kV2Blocks) {
        sum = __fadd_rn(sum, __fadd_rn(part, blk));
        blk = 0.0f;
      } else {
        sum = __fadd_rn(sum, part);
      }
      part = 0.0f;
    };
    for (int c0 = span_lo; c0 < span_hi; c0 += kV2Chunk) {
      const int len = min(kV2Chunk, span_hi - c0);
      int col[kPerLane];
      int sl[kPerLane];
      float wt[kPerLane];
      float xg[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = min(lane + 32 * q, len - 1);
        col[q] = __ldg(cols + c0 + i);
        wt[q] = weight(w + c0 + i);
        if constexpr (kReduce != kV2Seq) sl[q] = __ldg(slot + c0 + i);
      }
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) xg[q] = gather(col[q]);
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = lane + 32 * q;
        if (i < len) {
          e_s[warp][i] = product<kBf16>(wt[q], xg[q]);
          int key = col[q] >> shift;
          if constexpr (kReduce != kV2Seq) key = (key << kSlotBits) | sl[q];
          g_s[warp][i] = key;
        }
      }
      __syncwarp();
      const int ke = min(hi, c0 + len);
      for (int k = max(lo, c0); k < ke; ++k) {
        const int gs = g_s[warp][k - c0];
        const int gk = gs >> kSlotBits;
        const float e = e_s[warp][k - c0];
        if (gk != group) {
          flush();
          group = gk;
          block = -1;
        }
        if constexpr (kReduce == kV2Lanes) {
          // Each partial adds e or +0: a partial from +0 is never -0, so
          // the +0 adds move no bit, and no lane branches on the class.
          const int cls = gs & (lanes - 1);
          part = __fadd_rn(part, cls == 0 ? e : 0.0f);
          p1 = __fadd_rn(p1, cls == 1 ? e : 0.0f);
          p2 = __fadd_rn(p2, cls == 2 ? e : 0.0f);
          p3 = __fadd_rn(p3, cls == 3 ? e : 0.0f);
        } else if constexpr (kReduce == kV2Blocks) {
          const int b = (gs & 511) >> 5;
          if (b != block) {
            part = __fadd_rn(part, blk);
            blk = 0.0f;
            block = b;
          }
          blk = __fadd_rn(blk, e);
        } else {
          part = __fadd_rn(part, e);
        }
      }
      __syncwarp();
    }
    flush();
    if (row < n && tail_y != nullptr) {
      sum = __fadd_rn(sum, __ldg(tail_y + row));
    } else {
      for (int k = t_lo; k < t_hi; ++k) {
        if (__ldg(tail_rows + k) == row) {
          sum = __fadd_rn(sum, __fmul_rn(__ldg(tail_w + k), gather(__ldg(tail_cols + k))));
        }
      }
    }
  }
  if (row >= rows) return;
  if constexpr (kLazy) {
    y[row] = __fmul_rn(0.5f, __fmaf_rn(__ldg(dsinv + row), sum, __ldg(x + row)));
  } else {
    y[row] = sum;
  }
}
"""

SOURCE = r"""
#include "spmv_csr.cu"

namespace {

__ELL__
__V2__
}  // namespace

#define ELL_EARLIER(NAME, T)                                                                            \
  extern "C" int NAME(const void* indptr, const void* indices, const void* data, const void* w,         \
                      const void* z, const void* dsinv, const void* u, const void* c, void* y, int n,   \
                      int row_width, void* stream) {                                                    \
    if ((u == nullptr) != (c == nullptr)) return static_cast<int>(cudaErrorInvalidValue);               \
    if (n > 0) {                                                                                        \
      lazy_walk_earlier_kernel<T><<<blocks_for(n), kThreads, shared_bytes<T>(row_width),                \
                                    static_cast<cudaStream_t>(stream)>>>(                               \
          static_cast<const int*>(indptr), static_cast<const int*>(indices),                            \
          static_cast<const T*>(data), static_cast<const T*>(w), static_cast<const T*>(dsinv),          \
          static_cast<const T*>(u), static_cast<const T*>(c), static_cast<T*>(y), n, row_width);        \
    }                                                                                                   \
    return static_cast<int>(cudaGetLastError());                                                        \
  }

ELL_EARLIER(lazy_walk_earlier_f32, float)
ELL_EARLIER(lazy_walk_earlier_f64, double)

#define V2_EARLIER(NAME, BF16, REDUCE, TW)                                                                  \
  extern "C" int NAME(const void* ptr, const void* cols, const void* w, const void* slot, int shift,        \
                      int lanes, const void* tail_warp, const void* tail_rows, const void* tail_cols,       \
                      const void* tail_w, const void* tail_y, const void* x, const void* z,                 \
                      const void* dsinv, void* y, int n, int rows, void* stream) {                          \
    if (rows > 0) {                                                                                         \
      spmv_v2_earlier_kernel<BF16, true, REDUCE, TW><<<blocks_for(rows), kThreads, 0,                       \
                                                      static_cast<cudaStream_t>(stream)>>>(                 \
          static_cast<const int*>(ptr), static_cast<const int*>(cols), static_cast<const TW*>(w),           \
          static_cast<const short*>(slot), shift, lanes, static_cast<const int*>(tail_warp),                \
          static_cast<const int*>(tail_rows), static_cast<const int*>(tail_cols),                           \
          static_cast<const float*>(tail_w), static_cast<const float*>(tail_y),                             \
          static_cast<const float*>(x), static_cast<const float*>(dsinv), static_cast<float*>(y), n, rows); \
    }                                                                                                       \
    return static_cast<int>(cudaGetLastError());                                                            \
  }

#define V2_EARLIER_FORMS(NAME, REDUCE)                                  \
  V2_EARLIER(NAME##_earlier_f32, false, REDUCE, float)                  \
  V2_EARLIER(NAME##_bf16i_earlier_f32, true, REDUCE, float)             \
  V2_EARLIER(NAME##_bf16w_earlier_f32, true, REDUCE, __nv_bfloat16)

V2_EARLIER_FORMS(lazy_walk_v2, kV2Seq)
V2_EARLIER_FORMS(lazy_walk_v2_mxu2, kV2Lanes)
V2_EARLIER_FORMS(lazy_walk_v2_vpu, kV2Blocks)
""".replace("__ELL__", ELL).replace("__V2__", V2)


def build() -> ctypes.CDLL:
    """Build the earlier designs as ``_build/turns/lazy_walk_earlier.so``
    with the port's nvcc flags (ops/_build.py) and load it."""
    from eig_kl_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "lazy_walk_earlier.cu", OUT / "lazy_walk_earlier.so"
    src.write_text(SOURCE)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"building {src} failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib))


def earlier_symbol(kernel_symbol: str) -> str:
    """The earlier design's symbol beside the port's lazy walk
    ``kernel_symbol`` (``lazy_walk_v2_bf16i_f32`` ->
    ``lazy_walk_v2_bf16i_earlier_f32``)."""
    assert kernel_symbol.startswith("lazy_walk") and kernel_symbol[-4:] in ("_f32", "_f64"), kernel_symbol
    return f"{kernel_symbol[:-4]}_earlier{kernel_symbol[-4:]}"


@contextlib.contextmanager
def swapped(kernel, lib: ctypes.CDLL):
    """Within the block, calls of the port's lazy walk ``kernel`` (a
    ``Kernel``, whose wrapper prepares the arguments) run the earlier
    design's symbol of ``lib`` instead."""
    fn = getattr(lib, earlier_symbol(kernel.symbol))
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    if kernel._fn is None:
        kernel._load()
    saved, kernel._fn = kernel._fn, fn
    try:
        yield
    finally:
        kernel._fn = saved


def _chip_smoke():
    """``chip_smoke.py`` as a module, for its graph and timing helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=50, help="launches per design per turn")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/lazy_walk_turns.py needs a CUDA card")
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.ops import _build
    from eig_kl_tpu_torch.ops.rescale import lazy_z_cuda
    from eig_kl_tpu_torch.ops.spmv import K1_LAZY, K1_LAZY_F64, lazy_walk_cuda
    from eig_kl_tpu_torch.ops.spmv_plan import spmv_v2_cuda, to_bf16, v2_kernel

    smoke = _chip_smoke()
    card = smoke.card_line()
    print(f"card: {card}")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        earlier = pool.submit(build)
        _build.build(("spmv_csr",))
        lib = earlier.result()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(42)

    def state(n, size, dtype, degrees):
        """A random vector of ``n`` values (every 97th -0) and ``dsinv``,
        each padded with +0 to ``size``."""
        w, d = (torch.zeros(size, dtype=dtype, device=dev) for _ in range(2))
        w[:n] = (torch.rand(n, generator=gen, dtype=dtype) - 0.5).to(dev)
        w[:n:97] = -0.0
        d[:n] = torch.sqrt(torch.where(degrees > 0, degrees, 1.0).double()).to(dtype).reciprocal()
        return w, d

    walks = {}  # symbol -> (the graph, launches it once given z, the profiler's name)
    hg = CircuitGenerator(1.0, 42).generate()
    lk_host = clique_expand(smoke.largest_component(hg), "kl")
    for kernel, dtype in ((K1_LAZY, torch.float32), (K1_LAZY_F64, torch.float64)):
        lk = lk_host.to_device(dev, dtype)
        w, d = state(lk.num_nodes, lk.num_nodes, dtype, lk.degrees)
        z = lazy_z_cuda(w, d)
        walks[kernel.symbol] = (kernel, f"gen 1.0x's largest component ({lk.num_nodes} nodes)",
                                lambda lk=lk, w=w, d=d, z=z: lazy_walk_cuda(lk, w, d, z=z), "lazy_walk")

    def v2_walks(layout, degrees, orders, graph):
        P = layout.padded_nodes
        w, d = state(layout.num_nodes, P, torch.float32, degrees)
        w2d, d2d = w.view(P // 128, 128), d.view(P // 128, 128)
        z2d = lazy_z_cuda(w2d, d2d)
        for reduce in orders:
            for products in ("f32", "bf16i", "bf16w"):
                bf16, bf16w = products != "f32", products == "bf16w"
                kernel = v2_kernel(layout, bf16, reduce, bf16w, lazy=True)
                walks[kernel.symbol] = (kernel, graph, lambda bf16=bf16, bf16w=bf16w, reduce=reduce: spmv_v2_cuda(
                    layout, w2d, bf16, dsinv=d2d, reduce=reduce, bf16_weights=bf16w, z=z2d), "spmv_v2")

    g = clique_expand(hg, "kl").to_device(dev, torch.float32, with_plan=True)
    lay = g.plan.layout
    v2_walks(dataclasses.replace(lay, weights_bf16=to_bf16(lay.weights)), g.degrees, ("mxu", "vpu"),
             f"gen 1.0x's padded state ({lay.num_nodes} nodes, row block {lay.rblock})")
    # tests/conftest.py:random_hypergraph(default_rng(21), 6000, 7800, 5), as chip_smoke.py builds it.
    rng6 = np.random.default_rng(21)
    sizes6 = rng6.integers(2, 6, size=7800)
    pins6 = np.concatenate([rng6.choice(6000, size=k, replace=False) for k in sizes6]).astype(np.int32)
    offs6 = np.zeros(7801, np.int64)
    np.cumsum(sizes6, out=offs6[1:])
    g6 = clique_expand(Hypergraph(6000, 7800, pins6, offs6), "kl").to_device(dev)
    v2_walks(CsrPlan.for_graph(g6, kernel="v2", rblock=512, bf16_weights=True).layout, g6.degrees, ("mxu2",),
             "the 6,000-node graph (row block 512)")

    out = {}
    for symbol, (kernel, graph, run, name) in walks.items():
        ref = run()

        def earlier(kernel=kernel, run=run):
            with swapped(kernel, lib):
                return run()
        view = torch.int32 if ref.dtype == torch.float32 else torch.int64
        smoke.check(torch.equal(earlier().view(view), ref.view(view)),
                    f"the earlier design of {symbol} gives other bits")
        us = smoke.turns({"new": run, "earlier": earlier}, name, args.calls)
        out[symbol] = {"graph": graph, "turns_device_us": us}
        print(f"{symbol} on {graph}: bits equal to the earlier design's; in turns (new, earlier, earlier, new) "
              f"new {smoke.fmt_us(us['new'])}, earlier {smoke.fmt_us(us['earlier'])} per launch")
    print(json.dumps({"card": card, "calls": args.calls, "walks": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
