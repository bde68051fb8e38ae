"""The earlier design of K1's blocked product and of the z pass, built
from the strings below and timed beside the port's kernels in one
process, in turns (new, earlier, earlier, new), on the same inputs, with
equal bits:

* ``spmm_csr_earlier_f32`` / ``_f64``: the blocked product as a walk of
  the rows per 4 columns (``spmm_v_kernel`` looping over ``row_sum_v``),
  each walk reading the span's indices and data again and gathering one
  16-byte slice of each entry's row of X;
* ``lazy_z_earlier_f32`` / ``_f64``: the z pass as the rescale's kernel
  without its rescale, one value per thread.

The port's kernels walk the rows once for all k columns
(``spmm_walk_kernel``) and take four values per thread as 16-byte loads
(``lazy_z_kernel``); both designs give the same bits.  The source includes
``csrc/spmv_csr.cu`` for what the designs share and did not change (the
block shape, K1's column walk for other k, the rounded arithmetic), then
adds the earlier kernels verbatim in a namespace of their own.  Nothing
here is imported by the port.  Run on a machine with one CUDA card
(``nvcc`` on the path or under ``/usr/local/cuda``)::

    python3 tools/spmm_turns.py [--calls N]

It builds the port's kernels and the earlier designs, then times the
blocked product at k = 4, 8, 12 and 16, with and without the Laplacian's
epilogue, in f32 and f64, on the "eig" graph of gen 1.0x's largest
component (184,406 nodes, as ``chip_smoke.py`` and LOBPCG use it), and
the z pass beside ``torch.mul`` on the same vectors (n = 184,406, f32 and
f64).  Device microseconds per launch come from the profiler, ``N``
launches (default 50) per turn.  It prints the card's name and power
limit, the kernels' registers as ``ptxas`` reports them, a line per
measurement, and last one JSON object of them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "eig_kl_tpu_torch" / "_build" / "turns"
CSRC = REPO / "eig_kl_tpu_torch" / "csrc"

#: The blocked product's walk per 4 columns and its dispatcher, verbatim.
SPMM = r"""
// The blocked product's vector walk: kCols = 4 columns per walk of the
// rows, gathered kCols / V 16-byte vectors at a time (V = 4 f32 or 2 f64
// values): one load in f32, two loads of one 32-byte sector in f64.
constexpr int kCols = 4;
constexpr int kChunkV = 256;  // entries staged at a time, kCols columns each
constexpr int kPerLaneV = 4;
constexpr int kStageV = 32 * kPerLaneV;

// Values of T per warp: the data, then kCols values per entry.
constexpr int kBufferV = kChunkV * (1 + kCols);

// Columns c0 .. c0 + kCols - 1 of A @ X for row r0 + lane into out[], X
// row-major (n, k) with k a multiple of kCols and X 16-byte aligned: each
// column added in row_sum's (XLA's) order.  `buf` is the warp's
// kBufferV values.
template <class T>
__device__ __forceinline__ void row_sum_v(const int* __restrict__ indptr,
                                          const int* __restrict__ indices,
                                          const T* __restrict__ data,
                                          const T* __restrict__ x, int k, int c0, T* buf,
                                          int r0, int n, int row_width, T (&out)[kCols]) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kWidth;
  constexpr int kQ = kCols / kV;  // 16-byte vectors per entry
  static_assert(kCols % kV == 0, "whole 16-byte vectors per entry");
  const int lane = threadIdx.x & 31;
  const int row = r0 + lane;
  __syncwarp();  // the buffer's last reader (a call before this one) is done
  const int lo = __ldg(indptr + min(row, n - 1));
  const int hi = row < n ? __ldg(indptr + min(row, n - 1) + 1) : lo;
  const int span_lo = __ldg(indptr + r0);
  const int span_hi = __ldg(indptr + min(r0 + 32, n));
  T* d = buf;
  V* xv = reinterpret_cast<V*>(buf + kChunkV);
  const bool lanes8 = row_width <= kWindow;
  const bool chain = row_width <= kChainWidth;  // one chain in acc[0]
  const int windows = (row_width + kWindow - 1) / kWindow;
  const int pad = lanes8 ? 0 : (windows * kWindow - row_width) / 2;
  // W <= 32: the 8 lane chains; W > 32: acc[0] the window's sum, acc[1] the row's.
  T acc[kLanes][kCols];
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[q][c] = T(0);
  }
  for (int c = span_lo; c < span_hi; c += kChunkV) {
    const int len = min(kChunkV, span_hi - c);
    for (int base = 0; base < len; base += kStageV) {
      int col[kPerLaneV];
      T w[kPerLaneV];
      V xg[kPerLaneV][kQ];
#pragma unroll
      for (int q = 0; q < kPerLaneV; ++q) {
        const int i = min(base + lane + 32 * q, len - 1);
        col[q] = __ldg(indices + c + i);
        w[q] = __ldg(data + c + i);
      }
#pragma unroll
      for (int q = 0; q < kPerLaneV; ++q) {
        const V* src = reinterpret_cast<const V*>(x + static_cast<long long>(col[q]) * k + c0);
#pragma unroll
        for (int v = 0; v < kQ; ++v) xg[q][v] = __ldg(src + v);
      }
#pragma unroll
      for (int q = 0; q < kPerLaneV; ++q) {
        const int i = base + lane + 32 * q;
        if (i < len) {
          d[i] = w[q];
#pragma unroll
          for (int v = 0; v < kQ; ++v) xv[i * kQ + v] = xg[q][v];
        }
      }
    }
    __syncwarp();
    // This row's entries in the chunk, as positions in the row.
    const int pb = max(lo, c) - lo;
    const int pe = min(hi, c + len) - lo;
    if (chain) {
      for (int p = pb; p < pe; ++p) {
        const int t = lo + p - c;
        const T wt = d[t];
        V xt[kQ];
#pragma unroll
        for (int v = 0; v < kQ; ++v) xt[v] = xv[t * kQ + v];
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[0][e] = mul_add(wt, vec_at(xt[e / kV], e % kV), acc[0][e]);
      }
    } else if (lanes8) {
      for (int p0 = pb & ~(kLanes - 1); p0 < pe; p0 += kLanes) {
#pragma unroll
        for (int q = 0; q < kLanes; ++q) {
          const int p = p0 + q;
          const int t = min(max(lo + p, c), c + len - 1) - c;
          const T wt = d[t];
          V xt[kQ];
#pragma unroll
          for (int v = 0; v < kQ; ++v) xt[v] = xv[t * kQ + v];
          if (p >= pb && p < pe) {
#pragma unroll
            for (int e = 0; e < kCols; ++e) acc[q][e] = mul_add(wt, vec_at(xt[e / kV], e % kV), acc[q][e]);
          }
        }
      }
    } else {
      for (int p = pb; p < pe;) {
        const int offset = (p + pad) & (kWindow - 1);
        if (offset == 0) {
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            acc[1][e] = add_rn(acc[1][e], acc[0][e]);
            acc[0][e] = T(0);
          }
        }
        const int end = min(pe, p + kWindow - offset);
        for (; p < end; ++p) {
          const int t = lo + p - c;
          const T wt = d[t];
          V xt[kQ];
#pragma unroll
          for (int v = 0; v < kQ; ++v) xt[v] = xv[t * kQ + v];
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[0][e] = add_rn(acc[0][e], mul_rn(wt, vec_at(xt[e / kV], e % kV)));
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    if (chain) {
      out[e] = acc[0][e];
    } else if (lanes8) {
      out[e] = add_rn(add_rn(add_rn(acc[0][e], acc[4][e]), add_rn(acc[2][e], acc[6][e])),
                      add_rn(add_rn(acc[1][e], acc[5][e]), add_rn(acc[3][e], acc[7][e])));
    } else {
      out[e] = add_rn(acc[1][e], acc[0][e]);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    spmm_v_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                  const T* __restrict__ data, const T* __restrict__ x,
                  const T* __restrict__ deg, T* __restrict__ y, int n, int k,
                  int row_width) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kWidth;
  constexpr int kQ = kCols / kV;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  T* buf = reinterpret_cast<T*>(shared_raw) + warp * kBufferV;
  const int row = r0 + (threadIdx.x & 31);
  const long long base = static_cast<long long>(min(row, n - 1)) * k;
  const T dr = deg != nullptr ? __ldg(deg + min(row, n - 1)) : T(0);
  for (int c0 = 0; c0 < k; c0 += kCols) {
    T ax[kCols];
    row_sum_v<T>(indptr, indices, data, x, k, c0, buf, r0, n, row_width, ax);
    if (row < n) {
#pragma unroll
      for (int v = 0; v < kQ; ++v) {
        T part[kV];
        if (deg != nullptr) {
          const V xr = __ldg(reinterpret_cast<const V*>(x + base + c0) + v);
#pragma unroll
          for (int e = 0; e < kV; ++e) part[e] = mul_add(dr, vec_at(xr, e), -ax[v * kV + e]);
        } else {
#pragma unroll
          for (int e = 0; e < kV; ++e) part[e] = ax[v * kV + e];
        }
        reinterpret_cast<V*>(y + base + c0)[v] = vec_of(part);
      }
    }
  }
}

template <class T>
int spmm_csr(const void* indptr, const void* indices, const void* data, const void* x,
             const void* deg, void* y, int n, int k, int row_width, void* stream) {
  if (k < 1 || k > 16) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  constexpr int kV = Vec16<T>::kWidth;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  const auto* dp = static_cast<const T*>(data);
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const T*>(deg);
  auto* yp = static_cast<T*>(y);
  if (n > 0 && k % 4 == 0 && aligned) {
    spmm_v_kernel<T><<<blocks_for(n), kThreads, kWarps * kBufferV * sizeof(T), s>>>(
        ip, ix, dp, xp, gp, yp, n, k, row_width);
  } else if (n > 0) {
    spmm_kernel<T><<<blocks_for(n), kThreads, shared_bytes<T>(row_width),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<const T*>(deg),
        static_cast<T*>(y), n, k, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

#: The rescale's kernel, whose launch without inv was the z pass, verbatim.
RESCALE = r"""
template <class T>
__global__ void __launch_bounds__(256)
    lazy_rescale_kernel(const T* __restrict__ u, const T* __restrict__ w, const T* __restrict__ inv,
                        const T* __restrict__ dsinv, T* __restrict__ u_out, T* __restrict__ w_out,
                        T* __restrict__ z, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T ui = __ldg(u + i);
  if (inv != nullptr) {
    const T c = __ldg(inv);
    ui = mul_rn(ui, c);
    u_out[i] = ui;
    if (w != nullptr) w_out[i] = mul_rn(__ldg(w + i), c);
  }
  z[i] = mul_rn(__ldg(dsinv + i), ui);
}
"""

SOURCE = r"""
#include "spmv_csr.cu"

namespace {
namespace earlier {

__SPMM__
__RESCALE__
}  // namespace earlier
}  // namespace

#define SPMM_EARLIER(NAME, T)                                                                      \
  extern "C" int NAME(const void* indptr, const void* indices, const void* data, const void* x,    \
                      const void* deg, void* y, int n, int k, int row_width, void* stream) {       \
    return earlier::spmm_csr<T>(indptr, indices, data, x, deg, y, n, k, row_width, stream);        \
  }

SPMM_EARLIER(spmm_csr_earlier_f32, float)
SPMM_EARLIER(spmm_csr_earlier_f64, double)

#define Z_EARLIER(NAME, T)                                                                         \
  extern "C" int NAME(const void* w, const void* dsinv, void* z, int n, void* stream) {            \
    if (n > 0) {                                                                                   \
      earlier::lazy_rescale_kernel<T><<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>( \
          static_cast<const T*>(w), nullptr, nullptr, static_cast<const T*>(dsinv), nullptr,        \
          nullptr, static_cast<T*>(z), n);                                                         \
    }                                                                                              \
    return static_cast<int>(cudaGetLastError());                                                   \
  }

Z_EARLIER(lazy_z_earlier_f32, float)
Z_EARLIER(lazy_z_earlier_f64, double)
""".replace("__SPMM__", SPMM).replace("__RESCALE__", RESCALE)


def build() -> tuple[ctypes.CDLL, str]:
    """Build the earlier designs as ``_build/turns/spmm_earlier.so`` with
    the port's nvcc flags (ops/_build.py) and load it; also the
    compiler's report."""
    from eig_kl_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "spmm_earlier.cu", OUT / "spmm_earlier.so"
    src.write_text(SOURCE)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"building {src} failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib)), done.stdout + done.stderr


def earlier_symbol(kernel_symbol: str) -> str:
    """``spmm_csr_f32`` -> ``spmm_csr_earlier_f32``."""
    return f"{kernel_symbol[:-4]}_earlier{kernel_symbol[-4:]}"


def swapped_fn(kernel, lib: ctypes.CDLL):
    """A callable that runs ``fn`` with the port's ``kernel`` (a
    ``Kernel``, whose wrapper prepares the arguments) replaced by the
    earlier design's symbol of ``lib``."""
    fn = getattr(lib, earlier_symbol(kernel.symbol))
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int

    def run(call):
        if kernel._fn is None:
            kernel._load()
        saved, kernel._fn = kernel._fn, fn
        try:
            return call()
        finally:
            kernel._fn = saved
    return run


def registers(report: str, names: tuple[str, ...]) -> list[str]:
    """ptxas's lines of the functions whose names hold one of ``names``:
    "Compiling entry function", then its registers and spills."""
    lines, keep, out = report.splitlines(), False, []
    for line in lines:
        if "Compiling entry function" in line:
            keep = any(n in line for n in names)
        if keep and ("Used" in line or "spill" in line or "Compiling entry" in line):
            out.append(line.strip())
    return out


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
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/spmm_turns.py needs a CUDA card")
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.ops import _build
    from eig_kl_tpu_torch.ops.rescale import K1_Z, K1_Z_F64, lazy_z_cuda, lazy_z_plain
    from eig_kl_tpu_torch.ops.spmv import K1_SPMM, K1_SPMM_F64, spmm_cuda, spmm_plain

    smoke = _chip_smoke()
    card = smoke.card_line()
    print(f"card: {card}")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        earlier = pool.submit(build)
        report = _build.build(("spmv_csr",))
        lib, earlier_report = earlier.result()
    for line in registers("\n".join(report.values()) + earlier_report, ("spmm", "lazy_z", "lazy_rescale")):
        print(f"ptxas: {line}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(42)

    def device_us(call, name):
        us = smoke.device_us_per_launch(lambda: [call() for _ in range(args.calls)], name)
        return None if us is None else us[0]

    def in_turns(designs):
        """{design: [us, us]}: the designs in order, then in reverse, after
        a warm-up of each and one profiled window that is not kept (the
        first window of a sequence runs slower); ``designs`` maps a name to
        (a call, its kernel's name)."""
        for call, _ in designs.values():
            for _ in range(args.calls):
                call()
        torch.cuda.synchronize()
        device_us(*next(iter(designs.values())))
        out = {name: [] for name in designs}
        for name in list(designs) + list(designs)[::-1]:
            out[name].append(device_us(*designs[name]))
        return out

    def same_bits(a, b):
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.view(view), b.view(view))

    hg = CircuitGenerator(1.0, 42).generate()
    lcc_host = clique_expand(smoke.largest_component(hg), "eig")
    out = {"card": card, "calls": args.calls, "spmm": {}, "z pass": {}}
    for kernel, dtype in ((K1_SPMM, torch.float32), (K1_SPMM_F64, torch.float64)):
        lg = lcc_host.to_device(dev, dtype)
        old = swapped_fn(kernel, lib)
        for k in (4, 8, 12, 16):
            X = (torch.rand(lg.num_nodes, k, generator=gen, dtype=dtype) - 0.5).to(dev)
            X[::97] = -0.0
            for laplacian in (True, False):
                def new(X=X, laplacian=laplacian):
                    return spmm_cuda(lg, X, laplacian=laplacian)
                def was(X=X, laplacian=laplacian):
                    return old(lambda: spmm_cuda(lg, X, laplacian=laplacian))
                ref = new()
                smoke.check(same_bits(ref, spmm_plain(lg, X, laplacian=laplacian)),
                            f"{kernel.symbol} at k = {k} differs from its plain version")
                smoke.check(same_bits(was(), ref), f"the earlier design of {kernel.symbol} gives other bits")
                us = in_turns({"new": (new, "spmm"), "earlier": (was, "spmm")})
                key = f"{kernel.symbol} k={k} {'laplacian' if laplacian else 'A @ X'}"
                out["spmm"][key] = us
                print(f"{key}: bits equal to the earlier design's; in turns (new, earlier, earlier, new) new "
                      f"{smoke.fmt_us(us['new'])}, earlier {smoke.fmt_us(us['earlier'])} per launch; "
                      f"new {us['new']}, earlier {us['earlier']}")
    n = lcc_host.num_nodes
    for kernel, dtype in ((K1_Z, torch.float32), (K1_Z_F64, torch.float64)):
        w = (torch.rand(n, generator=gen, dtype=dtype) - 0.5).to(dev)
        w[::89] = -0.0
        d = (torch.rand(n, generator=gen, dtype=dtype) + 0.1).to(dev)
        old = swapped_fn(kernel, lib)
        ref = lazy_z_cuda(w, d)
        smoke.check(same_bits(ref, lazy_z_plain(w, d)), f"{kernel.symbol} differs from its plain version")
        smoke.check(same_bits(old(lambda: lazy_z_cuda(w, d)), ref),
                    f"the earlier design of {kernel.symbol} gives other bits")
        us = in_turns({"new": (lambda: lazy_z_cuda(w, d), "lazy_z_kernel"),
                       "earlier": (lambda: old(lambda: lazy_z_cuda(w, d)), "lazy_rescale_kernel"),
                       "torch.mul": (lambda: torch.mul(d, w), "elementwise")})
        out["z pass"][kernel.symbol] = us
        print(f"{kernel.symbol} at n = {n}: bits equal to the earlier design's and torch.mul's; in turns (new, "
              f"earlier, torch.mul, torch.mul, earlier, new) new {us['new']}, earlier {us['earlier']}, torch.mul "
              f"{us['torch.mul']} us per launch")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
