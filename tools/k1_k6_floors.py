"""What limits K1, K4 and K6 on the card, at the main path's shapes.

Run from the repository root on a machine with one CUDA card::

    python3 tools/k1_k6_floors.py [--k6-earlier DIR]

K1 (``csrc/spmv_csr.cu``): on the generated circuit at 1.0x (seed 42), the
device time per launch (profiler, 100 launches each) of K1 and of kernels
built here from the sources below into ``eig_kl_tpu_torch/_build/floors/``:
K1's earlier design, one thread per row walking its row as a chain of
loads (timed in turns with K1: K1, rows, rows, K1), and two probes, one
that only gathers ``x[indices[k]]`` for every stored entry, one that only
streams ``indices`` and ``data``.  The two probes are the two halves of
K1's memory traffic: their times bound K1's from below where its byte
count (each array read once) does not see that a gather of 4 bytes costs
the L2 a whole sector.  ``chip_smoke.py`` times K1's step and
``torch.sparse``.

K4 (``csrc/fma_dot.cu``): the chain's latency floor, a probe that runs n
dependent fused multiply-adds on values in registers, one thread, no loads
(device us by the profiler, cycles per operation by ``clock64``), at the
v3 path's P = 202,752 (f32) and the momentum exit's n = 184,406 (f32 and
f64); and K4 against its earlier design (one block, warps 1..7 staging
two alternating tiles, thread 0 chaining at a ``__syncthreads`` per
tile; built here from a string) in turns (earlier, K4, K4, earlier),
bitwise equal, beside two dots in one K4 launch and ``torch.dot``'s device
time.

K6 (``csrc/tree_sum.cu``): a copy of the source under the same directory
with ``%globaltimer`` stamps written by thread 0 of each block (at the
block's start, after its grid stage's sums and fence, and in the last
block after its ticket, each later stage and the result), run on the 1-D
norm over 201,920 values and the 2-D norm over (1584, 128): per phase,
nanoseconds from the kernel's first block start (median of 5 launches),
beside the committed kernel's device time per launch.  With
``--k6-earlier DIR``, a directory holding an earlier ``tree_sum.cu`` and
its ``fp.cuh`` (the earlier design: round 1 over the grid on blocks of 8
warps, each later round in the last block; for example from ``git
archive 04ea94b eig_kl_tpu_torch/csrc``), the same split of that source with its
own stamps, and the two designs' device time timed in turns.  The
committed sources stay as they are.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import device_us_per_call, device_us_per_launch  # noqa: E402
from eig_kl_tpu_torch.graph.expand import clique_expand  # noqa: E402
from eig_kl_tpu_torch.models.generator import CircuitGenerator  # noqa: E402
from eig_kl_tpu_torch.ops import _build  # noqa: E402
from eig_kl_tpu_torch.ops import reduce as R  # noqa: E402
from eig_kl_tpu_torch.ops.spmv import K1, spmv_csr, spmv_plain  # noqa: E402

OUT = REPO / "eig_kl_tpu_torch" / "_build" / "floors"
PROBES = r"""
#include <cuda_runtime.h>
// K1's earlier design: one thread per row, its row walked as a chain of
// loads, in K1's order.
__global__ void spmv_rows_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                                 const float* __restrict__ data, const float* __restrict__ x,
                                 float* __restrict__ y, int n, int row_width) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int lo = indptr[row], hi = indptr[row + 1];
  float out = 0.0f;
  if (row_width <= 32) {
    float acc[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) acc[l] = 0.0f;
    for (int k0 = lo; k0 < hi; k0 += 8) {
#pragma unroll
      for (int l = 0; l < 8; ++l)
        if (k0 + l < hi) acc[l] = __fmaf_rn(data[k0 + l], __ldg(x + indices[k0 + l]), acc[l]);
    }
    out = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[4]), __fadd_rn(acc[2], acc[6])),
                    __fadd_rn(__fadd_rn(acc[1], acc[5]), __fadd_rn(acc[3], acc[7])));
  } else {
    const int windows = (row_width + 31) / 32, pad = (windows * 32 - row_width) / 2;
    for (int j = 0; j < windows; ++j) {
      const int a = max(lo + j * 32 - pad, lo), b = min(lo + (j + 1) * 32 - pad, hi);
      float s = 0.0f;
      for (int k = a; k < b; ++k) s = __fadd_rn(s, __fmul_rn(data[k], __ldg(x + indices[k])));
      out = __fadd_rn(out, s);
    }
  }
  y[row] = out;
}
extern "C" int spmv_rows(const void* indptr, const void* indices, const void* data, const void* x,
                         void* y, int n, int row_width, void* stream) {
  spmv_rows_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (const int*)indptr, (const int*)indices, (const float*)data, (const float*)x, (float*)y, n, row_width);
  return static_cast<int>(cudaGetLastError());
}
__global__ void gather_only(const int* __restrict__ idx, const float* __restrict__ x,
                            float* out, int nnz) {
  float s = 0.0f;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < nnz; k += gridDim.x * blockDim.x)
    s += __ldg(x + __ldg(idx + k));
  if (s == 12345.0f) out[0] = s;  // keeps the loads
}
__global__ void stream_only(const int* __restrict__ idx, const float* __restrict__ d,
                            float* out, int nnz) {
  float s = 0.0f;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < nnz; k += gridDim.x * blockDim.x)
    s += __ldg(d + k) + static_cast<float>(__ldg(idx + k));
  if (s == 12345.0f) out[0] = s;
}
extern "C" int probe(int which, const void* idx, const void* v, void* out, int nnz, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (which == 0) gather_only<<<1056, 256, 0, st>>>((const int*)idx, (const float*)v, (float*)out, nnz);
  else stream_only<<<1056, 256, 0, st>>>((const int*)idx, (const float*)v, (float*)out, nnz);
  return static_cast<int>(cudaGetLastError());
}
"""
# K4's earlier design: one block; warps 1..7 stage the next tile of x
# and y in shared memory while thread 0 chains through the current one,
# the two tiles alternating at a __syncthreads.
K4_EARLIER = r"""
#include <cuda_runtime.h>
#include "fp.cuh"
namespace {
constexpr int kThreads = 256;
template <class T>
constexpr int kTile = 8192 / static_cast<int>(sizeof(T));
template <class T>
__global__ void __launch_bounds__(kThreads)
    fma_dot_earlier_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, int n) {
  constexpr int kT = kTile<T>;
  __shared__ T sx[2][kT];
  __shared__ T sy[2][kT];
  const int t = threadIdx.x;
  const int n_tiles = (n + kT - 1) / kT;
  for (int i = t; i < kT && i < n; i += kThreads) {
    sx[0][i] = x[i];
    sy[0][i] = y[i];
  }
  __syncthreads();
  T acc = T(0);
  if (t == 0) {
    for (int i = 0; i < min(n, 8); ++i) {
      acc = add_rn(acc, mul_rn(sx[0][i], sy[0][i]));
      sx[0][i] = T(0);
      sy[0][i] = T(0);
    }
  }
  for (int k = 0; k < n_tiles; ++k) {
    const int cur = k & 1;
    if (t >= 32) {
      const int base = (k + 1) * kT;
      for (int i = t - 32; i < kT && base + i < n; i += kThreads - 32) {
        sx[cur ^ 1][i] = x[base + i];
        sy[cur ^ 1][i] = y[base + i];
      }
    } else if (t == 0) {
      const int len = min(kT, n - k * kT);
#pragma unroll 8
      for (int i = 0; i < len; ++i) acc = fma_rn(sx[cur][i], sy[cur][i], acc);
    }
    __syncthreads();
  }
  if (t == 0) *out = acc;
}
}  // namespace
extern "C" int fma_dot_earlier(int f64, const void* x, const void* y, void* out, int n, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) fma_dot_earlier_kernel<double><<<1, kThreads, 0, st>>>((const double*)x, (const double*)y, (double*)out, n);
  else fma_dot_earlier_kernel<float><<<1, kThreads, 0, st>>>((const float*)x, (const float*)y, (float*)out, n);
  return static_cast<int>(cudaGetLastError());
}
"""
# The chain's latency floor: n dependent fused multiply-adds on values in
# registers, one thread, no loads; clock64() around the chain.
CHAIN_PROBE = r"""
#include <cuda_runtime.h>
template <class T>
__device__ __forceinline__ T fma_op(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_op<float>(float a, float b, float c) { return __fmaf_rn(a, b, c); }
template <>
__device__ __forceinline__ double fma_op<double>(double a, double b, double c) { return __fma_rn(a, b, c); }
template <class T>
__global__ void fma_chain_probe(T a, T b, T* out, long long* cycles, int n) {
  T acc = out[0];
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k) acc = fma_op<T>(acc, a, b);
  }
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}
extern "C" int chain_probe(int f64, void* out, void* cycles, int n, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) fma_chain_probe<double><<<1, 1, 0, st>>>(0.999, 1e-3, (double*)out, (long long*)cycles, n);
  else fma_chain_probe<float><<<1, 1, 0, st>>>(0.999f, 1e-3f, (float*)out, (long long*)cycles, n);
  return static_cast<int>(cudaGetLastError());
}
"""
STAMP = r"""__device__ unsigned long long* k6_stamps;
__device__ __forceinline__ void k6_stamp(int slot) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    k6_stamps[blockIdx.x * 8 + slot] = t;
  }
}
"""
# (anchor in tree_sum.cu, what goes after it), for the committed design:
# slot 0 the block's start, 1 its grid stage (round 1, or rounds 1 and 2
# folded) written and fenced, 2 the last block's ticket, 3 + k after its
# k-th stage, 7 the result written.
STAMPS = (
    ("  const Input<T> input{v, w, mode};\n", "  k6_stamp(0);\n  int k6_stage = 0;\n"),
    ("  __threadfence();  // this block's sums, before its ticket\n", "  k6_stamp(1);\n"),
    ("  if (!last) return;\n  __threadfence();\n", "  k6_stamp(2);\n"),
    ("    __syncthreads();  // the stage's sums, before the next stage reads them\n", "    k6_stamp(3 + k6_stage++);\n"),
    ("    *ticket = 0u;\n", "    k6_stamp(7);\n"),
)
# The same places in K6's earlier design (round 1 over the grid, each
# later round in the last block; 3 + k after its round k + 2).
EARLIER_STAMPS = (
    ("  const Input<T> input{v, w, mode};\n", "  k6_stamp(0);\n"),
    ("    __threadfence();  // this block's window sums, before its ticket\n  }\n", "  k6_stamp(1);\n"),
    ("  if (!last) return;\n  __threadfence();\n", "  k6_stamp(2);\n"),
    ("    run_round(Partials<T>{src}, round, dst, tile, warp, kW, lane);\n    __syncthreads();\n",
     "    k6_stamp(2 + k);\n"),
    ("    *ticket = 0u;\n", "    k6_stamp(7);\n"),
)
K6_SHAPES = ((201_920,), (1584, 128))
PHASES = ("grid stage written, median block", "grid stage written, last block", "ticket taken",
          "stage 1 after the ticket", "stage 2 after the ticket", "stage 3 after the ticket", "result written")


def nvcc_build(name: str, source: str, csrc: Path = _build.CSRC) -> ctypes.CDLL:
    """Build ``source`` as ``_build/floors/<name>.so``, beside a copy of
    ``csrc``'s ``fp.cuh``."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(source)
    (OUT / "fp.cuh").write_text((csrc / "fp.cuh").read_text())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return ctypes.CDLL(str(lib))


def device_us(fn, kernel: str, reps: int = 100) -> float:
    """Mean device time in microseconds of the kernels named ``kernel``
    over ``reps`` calls of ``fn`` (profiler; profiled a second time if the
    first saw none, as a process's first profile can miss its kernels)."""
    for _ in range(2):
        us = device_us_per_launch(lambda: [fn() for _ in range(reps)], kernel)
        if us is not None:
            return us[0]
    raise RuntimeError(f"the profiler recorded no {kernel} kernel")


def checked(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


K4_SHAPES = ((torch.float32, 202_752), (torch.float32, 184_406), (torch.float64, 184_406))


def chain_floor(dev) -> dict:
    """The probe's n dependent fused multiply-adds at K4's shapes (the v3
    path's P, the momentum exit's n): device us and cycles per operation."""
    probe = nvcc_build("chain_probe", CHAIN_PROBE)
    probe.chain_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for dtype, n in K4_SHAPES:
        f64 = int(dtype == torch.float64)
        acc = torch.zeros(1, dtype=dtype, device=dev)
        cycles = torch.zeros(1, dtype=torch.int64, device=dev)

        def run(f64=f64, n=n, acc=acc, cycles=cycles):
            checked(probe.chain_probe(f64, acc.data_ptr(), cycles.data_ptr(), n, stream), "the chain probe")

        run()
        torch.cuda.synchronize()
        out[f"{str(dtype)[6:]} n={n}"] = {
            "device_us": device_us(run, "fma_chain_probe", 20),
            "cycles_per_op": float(cycles.item()) / n,
        }
    return out


def k4_turns(dev) -> dict:
    """K4 against its earlier design in turns (earlier, K4, K4, earlier),
    bitwise equal; two dots in one launch; torch.dot's device time."""
    earlier = nvcc_build("fma_dot_earlier", K4_EARLIER)
    earlier.fma_dot_earlier.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device="cpu").manual_seed(42)
    out = {}
    for dtype, n in K4_SHAPES:
        f64 = int(dtype == torch.float64)
        x = (torch.rand(n, generator=gen, dtype=dtype) - 0.5).to(dev)
        y = (torch.rand(n, generator=gen, dtype=dtype) - 0.5).to(dev)
        res = torch.empty((), dtype=dtype, device=dev)

        def run_earlier(x=x, y=y, res=res, f64=f64, n=n):
            checked(earlier.fma_dot_earlier(f64, x.data_ptr(), y.data_ptr(), res.data_ptr(), n, stream),
                    "K4's earlier design")

        run_earlier()
        pair = R.fma_dot_batch_cuda((x, x), (y, y))
        if not (torch.equal(res, R.fma_dot_cuda(x, y)) and torch.equal(pair, res.expand(2))):
            raise AssertionError("K4 and its earlier design differ")
        times = {"earlier design": [], "K4": []}
        for design in ("earlier design", "K4", "K4", "earlier design"):
            if design == "K4":
                times[design].append(device_us(lambda x=x, y=y: R.fma_dot_cuda(x, y), "fma_dot_batch", 20))
            else:
                times[design].append(device_us(run_earlier, "fma_dot_earlier", 20))
        lib = device_us_per_call(lambda x=x, y=y: [torch.dot(x, y) for _ in range(20)], 20)
        out[f"{str(dtype)[6:]} n={n}"] = {
            "device_us": {k: min(v) for k, v in times.items()},
            "two_dots_in_one_launch_device_us": device_us(
                lambda x=x, y=y: R.fma_dot_batch_cuda((x, x), (y, y)), "fma_dot_batch", 20),
            "torch_dot_device_us": None if lib is None else lib[0],
        }
    return out


def k6_phases(dev, csrc: Path, stamps, earlier: bool) -> dict:
    """K6's phases by %globaltimer stamps in a copy of ``csrc/tree_sum.cu``
    (``earlier``: the earlier design), on the 1-D norm over 201,920 values and the 2-D norm over
    (1584, 128): nanoseconds from the first block's start, median of 5
    launches."""
    source = (csrc / "tree_sum.cu").read_text()
    source = source.replace("namespace {\n", STAMP + "namespace {\n", 1)
    for anchor, stamp in stamps:
        if source.count(anchor) != 1:
            raise RuntimeError(f"{csrc / 'tree_sum.cu'} has no single place for {stamp.strip()}")
        source = source.replace(anchor, anchor + stamp)
    source += ('\nextern "C" int set_stamps(void* p) {\n'
               '  cudaMemcpyToSymbol(k6_stamps, &p, sizeof(p));\n'
               '  return static_cast<int>(cudaGetLastError());\n}\n')
    lib = nvcc_build("tree_sum_stamped_earlier" if earlier else "tree_sum_stamped", source, csrc)
    fn = lib.tree_sum_f32
    fn.argtypes, fn.restype = R.K6.argtypes, ctypes.c_int
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    stamp_buf = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    checked(lib.set_stamps(stamp_buf.data_ptr()), "set_stamps")
    gen = torch.Generator(device="cpu").manual_seed(42)
    out = {}
    for shape in K6_SHAPES:
        v = (torch.rand(shape, generator=gen) - 0.5).to(dev)
        plan, scratch_len, second = R.k6_plan(shape)
        runs = []
        for _ in range(5):
            stamp_buf.zero_()
            scratch = torch.empty(scratch_len, device=dev)
            res = torch.empty((), device=dev)
            stream = torch.cuda.current_stream(dev)
            checked(fn(v.data_ptr(), v.data_ptr(), 1, ctypes.addressof(plan), scratch.data_ptr(), second,
                       R._ticket(dev, stream).data_ptr(), res.data_ptr(), 1, stream.cuda_stream), "the stamped K6")
            torch.cuda.synchronize()
            norm = R.tree_norm if len(shape) == 1 else R.tree_norm_2d
            if not torch.equal(res.cpu().view(torch.int32), norm(v.cpu()).view(torch.int32)):
                raise AssertionError("the stamped K6 differs from the plain norm")
            d = stamp_buf.view(-1, 8).cpu().numpy().astype(np.int64)
            d = d[d[:, 0] > 0]
            t0 = d[:, 0].min()
            last = d[d[:, 2] > 0][0] if (d[:, 2] > 0).any() else d[0]
            runs.append([np.median(d[:, 1]) - t0, d[:, 1].max() - t0, last[2] - t0 if last[2] else np.nan]
                        + [last[c] - t0 if last[c] else np.nan for c in (3, 4, 5)] + [last[7] - t0])
        med = np.median(np.array(runs, dtype=np.float64), axis=0)
        out["x".join(map(str, shape))] = {
            "blocks": int(len(d)),
            "rounds": [list(r.windows) for r in R.reduce_rounds(shape)],
            "ns_from_start": {k: None if np.isnan(t) else float(t) for k, t in zip(PHASES, med)},
        }
    return out


def k6_turns(dev, earlier_csrc: Path) -> dict:
    """The committed K6 and the earlier design's unstamped build, device
    us per launch in turns (earlier, K6, K6, earlier), each shape's norm."""
    lib = nvcc_build("tree_sum_earlier", (earlier_csrc / "tree_sum.cu").read_text(), earlier_csrc)
    fn = lib.tree_sum_f32
    fn.argtypes, fn.restype = R.K6.argtypes, ctypes.c_int
    gen = torch.Generator(device="cpu").manual_seed(7)
    out = {}
    for shape in K6_SHAPES:
        v = (torch.rand(shape, generator=gen) - 0.5).to(dev)
        plan, scratch_len, second = R.k6_plan(shape)
        scratch = torch.empty(scratch_len, device=dev)
        res = torch.empty((), device=dev)
        stream = torch.cuda.current_stream(dev)

        def run(v=v, plan=plan, scratch=scratch, second=second, res=res, stream=stream):
            checked(fn(v.data_ptr(), v.data_ptr(), 1, ctypes.addressof(plan), scratch.data_ptr(), second,
                       R._ticket(dev, stream).data_ptr(), res.data_ptr(), 1, stream.cuda_stream), "the earlier K6")

        run()
        if not torch.equal(res, R.tree_sum_cuda(v, square=True, root=True)):
            raise AssertionError("K6 and its earlier design differ")
        times = {"earlier design": [], "K6": []}
        for design in ("earlier design", "K6", "K6", "earlier design"):
            kern = run if design != "K6" else (lambda v=v: R.tree_sum_cuda(v, square=True, root=True))
            times[design].append(device_us(kern, "tree_sum_kernel"))
        out["x".join(map(str, shape))] = {k: min(t) for k, t in times.items()}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k6-earlier", metavar="DIR",
                        help="a csrc/ directory of K6's earlier design (tree_sum.cu and fp.cuh)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/k1_k6_floors.py needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build(("spmv_csr", "tree_sum", "fma_dot"))
    g = clique_expand(CircuitGenerator(1.0, 42).generate(), "kl").to_device(dev, torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(42)
    x = (torch.rand(g.num_nodes, generator=gen) - 0.5).to(dev)
    probes = nvcc_build("probes", PROBES)
    probes.probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    probes.spmv_rows.argtypes = K1.argtypes
    sink = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    y_rows = torch.empty_like(x)

    def rows():
        code = probes.spmv_rows(g.indptr.data_ptr(), g.indices.data_ptr(), g.data.data_ptr(), x.data_ptr(),
                                y_rows.data_ptr(), g.num_nodes, g.row_width, stream)
        if code != 0:
            raise RuntimeError(f"the row-per-thread design failed: CUDA error {code}")

    rows()
    if not (torch.equal(spmv_csr(g, x), spmv_plain(g, x)) and torch.equal(y_rows, spmv_csr(g, x))):
        raise AssertionError("K1 or its row-per-thread design differs from spmv_plain")
    k1 = {"K1": [], "rows design": []}
    for design in ("K1", "rows design", "rows design", "K1"):
        if design == "K1":
            k1[design].append(device_us(lambda: spmv_csr(g, x), "spmv_csr_kernel"))
        else:
            k1[design].append(device_us(rows, "spmv_rows_kernel"))
    result = {
        "card": card,
        "k1_device_us": {k: min(v) for k, v in k1.items()},
        "x_gathers_alone_device_us": device_us(
            lambda: probes.probe(0, g.indices.data_ptr(), x.data_ptr(), sink.data_ptr(), g.nnz, stream), "gather_only"),
        "index_data_streams_alone_device_us": device_us(
            lambda: probes.probe(1, g.indices.data_ptr(), g.data.data_ptr(), sink.data_ptr(), g.nnz, stream), "stream_only"),
        "k4_chain_floor": chain_floor(dev),
        "k4": k4_turns(dev),
        "k6": {
            "phases": k6_phases(dev, _build.CSRC, STAMPS, earlier=False),
            "device_us": {"x".join(map(str, v.shape)): device_us(
                lambda v=v: R.tree_sum_cuda(v, square=True, root=True), "tree_sum_kernel")
                for v in (torch.rand(s, generator=gen).to(dev) - 0.5 for s in K6_SHAPES)},
        },
    }
    if args.k6_earlier:
        earlier = Path(args.k6_earlier)
        result["k6"]["earlier_phases"] = k6_phases(dev, earlier, EARLIER_STAMPS, earlier=True)
        result["k6"]["device_us_in_turns"] = k6_turns(dev, earlier)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
