"""What limits K1 and K6 on the card, at the main path's shapes.

Run from the repository root on a machine with one CUDA card::

    python3 tools/k1_k6_floors.py

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

K6 (``csrc/tree_sum.cu``): a copy of the source under the same directory
with ``%globaltimer`` stamps written by thread 0 of each block (at the
block's start, after its round-1 window sums and fence, and in the last
block after its ticket, each later round and the result), run on the
1-D norm over 201,920 values and the 2-D norm over (1584, 128): per
phase, nanoseconds from the kernel's first block start (median of 5
launches), beside the committed kernel's device time per launch.  The
committed sources stay as they are.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import device_us_per_launch  # noqa: E402
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
STAMP = r"""__device__ unsigned long long* k6_stamps;
__device__ __forceinline__ void k6_stamp(int slot) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    k6_stamps[blockIdx.x * 8 + slot] = t;
  }
}
"""
# (anchor in tree_sum.cu, what goes after it): slot 0 the block's start,
# 1 its round 1 fenced, 2 the last block's ticket, 2 + k its round k + 1,
# 7 the result written.
STAMPS = (
    ("  const Input input{v, w, mode};\n", "  k6_stamp(0);\n"),
    ("    __threadfence();  // this block's window sums, before its ticket\n  }\n", "  k6_stamp(1);\n"),
    ("  if (!last) return;\n  __threadfence();\n", "  k6_stamp(2);\n"),
    ("    run_round(Partials{src}, round, dst, tile, warp, kWarps, lane);\n    __syncthreads();\n", "    k6_stamp(2 + k);\n"),
    ("    *ticket = 0u;\n", "    k6_stamp(7);\n"),
)


def nvcc_build(name: str, source: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(source)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return ctypes.CDLL(str(lib))


def device_us(fn, kernel: str, reps: int = 100) -> float:
    """Mean device time in microseconds of the kernels named ``kernel``
    over ``reps`` calls of ``fn`` (profiler)."""
    us = device_us_per_launch(lambda: [fn() for _ in range(reps)], kernel)
    if us is None:
        raise RuntimeError(f"the profiler recorded no {kernel} kernel")
    return us[0]


def k6_phases(dev) -> dict:
    source = (REPO / "eig_kl_tpu_torch" / "csrc" / "tree_sum.cu").read_text()
    source = source.replace("namespace {\n", STAMP + "namespace {\n", 1)
    for anchor, stamp in STAMPS:
        if source.count(anchor) != 1:
            raise RuntimeError(f"tree_sum.cu has no single place for {stamp.strip()}")
        source = source.replace(anchor, anchor + stamp)
    source += ('\nextern "C" int set_stamps(void* p) {\n'
               '  cudaMemcpyToSymbol(k6_stamps, &p, sizeof(p));\n'
               '  return static_cast<int>(cudaGetLastError());\n}\n')
    lib = nvcc_build("tree_sum_stamped", source)
    fn = lib.tree_sum_f32
    fn.argtypes, fn.restype = R.K6.argtypes, ctypes.c_int
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    stamps = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    lib.set_stamps(stamps.data_ptr())
    gen = torch.Generator(device="cpu").manual_seed(42)
    out = {}
    for shape in ((201_920,), (1584, 128)):
        v = (torch.rand(shape, generator=gen) - 0.5).to(dev)
        plan, scratch_len, second = R.k6_plan(shape)
        runs = []
        for _ in range(5):
            stamps.zero_()
            scratch = torch.empty(scratch_len, device=dev)
            res = torch.empty((), device=dev)
            stream = torch.cuda.current_stream(dev)
            code = fn(v.data_ptr(), v.data_ptr(), 1, ctypes.addressof(plan), scratch.data_ptr(), second,
                      R._ticket(dev, stream).data_ptr(), res.data_ptr(), 1, stream.cuda_stream)
            if code != 0:
                raise RuntimeError(f"stamped K6 failed: CUDA error {code}")
            torch.cuda.synchronize()
            if not torch.equal(res.view(torch.int32), R.tree_sum_cuda(v, square=True, root=True).view(torch.int32)):
                raise AssertionError("the stamped K6 differs from K6")
            d = stamps.view(-1, 8).cpu().numpy().astype(np.int64)
            d = d[d[:, 0] > 0]
            t0 = d[:, 0].min()
            last = d[d[:, 2] > 0][0]
            runs.append([np.median(d[:, 1]) - t0, d[:, 1].max() - t0, last[2] - t0]
                        + [last[c] - t0 if last[c] else np.nan for c in (3, 4, 5)] + [last[7] - t0])
        med = np.median(np.array(runs, dtype=np.float64), axis=0)
        names = ("round 1 fenced, median block", "round 1 fenced, last block", "ticket taken",
                 "round 2", "round 3", "round 4", "result written")
        out["x".join(map(str, shape))] = {
            "blocks": int(len(d)),
            "rounds": [list(r.windows) for r in R.reduce_rounds(shape)],
            "ns_from_start": {k: None if np.isnan(t) else float(t) for k, t in zip(names, med)},
            "device_us_committed": device_us(lambda v=v: R.tree_sum_cuda(v, square=True, root=True), "tree_sum_kernel"),
        }
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tools/k1_k6_floors.py needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build(("spmv_csr", "tree_sum"))
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
        "k6": k6_phases(dev),
    }
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
