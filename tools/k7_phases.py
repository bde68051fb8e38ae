"""Where a launch of K7 (``eig_kl_tpu_torch/csrc/select.cu``, the exact rank
select) spends its time.

Run from the repository root on a machine with one CUDA card::

    python3 tools/k7_phases.py

It builds ``select.cu`` three more times into
``eig_kl_tpu_torch/_build/k7_phases/``: with ``-DK7_STAMPS`` (thread 0 of
block 0 writes its ``clock64`` at each phase, ``select.cu:k7_stamp``), with
``-DK7_SMALL_MAX=0`` (every size takes the cooperative grid form, as all
sizes above 2,048 did before the one-block form), and with both.  The
committed source stays as it is.  For each vector (standard normal from a
seed, where the rounds stop early, and values drawn from {0, 1, 2}, where
the median's bin never holds one key and every round runs) at 4,038
values (gen 0.02x) and 201,920 (gen 1.0x), in f32 and f64, it prints:

* the device time per launch (profiler, 100 launches) of the committed K7,
  of the grid form at 4,038 values, in turns (K7, grid, grid, K7), and of
  ``torch.kthvalue``;
* per round, the cycles from the start at which block 0 had counted its
  keys, had the round's totals (grid form: after the grid barrier) and had
  picked the digit, and when the result was written; the median of 5
  launches, with the SM clock the launch ran at (cycles over
  ``%globaltimer`` nanoseconds from the start to the result).

Every result is checked against ``sort(v)[k]``.  It writes the JSON it
prints to ``chiprun_out/k7_phases.json``.
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

from chip_smoke import device_us_per_launch, library_device_us  # noqa: E402
from eig_kl_tpu_torch.ops import _build  # noqa: E402
from eig_kl_tpu_torch.ops.select import K7, K7_SCRATCH_WORDS, kth_smallest_cuda  # noqa: E402

OUT = REPO / "eig_kl_tpu_torch" / "_build" / "k7_phases"
VARIANTS = {"stamped": ["-DK7_STAMPS"], "grid": ["-DK7_SMALL_MAX=0"], "grid_stamped": ["-DK7_STAMPS", "-DK7_SMALL_MAX=0"]}
SIZES = (4038, 201_920)
SLOTS = 28


def build_variants() -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "select.cu"
    procs = {
        name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(OUT / f"{name}.so"), str(src)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()
    }
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"building the {name} variant failed:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        for t in ("f32", "f64"):
            getattr(libs[name], f"kth_smallest_{t}").argtypes = K7.argtypes
    return libs


def launcher(lib, v: torch.Tensor, k: int):
    """A call of ``lib``'s K7 on ``v`` at rank ``k``: returns the 0-d result."""
    fn = getattr(lib, "kth_smallest_f32" if v.dtype == torch.float32 else "kth_smallest_f64")
    scratch = torch.zeros(K7_SCRATCH_WORDS, dtype=torch.int32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream

    def run():
        out = torch.empty((), dtype=v.dtype, device=v.device)
        code = fn(v.data_ptr(), v.shape[0], k, out.data_ptr(), scratch.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"K7 variant failed: CUDA error {code}")
        return out

    return run


def device_us(fn, kernel: str, reps: int = 100) -> float:
    for _ in range(2):  # a process's first profile can miss its kernels
        us = device_us_per_launch(lambda: [fn() for _ in range(reps)], kernel)
        if us is not None:
            return us[0]
    raise RuntimeError(f"the profiler recorded no {kernel} kernel")


def phases(lib, v: torch.Tensor, k: int, want: torch.Tensor) -> dict:
    """The stamps of 5 launches, each result checked against ``want``: per
    round the cycles from the start at which it was counted, merged and
    picked (medians), the result's cycle, and the SM clock in MHz."""
    stamps = torch.zeros(SLOTS, dtype=torch.int64, device=v.device)
    if lib.k7_set_stamps(ctypes.c_void_p(stamps.data_ptr())) != 0:
        raise RuntimeError("k7_set_stamps failed")
    run = launcher(lib, v, k)
    runs = []
    for _ in range(5):
        stamps.zero_()
        if not torch.equal(run(), want):
            raise AssertionError("a stamped variant differs from sort(v)[k]")
        torch.cuda.synchronize()
        runs.append(stamps.cpu().numpy().astype(np.int64))
    d = np.array(runs)
    rel = np.where(d[:, :26] > 0, d[:, :26] - d[:, :1], -1)
    med = np.median(rel, axis=0)
    rounds = []
    for r in range(8):
        counted, merged, picked = med[1 + 3 * r], med[2 + 3 * r], med[3 + 3 * r]
        if picked < 0:
            break
        rounds.append({"counted": float(counted), "merged": None if merged < 0 else float(merged),
                       "picked": float(picked)})
    mhz = np.median((d[:, 25] - d[:, 0]) / np.maximum(d[:, 27] - d[:, 26], 1) * 1e3)
    return {"rounds": rounds, "result_written": float(med[25]), "sm_mhz": float(mhz)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tools/k7_phases.py needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build(("select",))
    libs = build_variants()
    rng = np.random.default_rng(42)
    result = {"card": card, "cases": []}
    for n in SIZES:
        for data in ("normal", "ties"):
            base = rng.standard_normal(n) if data == "normal" else rng.integers(0, 3, n).astype(np.float64)
            for dtype in (torch.float32, torch.float64):
                v = torch.as_tensor(base).to(dtype).to(dev)
                k = n // 2
                want = torch.sort(v).values[k]
                check = {"K7": lambda: kth_smallest_cuda(v, k)}
                check["grid"] = launcher(libs["grid"], v, k)
                for name, fn in check.items():
                    if not torch.equal(fn(), want):
                        raise AssertionError(f"{name} differs from sort(v)[k] at {n} {data} {dtype}")
                case = {"n": n, "data": data, "dtype": str(dtype).split(".")[-1]}
                kernel = "kth_small" if n <= 8192 else "kth_smallest"
                if n <= 8192:
                    times = {"K7": [], "grid": []}
                    for name in ("K7", "grid", "grid", "K7"):
                        fn = check[name]
                        times[name].append(device_us(fn, kernel if name == "K7" else "kth_smallest"))
                    case["device_us"] = {name: min(t) for name, t in times.items()}
                    case["phases"] = {"K7": phases(libs["stamped"], v, k, want),
                                      "grid": phases(libs["grid_stamped"], v, k, want)}
                else:
                    case["device_us"] = {"K7": device_us(check["K7"], kernel)}
                    case["phases"] = {"K7": phases(libs["stamped"], v, k, want)}
                case["kthvalue_device_us"] = library_device_us(lambda: torch.kthvalue(v, k + 1), 20)
                result["cases"].append(case)
                print(json.dumps(case), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k7_phases.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
