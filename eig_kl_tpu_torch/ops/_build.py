"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).
Libraries go into ``eig_kl_tpu_torch/_build/``, named by a hash of the
source and the flags, and are built at first use.  :func:`build` starts
one ``nvcc`` per source, all at once.

Nothing here touches CUDA when the module is imported.  Every C entry
point returns ``cudaGetLastError()`` after its launch; :class:`Kernel`
raises if that is not 0, and only then counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
KERNEL_SOURCES = ("spmv_csr", "kl_pass")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build every named library that is missing, in parallel.

    Returns the compiler's output per source built (register and shared
    memory use, from ``-Xptxas -v``); raises if any build fails.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


class Kernel:
    """One C entry point of a built library, with its launch count.

    ``launches`` is a plain integer: the wrapper that launches the kernel
    adds one per successful launch, and nothing else changes it except a
    caller resetting it to 0.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._err = None

    def _load(self):
        build([self.source])
        lib = ctypes.CDLL(str(library_path(self.source)))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._load()
        code = self._fn(*args)
        if code != 0:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {code} ({msg})")
        self.launches += 1
