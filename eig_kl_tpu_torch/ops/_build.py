"""Build and load the hand-written CUDA kernels and the host library in
``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).
The host library ``csrc/eigkl_native.cpp`` (parser, clique expansion,
Benes router; :mod:`eig_kl_tpu_torch.io.native_io`) compiles the same
way with the host C++ compiler and no CUDA.  Libraries go into
``eig_kl_tpu_torch/_build/``, named by a hash of the source and the
headers of ``csrc/`` it includes, the flags, the compiler (its path and
``--version``) and the platform, so a library built on one machine, or
from another header, is not loaded; they are built at first use.  :func:`build` starts one compiler
per source, all at once.

Nothing here touches CUDA when the module is imported.  Every C entry
point returns ``cudaGetLastError()`` after its launch; :class:`Kernel`
raises if that is not 0, and only then counts the launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
HOST_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared")
KERNEL_SOURCES = ("spmv_csr", "kl_pass", "spmv_v3", "fma_dot", "smega", "tree_sum", "select")
HOST_SOURCES = ("eigkl_native",)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++) found: set CXX")


def _source(name: str) -> tuple[Path, tuple[str, ...], str]:
    """The source file of ``name``, its compiler flags and its compiler."""
    if name in HOST_SOURCES:
        return CSRC / f"{name}.cpp", HOST_FLAGS, _cxx()
    return CSRC / f"{name}.cu", NVCC_FLAGS, _nvcc()


@functools.lru_cache(maxsize=None)
def _compiler_identity(compiler: str) -> str:
    """The compiler's resolved path and its ``--version`` output."""
    out = subprocess.run(
        [compiler, "--version"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=60,
    ).stdout
    return f"{os.path.realpath(compiler)}\n{out}"


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def included_headers(src: Path) -> list[Path]:
    """The headers beside ``src`` that it includes with ``#include "..."``,
    directly or through another of them, each once, in the order first
    met."""
    found, todo = [], [src]
    while todo:
        here = todo.pop(0)
        for name in _INCLUDE.findall(here.read_bytes()):
            header = here.parent / name.decode()
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (or ``.cpp``) lives."""
    src, flags, compiler = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in included_headers(src):
        digest.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    for part in (" ".join(flags), _compiler_identity(compiler), platform.platform()):
        digest.update(b"\0" + part.encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build every named library that is missing, in parallel.

    Returns the compiler's output per source built (for a kernel, its
    register and shared memory use, from ``-Xptxas -v``); raises if any
    build fails.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src, flags, compiler = _source(name)
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (compiler exit {proc.returncode}):\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if missing,
    loaded once per process."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def stream_handle(device: torch.device) -> int:
    """The current stream of the CUDA ``device`` as the handle an entry
    point takes: the value of ``torch.cuda.current_stream(device).cuda_stream``,
    read without building the Python stream object, which costs the host
    more than a launch of the momentum step's small kernels.  A device
    without an index is the current one, as for ``current_stream``."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if index is None else index)


class Kernel:
    """One C entry point of a built library, with its launch count.

    ``launches`` is a plain integer: the wrapper that launches the kernel
    adds one per kernel launched by a successful call, and nothing else
    changes it except a caller resetting it to 0.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._err = None

    def _load(self):
        lib = library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, *args, launches: int = 1) -> None:
        """Call the entry point; ``launches`` is the number of kernels it
        launches (an entry point may launch a kernel more than once)."""
        if self._fn is None:
            self._load()
        code = self._fn(*args)
        if code != 0:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {code} ({msg})")
        self.launches += launches
