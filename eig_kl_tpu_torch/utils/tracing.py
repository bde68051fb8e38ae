"""Named wall-clock spans and the optional profiler capture.

The reference times its phases with manual ``chrono`` spans
(cEIG.cpp:139,223-227; cKL.cpp:335,368-378).  On the card PyTorch
returns before the device finishes, so a span on a CUDA device
synchronises before it reads the clock at either end: the span then
measures the device work of its region, not the enqueue.

:func:`maybe_profile` is the counterpart of the JAX package's
``jax.profiler`` capture (``eig_kl_tpu/utils/tracing.py:40-54``): with
``EIG_KL_TPU_PROFILE_DIR`` set it records the region with
``torch.profiler`` and writes one Chrome trace into that directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

#: The JAX package's variable; the port reads it under the same name.
PROFILE_DIR_ENV = "EIG_KL_TPU_PROFILE_DIR"


class Tracer:
    """Named wall-clock spans; spans of the same name accumulate, and
    ``counts`` holds the calls per span."""

    def __init__(self, device: torch.device | None = None):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._sync = device is not None and torch.device(device).type == "cuda"

    def _clock(self) -> float:
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        """A header, then one line per span by time, descending: the
        JAX ``Tracer.report()``'s format."""
        lines = [f"{'span':<28}{'calls':>8}{'seconds':>12}"]
        for name, secs in sorted(self.spans.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<28}{self.counts[name]:>8}{secs:>12.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def maybe_profile():
    """Record the region with ``torch.profiler`` if
    ``EIG_KL_TPU_PROFILE_DIR`` is set: the CPU's activity, and the card's
    where one is present.  On exit one Chrome trace,
    ``trace_<pid>_<ns>.json``, is written into that directory (made if
    missing).  Without the variable nothing is started or written."""
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
