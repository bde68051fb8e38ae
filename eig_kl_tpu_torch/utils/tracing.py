"""Named wall-clock spans.

The reference times its phases with manual ``chrono`` spans
(cEIG.cpp:139,223-227; cKL.cpp:335,368-378).  On the card PyTorch
returns before the device finishes, so a span on a CUDA device
synchronises before it reads the clock at either end: the span then
measures the device work of its region, not the enqueue.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Tracer:
    """Named wall-clock spans; spans of the same name accumulate."""

    def __init__(self, device: torch.device | None = None):
        self.spans: dict[str, float] = {}
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
