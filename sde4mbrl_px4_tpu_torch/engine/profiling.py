"""Profiling helpers (L5 aux).

PyTorch counterpart of ``sde4mbrl_px4_tpu/engine/profiling.py``:

- :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) of whatever runs inside, the
  card's kernels included where CUDA is up. Unlike the original's
  ``jax.profiler`` trace, which falls back to a silent no-op when the
  profiler cannot start, a profiler that fails to start raises here: a
  trace that was asked for and not taken is a failure, not a result;
- :class:`SolveTimer` — rolling per-solve latency statistics (p50/p99,
  jitter), copied from the original (``:45-76``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

__all__ = ["trace", "SolveTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Device-level profiler trace: ``with trace("traces/t") as path:
    solve(...)`` writes ``<log_dir>/trace.json`` (a Chrome trace) and yields
    its path. CPU activity always, CUDA activity where CUDA is available.
    The directory is the caller's: nothing is written elsewhere."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()                 # a profiler that cannot start raises here
    try:
        yield path
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)


class SolveTimer:
    """Rolling solve-latency tracker (the ``solve_time`` telemetry field,
    reference ``msg/OptMPCState.msg:23-24``, with percentile stats). Copied
    from ``sde4mbrl_px4_tpu/engine/profiling.py::SolveTimer``."""

    def __init__(self, window: int = 256):
        self.samples: Deque[float] = deque(maxlen=window)
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)
        return False

    @property
    def last(self) -> float:
        return self.samples[-1] if self.samples else 0.0

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {"n": 0}
        a = np.asarray(self.samples)
        return {
            "n": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
            "max_ms": float(a.max() * 1e3),
        }
