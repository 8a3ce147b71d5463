"""Port, ``engine/profiling.py`` (L5 aux) against the JAX package's:

- ``SolveTimer.stats()`` equals the JAX class's on the same samples (the
  window's drop of the oldest included), and an empty timer says so alike;
- ``trace(log_dir)`` writes a Chrome trace of the ops run inside it on the
  CPU, and raises where the profiler cannot start (the JAX ``trace`` turns
  that into a silent no-op: an intentional divergence).
"""
import json
import os

import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.engine.profiling import SolveTimer as JSolveTimer
from sde4mbrl_px4_tpu_torch.engine import profiling


def test_solve_timer_stats_match_jax():
    samples = np.random.RandomState(0).lognormal(-4.0, 0.5, size=300)
    port, ref = profiling.SolveTimer(window=256), JSolveTimer(window=256)
    assert port.stats() == ref.stats() == {"n": 0}
    assert port.last == ref.last == 0.0
    for s in samples:
        port.samples.append(float(s))
        ref.samples.append(float(s))
    got, want = port.stats(), ref.stats()
    assert got.keys() == want.keys() and got["n"] == want["n"] == 256
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    assert port.last == ref.last
    with port:
        pass
    assert port.stats()["n"] == 256 and 0.0 <= port.last < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as path:
        a = torch.ones(64, 64)
        (a @ a).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert os.path.dirname(path) == str(tmp_path / "t")
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_raises_where_the_profiler_cannot_start(tmp_path, monkeypatch):
    class Broken:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiling.trace(str(tmp_path / "t")):
            pass
