"""Port, flight-log analysis (``sim/analyze.py``) on the CPU.

- post-hoc renders to PNG from an ``.npz`` flight log, a PX4 ``.ulg`` and a
  router ``.tlog`` through the port's ``io/flight_log.py`` and
  ``io/ulog.py`` (the 3-D scene too); matplotlib is imported only inside
  the renders, so these tests skip without it;
- ``LiveMonitor`` against the JAX tool's (``tools/analyze.py``, loaded by
  path: it is no package): the same messages give the same window and the
  same ``summary()`` line, rendered or not;
- ``--live`` on a bound UDP address: frames sent to it reach the monitor
  through the port's ``MavlinkUDP`` and the overlay is written.
"""
import importlib.util
import os
import socket
import threading
import time

import numpy as np
import pytest

from sde4mbrl_px4_tpu_torch.io import mavlink as M
from sde4mbrl_px4_tpu_torch.io.flight_log import FlightRecorder
from sde4mbrl_px4_tpu_torch.io.router import FrameLog
from sde4mbrl_px4_tpu_torch.sim import analyze as A


def _recorder(n=40):
    rec = FlightRecorder()
    for k in range(n):
        x = np.zeros(13, np.float32)
        x[0], x[6], x[10] = 0.1 * k, 1.0, 0.05 * np.sin(0.3 * k)
        rec.record(t=k * 0.02, state=x, cmd_motors=np.full(6, 0.7),
                   cmd_thrust_rates=np.array([0.7, 0.1, 0, 0], np.float32),
                   ref=np.zeros(13, np.float32), motors=np.full(4, 0.69),
                   solve_time=0.004, num_steps=12, mpc_on=3, weight_motors=100)
    return rec


def _tlog(path, n=40):
    fl = FrameLog(path, mode="always")
    for k in range(n):
        if k % 2:
            fl.log(M.encode_motors_cmd(int(1e6 * (1 + 0.02 * k)), np.full(6, 0.6),
                                       [0.6, 0.1, -0.1, 0.0], 3, 100))
        st = np.zeros(13, np.float32)
        st[0], st[6] = 0.1 * k, 1.0
        fl.log(M.encode_full_state(int(1e6 * (1 + 0.02 * k)), st, np.full(4, 0.6), seq=k))
    fl.close()


@pytest.mark.parametrize("suffix", [".npz", ".ulg", ".tlog"])
def test_analyze_renders_each_log_kind(tmp_path, suffix):
    pytest.importorskip("matplotlib")
    log = str(tmp_path / f"flight{suffix}")
    if suffix == ".tlog":
        _tlog(log)
    else:
        _recorder().save(log)
    out = str(tmp_path / "flight.png")
    assert A.main([log, "-o", out, "--scene"]) == 0
    assert os.path.getsize(out) > 10_000
    assert os.path.getsize(str(tmp_path / "flight_scene.png")) > 10_000


def _jax_tool(repo_root):
    spec = importlib.util.spec_from_file_location(
        "jax_tools_analyze", os.path.join(repo_root, "tools", "analyze.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_live_monitor_summary_equals_jax_tool(repo_root, tmp_path):
    pytest.importorskip("matplotlib")
    J = _jax_tool(repo_root)
    a, b = A.LiveMonitor(window_s=2.0), J.LiveMonitor(window_s=2.0)
    assert a.summary() == b.summary() and "waiting" in a.summary()
    rs = np.random.RandomState(0)
    for k in range(160):
        t_us = k * 0.02 * 1e6 + rs.randint(1000)
        x = rs.randn(13).astype(np.float32)
        m4 = rs.rand(4).astype(np.float32) if k % 3 else None
        for mon in (a, b):
            mon.ingest_state(t_us, x, motors4=m4)
        if k % 2:
            u6, tr = rs.rand(6).astype(np.float32), rs.randn(4).astype(np.float32)
            for mon in (a, b):
                mon.ingest_cmd(t_us + 500, u6, tr)
        if k % 40 == 39:
            assert a.summary() == b.summary()
    assert "rate err" in a.summary() and a.ach[-1][0] - a.ach[0][0] <= 2.0 + 1e-6
    assert [r[0] for r in a.ach] == [r[0] for r in b.ach]
    assert [r[0] for r in a.cmd] == [r[0] for r in b.cmd]
    out = str(tmp_path / "live.png")
    assert a.render(out) and os.path.getsize(out) > 10_000
    assert a.render_scene(str(tmp_path / "live_scene.png"), ref_xyz=np.zeros((5, 3)))


def test_live_main_reads_the_tap(tmp_path):
    pytest.importorskip("matplotlib")
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    out = str(tmp_path / "tap.png")
    th = threading.Thread(target=A.live_main, args=(f"127.0.0.1:{port}", out),
                          kwargs=dict(refresh_s=0.2, duration_s=2.0), daemon=True)
    th.start()
    time.sleep(0.3)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as src:
        for k in range(40):
            st = np.zeros(13, np.float32)
            st[6] = 1.0
            src.sendto(bytes(M.encode_full_state(int(1e6 + 2e4 * k), st)), ("127.0.0.1", port))
            src.sendto(bytes(M.encode_motors_cmd(int(1e6 + 2e4 * k), np.full(6, 0.5),
                                                 [0.5, 0, 0, 0], 3, 100)), ("127.0.0.1", port))
            time.sleep(0.01)
    th.join(timeout=10)
    assert not th.is_alive() and os.path.getsize(out) > 10_000
