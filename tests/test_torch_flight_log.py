"""Port parity, flight logs: ``io/flight_log.py`` and ``io/ulog.py`` of the
port against the JAX package's (both numpy, so the checks are exact).

- ``FlightRecorder`` round trips through ``.npz`` and ``.ulg``;
- the ``.ulg`` bytes the port writes equal the JAX writer's for the same
  log (``flight_log_to_ulog``, ``write_ulog``, ``FlightRecorder.save``);
- ``read_ulog`` reads a file the JAX package wrote as the JAX reader does;
- ``tlog_to_flight_log`` on a ``.tlog`` built from the port's MAVLink
  frames equals the JAX package's, a truncated tail included;
- the twins of ``tests/test_ulog.py``'s cases (parametrised where they
  repeat), each also held to the JAX package's output on the same bytes;
- ``sim/closed_loop.py --log`` on the CPU writes a ``.ulg`` that reads back.
"""
import os
import struct

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from sde4mbrl_px4_tpu.io import flight_log as JF
from sde4mbrl_px4_tpu.io import ulog as JU
from sde4mbrl_px4_tpu_torch.io import flight_log as TF
from sde4mbrl_px4_tpu_torch.io import ulog as TU
from sde4mbrl_px4_tpu_torch.io.mavlink import encode_full_state, encode_motors_cmd


def _mklog(n=50, dt=0.02):
    t = np.arange(n) * dt
    state = np.zeros((n, 13), np.float32)
    state[:, 0] = np.sin(t)
    state[:, 2] = -1.0
    state[:, 6] = 1.0
    state[:, 10] = 0.3 * np.cos(t)
    return {
        "t": t,
        "state": state,
        "cmd_motors": np.tile(np.linspace(0.3, 0.8, 6, dtype=np.float32), (n, 1)),
        "cmd_thrust_rates": np.tile(np.array([0.55, 0.1, -0.2, 0.05], np.float32), (n, 1)),
        "ref": np.zeros((n, 13), np.float32),
        "mpc_on": np.full(n, 5),
        "weight_motors": np.full(n, 100),
        "solve_time": np.full(n, 0.01, np.float32),
        "num_steps": np.full(n, 40),
        "opt_cost": np.full(n, 1.5, np.float32),
        "mpc_indx": np.zeros(n, np.int64),
    }


def _recorded(mod, n=12, seed=0):
    """A recorder of ``mod`` (either package's) filled with the same rows:
    every field, the first row before any command."""
    rs = np.random.RandomState(seed)
    r = mod.FlightRecorder()
    for k in range(n):
        x = rs.randn(13).astype(np.float32)
        r.record(k * 0.02, x, motors=rs.rand(4).astype(np.float32),
                 cmd_motors=None if k == 0 else rs.rand(6).astype(np.float32),
                 cmd_thrust_rates=None if k == 0 else rs.randn(4).astype(np.float32),
                 ref=None if k < 3 else rs.randn(13).astype(np.float32),
                 mpc_on=k % 3, weight_motors=100, solve_time=0.001 * k, num_steps=k,
                 opt_cost=0.5 * k, mpc_indx=k % 2)
    return r


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _msg(t, payload):
    return struct.pack("<HB", len(payload), ord(t)) + payload


def test_recorder_arrays_equal_jax():
    a, b = _recorded(TF).arrays(), _recorded(JF).arrays()
    _assert_same_tree(a, b)
    assert len(_recorded(TF)) == 12


@pytest.mark.parametrize("suffix", [".npz", ".ulg"])
def test_recorder_round_trip(tmp_path, suffix):
    """.npz: every field back bit for bit; .ulg: state, commands and time
    through ``ulog_to_flight_log``, as the JAX package's reader gives them."""
    r = _recorded(TF)
    p = str(tmp_path / ("f" + suffix))
    r.save(p)
    if suffix == ".npz":
        _assert_same_tree(TF.load_flight_log(p), r.arrays())
        _assert_same_tree(TF.load_flight_log(p), JF.load_flight_log(p))
        return
    back = TU.ulog_to_flight_log(p)
    _assert_same_tree(back, JU.ulog_to_flight_log(p))
    log = r.arrays()
    np.testing.assert_allclose(back["t"], log["t"], atol=2e-6)
    np.testing.assert_array_equal(back["state"], log["state"])
    np.testing.assert_allclose(back["cmd_motors"][:, :4], log["motors"], atol=0)


@pytest.mark.parametrize("case", ["bridge", "recorder", "topics", "achieved"])
def test_ulg_bytes_equal_the_jax_writer(tmp_path, case):
    """The same log written by each package gives the same file, byte for
    byte: the bridge export, a recorder's save, bare topics, and a log
    with achieved motors."""
    pa, pb = str(tmp_path / "port.ulg"), str(tmp_path / "jax.ulg")
    if case == "bridge":
        TU.flight_log_to_ulog(_mklog(), pa)
        JU.flight_log_to_ulog(_mklog(), pb)
    elif case == "recorder":
        _recorded(TF).save(pa)
        _recorded(JF).save(pb)
    elif case == "topics":
        topics = {"demo_topic": {
            "timestamp": (np.arange(10) * 1000).astype(np.uint64),
            "val": np.linspace(0, 1, 10).astype(np.float32),
            "vec": np.arange(30, dtype=np.float32).reshape(10, 3),
            "cnt": np.arange(10, dtype=np.int64), "u": np.arange(10, dtype=np.uint16),
            "flag": np.array([True, False] * 5)}}
        TU.write_ulog(pa, topics, start_ts_usec=123)
        JU.write_ulog(pb, topics, start_ts_usec=123)
    else:
        log = _mklog(n=12)
        log["motors"] = np.tile(np.linspace(0.31, 0.61, 4, dtype=np.float32), (12, 1))
        TU.flight_log_to_ulog(log, pa)
        JU.flight_log_to_ulog(log, pb)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        a, b = fa.read(), fb.read()
    assert len(a) > 100 and a == b


def test_read_ulog_reads_a_jax_written_file(tmp_path):
    p = str(tmp_path / "j.ulg")
    _recorded(JF, n=30, seed=3).save(p)
    _assert_same_tree(TU.read_ulog(p), JU.read_ulog(p))
    _assert_same_tree(TU.ulog_to_flight_log(p), JU.ulog_to_flight_log(p))


def _write_tlog(path, n=20, truncate=0):
    """A router capture: 8-byte big-endian wall stamps, then MAVLink v2
    frames from the port's codec — states at 50 Hz, a command every other
    state, the first command after the third state."""
    rs = np.random.RandomState(5)
    blob = b""
    for k in range(n):
        x = rs.randn(13).astype(np.float32)
        frames = [encode_full_state(1000 + 20000 * k, x, rs.rand(4), seq=k)]
        if k >= 3 and k % 2:
            frames.append(encode_motors_cmd(1000 + 20000 * k + 5000, rs.rand(6), rs.randn(4),
                                            mpc_on=k % 4, weight_motors=100, seq=k))
        for fr in frames:
            blob += struct.pack(">Q", 7_000_000 + k) + fr
    with open(path, "wb") as f:
        f.write(blob[:len(blob) - truncate])


@pytest.mark.parametrize("truncate", [0, 7])
def test_tlog_to_flight_log_equals_jax(tmp_path, truncate):
    p = str(tmp_path / "cap.tlog")
    _write_tlog(p, truncate=truncate)
    a = TF.tlog_to_flight_log(p)
    _assert_same_tree(a, JF.tlog_to_flight_log(p))
    # the cut frame is the last command: every state row stays, one frame less
    assert len(a["t"]) == 20 and len(list(TF.read_tlog(p))) == 29 - bool(truncate)
    np.testing.assert_allclose(a["t"][:2], [0.001, 0.021])
    assert (a["cmd_motors"][:4] == 0).all() and (a["cmd_motors"][4] != 0).any()
    assert [r for r in TF.read_tlog(p)] == [r for r in _read_jax_tlog(p)]


def _read_jax_tlog(path):
    from sde4mbrl_px4_tpu.io.router import read_tlog

    return read_tlog(path)


def test_tlog_without_states_raises(tmp_path):
    p = str(tmp_path / "empty.tlog")
    with open(p, "wb") as f:
        f.write(struct.pack(">Q", 1) + encode_motors_cmd(1, np.zeros(6), np.zeros(4), 0, 0))
    with pytest.raises(ValueError, match="no decodable"):
        TF.tlog_to_flight_log(p)


# ---- the twins of tests/test_ulog.py -----------------------------------------


@pytest.mark.parametrize("mod", [TU, JU], ids=["port_reads", "jax_reads"])
def test_write_read_roundtrip(tmp_path, mod):
    """The port's writer, read back by each package's reader."""
    p = str(tmp_path / "t.ulg")
    topics = {"demo_topic": {
        "timestamp": (np.arange(10) * 1000).astype(np.uint64),
        "val": np.linspace(0, 1, 10).astype(np.float32),
        "vec": np.arange(30, dtype=np.float32).reshape(10, 3),
        "flag": np.array([True] * 10)}}
    TU.write_ulog(p, topics, start_ts_usec=123)
    out = mod.read_ulog(p)
    assert out["start_timestamp"] == 123
    d = out["data"]["demo_topic"]
    np.testing.assert_array_equal(d["timestamp"], topics["demo_topic"]["timestamp"])
    np.testing.assert_allclose(d["val"], topics["demo_topic"]["val"])
    np.testing.assert_allclose(d["vec"], topics["demo_topic"]["vec"])
    assert d["flag"].all()


def test_flight_log_ulog_bridge_roundtrip(tmp_path):
    log = _mklog()
    p = str(tmp_path / "flight.ulg")
    TU.flight_log_to_ulog(log, p)
    back = TU.ulog_to_flight_log(p)
    np.testing.assert_allclose(back["t"], log["t"], atol=2e-6)
    np.testing.assert_allclose(back["state"][:, :13], log["state"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back["cmd_motors"], log["cmd_motors"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back["cmd_thrust_rates"], log["cmd_thrust_rates"],
                               rtol=1e-5, atol=1e-5)
    assert np.isnan(back["ref"]).all()       # "no reference" is NaN in the schema


def test_ulog_tolerates_unknown_and_nested_messages(tmp_path):
    p = str(tmp_path / "x.ulg")
    TU.write_ulog(p, {"ok_topic": {"timestamp": np.array([1, 2], np.uint64),
                                   "v": np.array([0.5, 0.75], np.float32)}})
    raw = bytearray(open(p, "rb").read())
    raw += _msg("F", b"nested_topic:uint64_t timestamp;my_struct_t s;")
    raw += _msg("A", struct.pack("<BH", 0, 77) + b"nested_topic")
    raw += _msg("D", struct.pack("<H", 77) + b"\x00" * 16)
    key = b"char[3] foo"
    raw += _msg("I", bytes([len(key)]) + key + b"bar")
    raw += _msg("Z", b"\x01\x02")
    open(p, "wb").write(bytes(raw))
    out = TU.read_ulog(p)
    assert "ok_topic" in out["data"] and "nested_topic" not in out["data"]
    assert out["info"].get("char[3] foo") == b"bar"
    _assert_same_tree(out, JU.read_ulog(p))


@pytest.mark.parametrize("cut", [1, 5, 13])
def test_ulog_truncated_tail(tmp_path, cut):
    """A log cut mid-message keeps everything before the cut."""
    p = str(tmp_path / "t.ulg")
    TU.write_ulog(p, {"tp": {"timestamp": np.arange(20, dtype=np.uint64),
                             "v": np.arange(20, dtype=np.float32)}})
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-cut])
    out = TU.read_ulog(p)
    assert len(out["data"]["tp"]["v"]) >= 19
    _assert_same_tree(out, JU.read_ulog(p))


@pytest.mark.parametrize("blob", [b"NOTAULOGFILE" * 4, b"ULog\x01\x12\x35", b""])
def test_read_rejects_non_ulog(tmp_path, blob):
    p = str(tmp_path / "bad.ulg")
    open(p, "wb").write(blob)
    with pytest.raises(ValueError):
        TU.read_ulog(p)


def test_flight_recorder_saves_ulg(tmp_path):
    r = TF.FlightRecorder()
    for k in range(10):
        r.record(k * 0.02, np.r_[np.zeros(6), 1.0, np.zeros(6)].astype(np.float32),
                 cmd_motors=np.full(6, 0.5, np.float32))
    p = str(tmp_path / "f.ulg")
    r.save(p)
    d = TU.read_ulog(p)["data"]
    assert len(d["vehicle_local_position"]["timestamp"]) == 10
    np.testing.assert_allclose(d["actuator_motors"]["control"], 0.0)
    np.testing.assert_allclose(d["mpc_motors_cmd"]["motor_val_des"][:, 0], 0.5)


@settings(max_examples=100, deadline=None)
@given(st.binary(min_size=0, max_size=256))
def test_read_ulog_random_bytes_never_crash(tmp_path_factory, data):
    """Arbitrary bytes: parsed or rejected with ValueError, as the JAX reader."""
    p = str(tmp_path_factory.mktemp("fz") / "f.ulg")
    open(p, "wb").write(data)
    try:
        out = TU.read_ulog(p)
    except ValueError:
        with pytest.raises(ValueError):
            JU.read_ulog(p)
        return
    _assert_same_tree(out, JU.read_ulog(p))


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=0, max_size=192))
def test_read_ulog_valid_header_garbage_body(tmp_path_factory, data):
    p = str(tmp_path_factory.mktemp("fz") / "g.ulg")
    open(p, "wb").write(b"ULog\x01\x12\x35\x01" + struct.pack("<Q", 42) + data)
    out = TU.read_ulog(p)
    assert out["start_timestamp"] == 42
    _assert_same_tree(out, JU.read_ulog(p))


def test_trailing_padding_elided_like_px4(tmp_path):
    p = str(tmp_path / "pad.ulg")
    body = _msg("F", b"pt:uint64_t timestamp;float v;uint8_t[3] _padding0;")
    body += _msg("A", struct.pack("<BH", 0, 0) + b"pt")
    for k in range(4):
        body += _msg("D", struct.pack("<H", 0) + struct.pack("<Qf", 1000 * k, 0.5 * k))
    open(p, "wb").write(b"ULog\x01\x12\x35\x01" + struct.pack("<Q", 7) + body)
    d = TU.read_ulog(p)["data"]["pt"]
    np.testing.assert_array_equal(d["timestamp"], [0, 1000, 2000, 3000])
    np.testing.assert_allclose(d["v"], [0.0, 0.5, 1.0, 1.5])


def test_mpc_motors_cmd_topic_and_achieved_motors(tmp_path):
    log = _mklog(n=12)
    log["motors"] = np.tile(np.linspace(0.31, 0.61, 4, dtype=np.float32), (12, 1))
    p = str(tmp_path / "cmd.ulg")
    TU.flight_log_to_ulog(log, p)
    d = TU.read_ulog(p)["data"]
    np.testing.assert_allclose(d["mpc_motors_cmd"]["motor_val_des"], log["cmd_motors"], atol=1e-6)
    np.testing.assert_allclose(d["mpc_motors_cmd"]["thrust_and_angrate_des"],
                               log["cmd_thrust_rates"], atol=1e-6)
    assert np.all(d["mpc_motors_cmd"]["mpc_on"] == 5)
    np.testing.assert_allclose(d["actuator_motors"]["control"], log["motors"], atol=1e-6)
    p2 = str(tmp_path / "legacy.ulg")
    TU.flight_log_to_ulog(_mklog(n=12), p2)
    np.testing.assert_allclose(TU.read_ulog(p2)["data"]["actuator_motors"]["control"],
                               _mklog(n=12)["cmd_motors"], atol=1e-6)


@pytest.mark.parametrize("name", ["pj_mpc_tracking.xml", "pj_mpc_cmd_vs_achieved.xml",
                                  "pj_mpc_cmd_vs_achieved_v2.xml"])
def test_committed_layout_matches_exported_topics(repo_root, tmp_path, name):
    """Every shipped PlotJuggler layout names only topics and fields the
    port's export writes."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(os.path.join(repo_root, "configs", "layouts", name))
    curves = [c.get("name") for c in tree.iter("curve")]
    curves += [c.get("curve_x") for c in tree.iter("curve") if c.get("curve_x")]
    assert len(set(curves)) >= 15
    p = str(tmp_path / "layout_check.ulg")
    TU.flight_log_to_ulog(_mklog(), p)
    data = TU.read_ulog(p)["data"]
    for ref in curves:
        topic, _, field = ref.strip("/").partition("/")
        base, _, idx = field.partition(".")
        assert topic in data and base in data[topic], ref


def test_closed_loop_writes_a_flight_log(repo_root, tmp_path):
    """``sim/closed_loop.py --cpu --log x.ulg`` on the tiny H = 5 configs
    records every tick and writes a ULog that reads back with the engine's
    commands in it."""
    from sde4mbrl_px4_tpu_torch.sim import closed_loop

    paths = []
    for with_traj in (True, False):
        cfg = yaml.safe_load(open(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml")))
        cfg.update(horizon=5, num_short_dt=5,
                   learned_model_params=os.path.join(repo_root, "configs/models/iris_sde.pkl"))
        cfg["apg_mpc"].update(max_iter=10, max_no_improvement_iter=10)
        if with_traj:
            cfg["trajectory_path"] = os.path.join(repo_root, "configs/trajs/lemniscate.csv")
        p = tmp_path / ("traj.yaml" if with_traj else "pos.yaml")
        p.write_text(yaml.safe_dump(cfg))
        paths.append(str(p))
    log = str(tmp_path / "flight.ulg")
    res = closed_loop.run(["--cpu", "--seconds", "2", "--time-scale", "3", "--log", log,
                           "--traj-config", paths[0], "--pos-config", paths[1]])
    assert res["log_records"] == 100 and os.path.exists(log)
    back = TU.ulog_to_flight_log(log)
    assert back["state"].shape == (100, 13) and np.isfinite(back["state"]).all()
    assert (np.abs(back["cmd_motors"]).sum(axis=1) > 0).any()
