"""Port, the MAVLink router (``io/router.py``) on the CPU.

- a case-for-case twin of ``tests/test_router.py`` (conf parsing, the
  id-filtered fan-out, the UART leg on a pty, the deframer, flight logs and
  their replay, the native core's arm gating and its safety after stop),
  py/native parametrised as there; the native cases skip with a reason
  when ``csrc/libmpc_native.so`` lacks the router (``make -C csrc``);
- parity with the JAX package's router: ``parse_conf`` / ``parse_general``
  give equal endpoint fields on the shipped confs and the reference-dialect
  strings; the ``Deframer`` gives the same frames from one byte stream
  (frames from a numpy seed, split at random points, with a corrupted
  length and a bad CRC in it); ``FrameLog`` files are byte-equal with the
  clock patched; the same frames through the JAX ``Router``, the port's
  ``Router`` and the port's ``NativeRouter`` reach each sink as the same
  multiset.
"""
import collections
import os
import socket
import time

import numpy as np
import pytest

from sde4mbrl_px4_tpu.io import router as JR
from sde4mbrl_px4_tpu_torch.io import mavlink as mav
from sde4mbrl_px4_tpu_torch.io import router as R
from sde4mbrl_px4_tpu_torch.io.router import Endpoint, Router, parse_conf

_REF_CONF = """
# The master node is exchanging data with the PX4 autopilot
[UdpEndpoint PX4]
\tMode = Server
\tAddress = 127.0.0.1
\tPort = 0

[UdpEndpoint Mavros]
\tMode = Normal
\tAddress = 127.0.0.1
\tPort = 0

[UdpEndpoint MPC]
\tMode = Normal
\tAddress = 127.0.0.1
\tPort = 0
\tAllowMsgIdIn = 368 # MPC_MOTORS_CMD
\tAllowMsgIdOut = 367 # MPC_FULL_STATE

[General]
\tTcpServerPort=5760
"""
# the reference's two topologies in its own dialect (names PX4 / Mavros /
# MPC, the MPC side-channel on 14998; the vehicle's FCU on a UART at 921600
# baud; logging present but commented out)
_REF_SITL_CONF = _REF_CONF.replace("Port = 0", "Port = 14550", 1).replace(
    "\tPort = 0\n\tAllowMsgIdIn", "\tPort = 14998\n\tAllowMsgIdIn").replace(
    "Port = 0", "Port = 14540") + "\t# Log = /var/log/flight\n\t# LogMode = while-armed\n"
_REF_HEXA_CONF = """
[UartEndpoint PX4]
\tDevice = /dev/ttyUSB0
\tBaud = 921600

[UdpEndpoint Mavros]
\tMode = Normal
\tAddress = 192.168.1.207
\tPort = 14540

[UdpEndpoint MPC]
\tMode = Normal
\tAddress = 192.168.1.207
\tPort = 14998
\tAllowMsgIdIn = 368 # MPC_MOTORS_CMD
\tAllowMsgIdOut = 367 # MPC_FULL_STATE

[General]
\tReportStats=false
"""


def _native_or_skip(symbol: str = "router_new"):
    lib = mav.load_native()
    if lib is None or not hasattr(lib, symbol):
        pytest.skip(f"native router lacks {symbol} (make -C csrc)")
    return lib


def test_parse_reference_conf_dialect():
    eps = parse_conf(_REF_CONF)
    assert [e.name for e in eps] == ["PX4", "Mavros", "MPC"]
    assert eps[0].mode == "Server" and eps[1].mode == "Normal"
    assert eps[2].allow_in == {368}
    assert eps[2].allow_out == {367}
    assert eps[0].allow_in is None  # unrestricted


def test_parse_shipped_reference_conf():
    eps = parse_conf(_REF_SITL_CONF)
    assert [e.name for e in eps] == ["PX4", "Mavros", "MPC"]
    mpc = eps[2]
    assert mpc.port == 14998 and mpc.allow_in == {368} and mpc.allow_out == {367}


@pytest.fixture(params=["py", "native"])
def topology(request):
    """FCU (server) + mavros-like sink + MPC sink with id filters, on
    ephemeral ports, over both implementations."""
    fcu = Endpoint("PX4", "127.0.0.1", 0, mode="Server")
    mavros_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mavros_sock.bind(("127.0.0.1", 0))
    mavros_sock.settimeout(1.0)
    mpc_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mpc_sock.bind(("127.0.0.1", 0))
    mpc_sock.settimeout(1.0)
    mavros_ep = Endpoint("Mavros", "127.0.0.1", mavros_sock.getsockname()[1])
    mpc_ep = Endpoint("MPC", "127.0.0.1", mpc_sock.getsockname()[1],
                      allow_in={368}, allow_out={367})
    if request.param == "native":
        _native_or_skip()
        r = R.NativeRouter([fcu, mavros_ep, mpc_ep])
        r.start()
        ports = {n: r.bound_port(n) for n in ("PX4", "Mavros", "MPC")}
    else:
        r = Router([fcu, mavros_ep, mpc_ep])
        r.start()
        ports = {e.name: e.bound_port for e in (fcu, mavros_ep, mpc_ep)}
    yield r, ports, mavros_sock, mpc_sock
    r.stop()
    mavros_sock.close()
    mpc_sock.close()


def test_fanout_with_id_filter(topology):
    r, ports, mavros_sock, mpc_sock = topology
    fcu_client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    state_frame = mav.encode_full_state(111, np.zeros(13, np.float32))
    hb_like = mav.encode_motors_cmd(5, [0.1] * 4, [0, 0, 0, 0], 0, 0)
    # id 367 goes to BOTH mavros and MPC (MPC allows 367 out)
    fcu_client.sendto(state_frame, ("127.0.0.1", ports["PX4"]))
    got_mavros, _ = mavros_sock.recvfrom(512)
    got_mpc, _ = mpc_sock.recvfrom(512)
    assert got_mavros == bytes(state_frame) and got_mpc == bytes(state_frame)
    # id 368 from the FCU: mavros receives it, the MPC endpoint filters it out
    fcu_client.sendto(hb_like, ("127.0.0.1", ports["PX4"]))
    assert mavros_sock.recvfrom(512)[0] == bytes(hb_like)
    with pytest.raises(socket.timeout):
        mpc_sock.settimeout(0.3)
        mpc_sock.recvfrom(512)
    fcu_client.close()


def test_mpc_reply_routes_back_to_fcu(topology):
    r, ports, mavros_sock, mpc_sock = topology
    fcu_client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    fcu_client.settimeout(1.0)
    fcu_client.bind(("127.0.0.1", 0))
    # teach the server endpoint its peer first (as the FCU would)
    fcu_client.sendto(mav.encode_full_state(1, np.zeros(13, np.float32)),
                      ("127.0.0.1", ports["PX4"]))
    mavros_sock.recvfrom(512)
    mpc_sock.recvfrom(512)
    # the MPC replies with id 368 INTO the router: it must reach the FCU peer
    cmd = mav.encode_motors_cmd(7, [0.7] * 4, [0.7, 0, 0, 0], 5, 100)
    mpc_sock.sendto(cmd, ("127.0.0.1", ports["MPC"]))
    msg = mav.decode_frame(fcu_client.recvfrom(512)[0])
    assert msg is not None and msg.get_type() == "MPC_MOTORS_CMD"
    assert msg.time_usec == 7
    fcu_client.close()


def test_mpc_inbound_filter_drops_wrong_ids(topology):
    """Id 367 arriving FROM the MPC endpoint is dropped (AllowMsgIdIn=368)."""
    r, ports, mavros_sock, mpc_sock = topology
    fcu_client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    fcu_client.settimeout(0.3)
    fcu_client.bind(("127.0.0.1", 0))
    state = mav.encode_full_state(1, np.zeros(13, np.float32))
    fcu_client.sendto(state, ("127.0.0.1", ports["PX4"]))
    mavros_sock.recvfrom(512)
    mpc_sock.recvfrom(512)
    mpc_sock.sendto(state, ("127.0.0.1", ports["MPC"]))
    with pytest.raises(socket.timeout):
        fcu_client.recvfrom(512)
    fcu_client.close()


def test_launch_router_conf_parses(repo_root):
    with open(os.path.join(repo_root, "configs/router_sitl.conf")) as f:
        eps = parse_conf(f.read())
    by_name = {e.name: e for e in eps}
    assert set(by_name) == {"fcu", "telemetry", "mpc", "liveview"}
    assert by_name["mpc"].allow_out == {367}
    assert by_name["mpc"].allow_in == {368}
    assert by_name["telemetry"].allow_out is None
    assert by_name["liveview"].allow_out == {367, 368}


def test_parse_shipped_hexa_conf(repo_root):
    eps = parse_conf(open(os.path.join(repo_root, "configs", "router_hexa.conf")).read())
    assert [e.name for e in eps] == ["fcu", "telemetry", "mpc"]
    assert isinstance(eps[0], R.SerialEndpoint)
    assert eps[0].device == "/dev/ttyUSB0" and eps[0].baud == 921600
    mpc = eps[2]
    assert mpc.address == "192.168.1.207" and mpc.port == 14998
    assert mpc.allow_in == {368} and mpc.allow_out == {367}


def test_parse_reference_hexa_conf_uart():
    eps = parse_conf(_REF_HEXA_CONF)
    assert [e.name for e in eps] == ["PX4", "Mavros", "MPC"]
    assert isinstance(eps[0], R.SerialEndpoint)
    assert eps[0].device == "/dev/ttyUSB0" and eps[0].baud == 921600
    assert eps[2].allow_in == {368} and eps[2].allow_out == {367}


@pytest.fixture(params=["py", "native"])
def uart_topology(request):
    """Serial FCU leg (a pty pair for the UART wire) + an id-filtered MPC
    UDP sink, over both implementations."""
    import pty

    if request.param == "native":
        _native_or_skip("router_add_uart")
    master, slave = pty.openpty()
    fcu = R.SerialEndpoint("PX4", os.ttyname(slave), baud=921600)
    mpc_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mpc_sock.bind(("127.0.0.1", 0))
    mpc_sock.settimeout(2.0)
    mpc_ep = Endpoint("MPC", "127.0.0.1", mpc_sock.getsockname()[1],
                      allow_in={368}, allow_out={367})
    if request.param == "native":
        r = R.NativeRouter([fcu, mpc_ep])
        r.start()
        mpc_port = r.bound_port("MPC")
    else:
        r = Router([fcu, mpc_ep])
        r.start()
        mpc_port = mpc_ep.bound_port
    yield r, master, mpc_sock, mpc_port
    r.stop()
    os.close(master)
    os.close(slave)
    mpc_sock.close()


def test_uart_to_udp_and_back(uart_topology):
    r, master, mpc_sock, mpc_port = uart_topology
    state = mav.encode_full_state(42, np.arange(13, dtype=np.float32))
    os.write(master, state)
    assert mpc_sock.recvfrom(512)[0] == bytes(state)
    cmd = mav.encode_motors_cmd(7, [0.7] * 6, [0.7, 0, 0, 0], 5, 100)
    mpc_sock.sendto(cmd, ("127.0.0.1", mpc_port))
    back = b""
    deadline = time.time() + 2.0
    while len(back) < len(cmd) and time.time() < deadline:
        back += os.read(master, 512)
    msg = mav.decode_frame(back)
    assert msg is not None and msg.get_type() == "MPC_MOTORS_CMD"
    assert msg.time_usec == 7
    # id 368 arriving FROM the FCU side is filtered out of the MPC leg
    os.write(master, cmd)
    with pytest.raises(socket.timeout):
        mpc_sock.settimeout(0.3)
        mpc_sock.recvfrom(512)


def test_uart_stream_reassembly(uart_topology):
    r, master, mpc_sock, mpc_port = uart_topology
    f1 = mav.encode_full_state(1, np.zeros(13, np.float32), seq=1)
    f2 = mav.encode_full_state(2, np.ones(13, np.float32), seq=2)
    os.write(master, f1[:9])
    time.sleep(0.05)
    os.write(master, f1[9:])
    assert mpc_sock.recvfrom(512)[0] == bytes(f1)
    os.write(master, b"\x00\x11garbage" + f1 + f2)
    got = {mpc_sock.recvfrom(512)[0], mpc_sock.recvfrom(512)[0]}
    assert got == {bytes(f1), bytes(f2)}


def test_deframer_unit():
    v2 = mav.encode_full_state(9, np.full(13, 0xFD / 255, np.float32))
    v1 = bytes([0xFE, 3, 0, 1, 1, 0, 7, 7, 7, 0, 0])  # minimal v1 frame
    d = R.Deframer()
    out = []
    for b in bytes(v2) + v1 + bytes(v2):
        out += d.feed(bytes([b]))
    assert out == [bytes(v2), v1, bytes(v2)]
    assert mav.decode_frame(out[0]).time_usec == 9


def _heartbeat(armed: bool, seq: int = 0, compid: int = 1) -> bytes:
    """Minimal MAVLink v2 HEARTBEAT (msgid 0) with a placeholder CRC;
    compid 1 = the autopilot, whose heartbeat gates the arm state."""
    payload = bytes([0, 0, 0, 0, 2, 12, 0x80 if armed else 0x00, 4, 3])
    hdr = bytes([0xFD, len(payload), 0, 0, seq & 0xFF, 1, compid & 0xFF, 0, 0, 0])
    return hdr + payload + b"\x00\x00"


def test_parse_general_logging_directives():
    g = R.parse_general(_REF_SITL_CONF)      # commented lines stay inert
    assert g.log_dir is None and g.log_mode == "while-armed"
    g = R.parse_general(_REF_CONF + "\n\tLog = /tmp/fl\n\tLogMode = always\n")
    assert g.log_dir == "/tmp/fl" and g.log_mode == "always"
    with pytest.raises(ValueError, match="LogMode"):
        R.parse_general("[General]\nLogMode = sometimes\n")


@pytest.mark.parametrize("impl", ["py", "native"])
def test_flight_log_parity_and_replay(impl, tmp_path):
    log_dir = str(tmp_path / impl)
    fcu = Endpoint("PX4", "127.0.0.1", 0, mode="Server")
    sink_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink_sock.bind(("127.0.0.1", 0))
    sink_sock.settimeout(1.0)
    sink = Endpoint("MPC", "127.0.0.1", sink_sock.getsockname()[1],
                    allow_in={368}, allow_out={367})
    if impl == "native":
        _native_or_skip("router_set_log")
        r = R.NativeRouter([fcu, sink], log_dir=log_dir, log_mode="always")
        r.start()
        fcu_port, mpc_port = r.bound_port("PX4"), r.bound_port("MPC")
    else:
        r = Router([fcu, sink], log_dir=log_dir, log_mode="always")
        r.start()
        fcu_port, mpc_port = fcu.bound_port, sink.bound_port
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = []
    for k in range(20):
        f = mav.encode_full_state(100 + k, np.full(13, 0.1 * k, np.float32), seq=k)
        client.sendto(f, ("127.0.0.1", fcu_port))
        sent.append(("MPC_FULL_STATE", 100 + k))
        sink_sock.recvfrom(512)
    sink_sock.sendto(mav.encode_motors_cmd(777, [0.7] * 4, [0.7, 0, 0, 0], 5, 100),
                     ("127.0.0.1", mpc_port))
    sent.append(("MPC_MOTORS_CMD", 777))
    time.sleep(0.3)
    r.stop()
    client.close()
    sink_sock.close()
    logs = [f for f in os.listdir(log_dir) if f.endswith(".tlog")]
    assert len(logs) == 1 and logs[0].startswith("00001-")
    decoded = []
    for t_usec, frame in R.read_tlog(os.path.join(log_dir, logs[0])):
        assert t_usec > 1e15
        msg = mav.decode_frame(frame)
        assert msg is not None
        decoded.append((msg.get_type(), int(msg.time_usec)))
    assert decoded == sent


def test_flight_log_while_armed_gating(tmp_path):
    path = str(tmp_path / "wa.tlog")
    fl = R.FrameLog(path, mode="while-armed")
    fl.log(mav.encode_full_state(1, np.zeros(13, np.float32)))   # disarmed: dropped
    fl.log(_heartbeat(True))                                     # arms and is logged
    fl.log(mav.encode_full_state(2, np.zeros(13, np.float32)))
    fl.log(_heartbeat(False))                                    # disarms: dropped
    fl.log(mav.encode_full_state(3, np.zeros(13, np.float32)))
    fl.close()
    got = [mav.decode_frame(f) for _, f in R.read_tlog(path)]
    assert [int(m.time_usec) for m in got if m is not None] == [2]
    assert fl.frames_logged == 2


def test_gcs_heartbeat_does_not_disarm_log(tmp_path):
    path = str(tmp_path / "gcs.tlog")
    fl = R.FrameLog(path, mode="while-armed")
    fl.log(_heartbeat(True))
    fl.log(mav.encode_full_state(1, np.zeros(13, np.float32)))
    fl.log(_heartbeat(False, compid=190))          # a GCS heartbeat: ignored
    fl.log(mav.encode_full_state(2, np.zeros(13, np.float32)))
    fl.log(_heartbeat(False))
    fl.log(mav.encode_full_state(3, np.zeros(13, np.float32)))
    fl.close()
    times = [int(m.time_usec) for _, f in R.read_tlog(path)
             if (m := mav.decode_frame(f)) is not None]
    assert times == [1, 2]
    data = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.tlog")
    open(trunc, "wb").write(data[:-7])
    assert sum(1 for _ in R.read_tlog(trunc)) == sum(1 for _ in R.read_tlog(path)) - 1


def test_native_while_armed_matches_twin(tmp_path):
    _native_or_skip("router_set_log")
    log_dir = str(tmp_path / "nat")
    r = R.NativeRouter([Endpoint("PX4", "127.0.0.1", 0, mode="Server"),
                        Endpoint("sink", "127.0.0.1", 1)],
                       log_dir=log_dir, log_mode="while-armed")
    r.start()
    port = r.bound_port("PX4")
    cl = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for f in (mav.encode_full_state(1, np.zeros(13, np.float32)), _heartbeat(True),
              mav.encode_full_state(2, np.zeros(13, np.float32)), _heartbeat(False),
              mav.encode_full_state(3, np.zeros(13, np.float32))):
        cl.sendto(f, ("127.0.0.1", port))
    deadline = time.time() + 3.0
    while r.frames_logged < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert r.frames_logged == 2
    r.stop()
    cl.close()
    logs = [f for f in os.listdir(log_dir) if f.endswith(".tlog")]
    times = [int(m.time_usec) for _, f in R.read_tlog(os.path.join(log_dir, logs[0]))
             if (m := mav.decode_frame(f)) is not None]
    assert times == [2]


def test_native_router_safe_after_stop():
    _native_or_skip()
    r = R.NativeRouter([Endpoint("a", "127.0.0.1", 0, mode="Server")])
    r.start()
    assert r.stats["a"] == 0
    r.stop()
    assert r.stats == {"a": -1}
    with pytest.raises(RuntimeError):
        r.bound_port("a")
    r.stop()  # idempotent


def test_tlog_to_flight_log_and_render(tmp_path):
    pytest.importorskip("matplotlib")
    from sde4mbrl_px4_tpu_torch.io.flight_log import tlog_to_flight_log
    from sde4mbrl_px4_tpu_torch.sim.analyze import analyze

    path = str(tmp_path / "flight.tlog")
    fl = R.FrameLog(path, mode="always")
    for k in range(30):
        if k == 10:
            fl.log(mav.encode_motors_cmd(10_000_000, [0.6] * 4, [0.6, 0.1, -0.1, 0.0], 5, 100))
        st = np.zeros(13, np.float32)
        st[0], st[6] = 0.1 * k, 1.0
        fl.log(mav.encode_full_state(int(1e6 * (1 + 0.02 * k)), st, seq=k))
    fl.close()
    d = tlog_to_flight_log(path)
    assert d["state"].shape == (30, 13)
    np.testing.assert_allclose(d["t"][0], 1.0, atol=1e-6)
    assert np.all(d["cmd_motors"][:10] == 0.0)
    np.testing.assert_allclose(d["cmd_motors"][10:, :4], 0.6, atol=1e-6)
    assert np.all(d["mpc_on"][10:] == 5)
    out = str(tmp_path / "flight.png")
    analyze(path, out)
    assert os.path.exists(out)


def test_deframer_crc_resync_on_corrupt_length():
    f1 = bytes(mav.encode_full_state(1, np.zeros(13, np.float32), seq=1))
    f2 = bytes(mav.encode_full_state(2, np.ones(13, np.float32), seq=2))
    corrupt = bytearray(f1)
    corrupt[1] += 7                     # a fake length that would eat into f2
    out = R.Deframer().feed(bytes(corrupt) + f2 + f2)
    assert out.count(f2) == 2
    assert bytes(corrupt) not in out
    v1_unknown = bytes([0xFE, 3, 0, 1, 1, 99, 7, 7, 7, 0xAB, 0xCD])
    assert R.Deframer().feed(v1_unknown) == [v1_unknown]


def test_uart_corrupt_length_native(uart_topology):
    r, master, mpc_sock, mpc_port = uart_topology
    good = bytes(mav.encode_full_state(42, np.zeros(13, np.float32)))
    corrupt = bytearray(good)
    corrupt[1] += 5
    os.write(master, bytes(corrupt) + good)
    assert mpc_sock.recvfrom(512)[0] == good


# ------------------------------------------------------ parity with the JAX router

def _fields(e) -> dict:
    keys = (("device", "baud") if type(e).__name__ == "SerialEndpoint"
            else ("address", "port", "mode"))
    return {"kind": type(e).__name__, "name": e.name, "allow_in": e.allow_in,
            "allow_out": e.allow_out, **{k: getattr(e, k) for k in keys}}


def _conf_texts(repo_root):
    texts = {"ref dialect": _REF_CONF, "ref sitl": _REF_SITL_CONF, "ref hexa": _REF_HEXA_CONF,
             "ref dialect + log": _REF_CONF + "\n\tLog = /tmp/fl\n\tLogMode = always\n"}
    for name in ("router_sitl.conf", "router_hexa.conf"):
        with open(os.path.join(repo_root, "configs", name)) as f:
            texts[name] = f.read()
    return texts


def test_parse_conf_and_general_equal_jax(repo_root):
    for tag, text in _conf_texts(repo_root).items():
        a, b = R.parse_conf(text), JR.parse_conf(text)
        assert [_fields(e) for e in a] == [_fields(e) for e in b], tag
        ga, gb = R.parse_general(text), JR.parse_general(text)
        assert (ga.log_dir, ga.log_mode) == (gb.log_dir, gb.log_mode), tag
    for bad in ("[General]\nLogMode = sometimes\n",):
        for mod in (R, JR):
            with pytest.raises(ValueError, match="LogMode"):
                mod.parse_general(bad)


def _stream(seed: int):
    """Frames from a numpy seed (v2 states and commands, a v1 frame, a
    heartbeat), one with a corrupted length and one with a bad CRC, joined
    and cut into chunks at random points."""
    rs = np.random.RandomState(seed)
    frames = []
    for k in range(40):
        kind = rs.randint(4)
        if kind == 0:
            f = mav.encode_full_state(int(rs.randint(1 << 30)), rs.randn(13).astype(np.float32),
                                      rs.rand(4).astype(np.float32), seq=k)
        elif kind == 1:
            f = mav.encode_motors_cmd(int(rs.randint(1 << 30)), rs.rand(6), rs.rand(4),
                                      int(rs.randint(6)), int(rs.randint(101)), seq=k)
        elif kind == 2:
            f = bytes([0xFE, 3, k & 0xFF, 1, 1, 99]) + rs.bytes(3) + b"\xab\xcd"
        else:
            f = _heartbeat(bool(rs.randint(2)), seq=k)
        frames.append(bytearray(f))
    frames[7][1] = (frames[7][1] + 5) & 0xFF         # corrupted length
    frames[19][-1] ^= 0x5A                            # bad CRC
    blob = b"\x00\x13noise" + b"".join(bytes(f) for f in frames) + b"\xfd"
    cuts = np.sort(rs.choice(np.arange(1, len(blob)), size=25, replace=False))
    return [blob[a:b] for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(blob)])]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deframer_equals_jax(seed):
    a, b = R.Deframer(), JR.Deframer()
    out_a, out_b = [], []
    for chunk in _stream(seed):
        out_a += a.feed(chunk)
        out_b += b.feed(chunk)
    assert out_a == out_b and len(out_a) >= 30
    assert bytes(a._buf) == bytes(b._buf)


@pytest.mark.parametrize("mode", ["always", "while-armed"])
def test_frame_log_byte_equal_to_jax(tmp_path, monkeypatch, mode):
    frames = [mav.encode_full_state(k, np.full(13, 0.1 * k, np.float32), seq=k)
              for k in range(5)]
    frames[2:2] = [_heartbeat(True)]
    frames += [_heartbeat(False, compid=190), mav.encode_full_state(9, np.zeros(13, np.float32)),
               _heartbeat(False), mav.encode_full_state(10, np.zeros(13, np.float32))]
    paths = []
    for tag, mod in (("torch", R), ("jax", JR)):
        clock = iter(1_700_000_000.0 + 0.001 * np.arange(200))
        monkeypatch.setattr(time, "time", lambda: float(next(clock)))
        path = str(tmp_path / f"{tag}.tlog")
        fl = mod.FrameLog(path, mode=mode)
        for f in frames:
            fl.log(bytes(f))
        fl.close()
        paths.append(path)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] and len(data[0]) > 0


def _fanout(router_cls, sinks, n: int = 30):
    """Frames from the FCU client and from the MPC sink through
    ``router_cls``; returns what each of the three peers received."""
    fcu = Endpoint("PX4", "127.0.0.1", 0, mode="Server")
    plain = Endpoint("Mavros", "127.0.0.1", sinks["Mavros"].getsockname()[1])
    mpc = Endpoint("MPC", "127.0.0.1", sinks["MPC"].getsockname()[1],
                   allow_in={368}, allow_out={367})
    eps = [fcu, plain, mpc]
    r = router_cls(eps)
    r.start()
    ports = ({n_: r.bound_port(n_) for n_ in ("PX4", "MPC")} if router_cls is R.NativeRouter
             else {"PX4": fcu.bound_port, "MPC": mpc.bound_port})
    client = sinks["FCU"]
    got = {k: collections.Counter() for k in sinks}
    rs = np.random.RandomState(5)
    try:
        for k in range(n):
            fr = (mav.encode_full_state(k, rs.randn(13).astype(np.float32), seq=k) if k % 3
                  else mav.encode_motors_cmd(k, rs.rand(6), rs.rand(4), 3, 100, seq=k))
            client.sendto(bytes(fr), ("127.0.0.1", ports["PX4"]))
            if k % 5 == 4:     # the MPC side answers (368 passes in) and spoofs a 367
                sinks["MPC"].sendto(bytes(mav.encode_motors_cmd(1000 + k, [0.5] * 6,
                                                                [0.5, 0, 0, 0], 3, 100)),
                                    ("127.0.0.1", ports["MPC"]))
                sinks["MPC"].sendto(bytes(mav.encode_full_state(2000 + k, np.zeros(13))),
                                    ("127.0.0.1", ports["MPC"]))
            time.sleep(0.004)
        deadline = time.time() + 1.0
        while time.time() < deadline:
            for key, s in sinks.items():
                try:
                    got[key][s.recvfrom(512)[0]] += 1
                    deadline = time.time() + 0.3
                except (BlockingIOError, socket.timeout):
                    pass
            time.sleep(0.002)
    finally:
        r.stop()
    return got


def test_routers_deliver_the_same_multisets_as_jax():
    impls = [("jax", JR.Router), ("torch", R.Router)]
    lib = mav.load_native()
    if lib is not None and hasattr(lib, "router_new"):
        impls.append(("native", R.NativeRouter))
    seen = {}
    for tag, cls in impls:
        sinks = {k: socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                 for k in ("FCU", "Mavros", "MPC")}
        try:
            for s in sinks.values():
                s.bind(("127.0.0.1", 0))
                s.setblocking(False)
            seen[tag] = _fanout(cls, sinks)
        finally:
            for s in sinks.values():
                s.close()
    ref = seen["jax"]
    assert sum(ref["Mavros"].values()) == 30 + 6     # every FCU frame + the 6 replies
    assert sum(ref["MPC"].values()) == 20            # the 367s only
    assert sum(ref["FCU"].values()) == 6             # the 368 replies, no spoofed 367
    for tag, got in seen.items():
        assert got == ref, tag
