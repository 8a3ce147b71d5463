"""Port, the engine node on the CPU: the mailbox, the MAVLink codec, the
async ``SDEControlNode`` and the launcher.

- mailbox round trip, doorbell, shutdown wake, latest-wins and 8 threads
  posting at once, on the Python fallback always and on the native segment
  where ``csrc/libmpc_native.so`` is built (there also attached by name);
- MAVLink frames byte for byte equal to the JAX package's codec for the
  same ``MPC_FULL_STATE`` and ``MPC_MOTORS_CMD``, and each side decoding
  the other's;
- the node on the tiny config of ``tests/test_engine_runtime.py:21-30``
  (H = 5, ``max_iter`` 10) with ``device="cpu"``: the command flow,
  idle -> traj, the plan index advancing, the UDP service channel, the
  collector surviving a failed collect (the tests of that file);
- the pipelined controller equal to the synchronous one shifted by one
  call; the offset estimator reset before its first tick of a fresh
  engagement;
- the launcher parsing the shipped ``configs/launch/*``, refusing an
  engine config it does not run (``matmul_precision`` below fp32, naming
  its ROADMAP item), and running in fresh processes the geometric node and
  the router node for ``--seconds`` (a frame forwarded), ``fcu_sim`` until
  SIGTERM and the engine with the mission REPL (``--repl --cpu``) on a
  stdin script.
"""
import os
import socket
import threading
import time

import numpy as np
import pytest
import yaml

from sde4mbrl_px4_tpu.io import mavlink as J
from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
from sde4mbrl_px4_tpu_torch.core.types import (
    CONTROL_STATES, CTRL_INACTIVE, CTRL_POSE_ACTIVE, CTRL_TRAJ_ACTIVE, CTRL_TRAJ_IDLE,
    hover_state)
from sde4mbrl_px4_tpu_torch.io import mavlink as M
from sde4mbrl_px4_tpu_torch.io.mailbox import Mailbox, native_available

KINDS = ["python", pytest.param("native", marks=pytest.mark.skipif(
    not native_available(), reason="csrc/libmpc_native.so not built (make -C csrc)"))]


def _mailbox(kind, name, n_in, n_out, owner=True):
    m = Mailbox(f"{name}_{os.getpid()}", n_in, n_out, owner=owner,
                native=kind == "native")
    assert m.kind == kind
    return m


# ---------------------------------------------------------------- mailbox

@pytest.mark.parametrize("kind", KINDS)
def test_mailbox_roundtrip_and_cross_attach(kind):
    m = _mailbox(kind, "t_mbx_rt", 8, 4)
    try:
        m.post_inbox(np.arange(8, dtype=np.float64))
        data, seq = m.read_inbox()
        np.testing.assert_array_equal(data, np.arange(8))
        assert seq == 1
        m.post_outbox(np.array([9.0, 8, 7, 6]))
        out, oseq = m.read_outbox()
        np.testing.assert_array_equal(out, [9, 8, 7, 6])
        assert oseq == 1
        if kind == "python":       # one object in one process: no attaching
            with pytest.raises(OSError, match="native mailbox"):
                _mailbox(kind, "t_mbx_rt", 8, 4, owner=False)
            return
        b = _mailbox(kind, "t_mbx_rt", 8, 4, owner=False)   # the solver side
        np.testing.assert_array_equal(b.read_inbox()[0], np.arange(8))
        b.post_outbox(np.array([5.0, 6, 7, 8]))
        np.testing.assert_array_equal(m.read_outbox()[0], [5, 6, 7, 8])
        b.close()
    finally:
        m.close()


@pytest.mark.parametrize("kind", KINDS)
def test_mailbox_doorbell(kind):
    m = _mailbox(kind, "t_mbx_bell", 4, 4)
    try:
        assert m.wait_bell(timeout_ms=50) == 0            # timeout
        got = []
        th = threading.Thread(target=lambda: got.append(m.wait_bell(timeout_ms=2000)))
        th.start()
        time.sleep(0.05)
        m.post_inbox(np.ones(4))
        th.join(timeout=3)
        assert not th.is_alive() and got == [1]
        m.post_inbox(np.ones(4))                           # rung before the wait
        assert m.wait_bell(timeout_ms=0) == 1
        assert m.wait_bell(timeout_ms=20) == 0             # the bell was consumed
    finally:
        m.close()


@pytest.mark.parametrize("kind", KINDS)
def test_mailbox_shutdown_wakes_waiter(kind):
    m = _mailbox(kind, "t_mbx_shut", 4, 4)
    try:
        got = []
        th = threading.Thread(target=lambda: got.append(m.wait_bell(timeout_ms=5000)))
        th.start()
        time.sleep(0.05)
        m.shutdown()
        th.join(timeout=3)
        assert not th.is_alive() and got == [-1]
        assert m.wait_bell(timeout_ms=-1) == -1            # stays shut
    finally:
        m.close()


@pytest.mark.parametrize("kind", KINDS)
def test_mailbox_latest_wins(kind):
    m = _mailbox(kind, "t_mbx_latest", 2, 2)
    try:
        for i in range(10):
            m.post_outbox(np.array([float(i), 0.0]))
            m.post_inbox(np.array([float(i), 1.0]))
        out, seq = m.read_outbox()
        assert out[0] == 9.0 and seq == 10
        inb, iseq = m.read_inbox()
        assert inb[0] == 9.0 and iseq == 10
        assert m.wait_bell(timeout_ms=0) == 1 and m.wait_bell(timeout_ms=10) == 0
    finally:
        m.close()


@pytest.mark.parametrize("kind", KINDS)
def test_mailbox_under_thread_contention(kind):
    """8 producers post 200 states each while the solver side waits on the
    bell and echoes each inbox to the outbox, with a short switch
    interval: no post is lost from the sequence count, every inbox read is
    one whole post (its two lanes agree) and the last one is the latest."""
    import sys

    m = _mailbox(kind, "t_mbx_stress", 2, 2)
    n_threads, n_posts = 8, 200
    torn, wakes = [], []
    done = threading.Event()

    def producer(i):
        for k in range(n_posts):
            v = float(i * n_posts + k)
            m.post_inbox(np.array([v, -v]))

    def solver():
        while not done.is_set():
            rc = m.wait_bell(timeout_ms=50)
            if rc == 1:
                wakes.append(1)
                data, _ = m.read_inbox()
                torn.extend([data] if data[0] != -data[1] else [])
                m.post_outbox(data)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        consumer = threading.Thread(target=solver)
        consumer.start()
        threads = [threading.Thread(target=producer, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        done.set()
        consumer.join(timeout=5)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not any(th.is_alive() for th in threads + [consumer])
        inbox, seq = m.read_inbox()
        assert seq == n_threads * n_posts and not torn and wakes
        assert inbox[0] == -inbox[1]
        out, oseq = m.read_outbox()
        assert oseq == len(wakes) and out[0] == -out[1]
    finally:
        m.close()


def test_native_mailbox_refused_without_library(monkeypatch):
    import sde4mbrl_px4_tpu_torch.io.mailbox as MB

    monkeypatch.setattr(MB, "_lib", lambda: None)
    assert not MB.native_available()
    with pytest.raises(RuntimeError, match="make -C csrc"):
        MB.Mailbox("t_mbx_none", 2, 2, owner=True, native=True)
    m = MB.Mailbox(f"t_mbx_fallback_{os.getpid()}", 2, 2, owner=True)
    assert m.kind == "python"
    m.close()


# ---------------------------------------------------------------- MAVLink

def _state(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(13).astype(np.float32)
    x[6:10] /= np.linalg.norm(x[6:10])
    return x, rs.uniform(0, 1, 4).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mavlink_frames_equal_jax_codec(seed):
    x, m4 = _state(seed)
    t = 1_700_000_000_123_456 + seed
    for enc_t, enc_j in (
            (M.encode_full_state(t, x, m4, seq=seed), J.encode_full_state(t, x, m4, seq=seed)),
            (M.encode_motors_cmd(t, m4[:4] * 0.9, [0.5, 0.1, -0.2, 0.3], 3, 100, seq=7),
             J.encode_motors_cmd(t, m4[:4] * 0.9, [0.5, 0.1, -0.2, 0.3], 3, 100, seq=7)),
            (M.encode_motors_cmd(t, np.full(6, 0.33), np.zeros(4), 5, 0),
             J.encode_motors_cmd(t, np.full(6, 0.33), np.zeros(4), 5, 0))):
        assert enc_t == enc_j
        # both ways: each codec decodes the other's frame to the same message
        a, b = M.decode_frame(enc_j), J.decode_frame(enc_t)
        assert a.get_type() == b.get_type() and a.time_usec == b.time_usec == t
        for fld in ("state", "motors", "motor_val_des", "thrust_and_angrate_des"):
            if hasattr(b, fld) and fld in b.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld))
    assert M.crc_extra(M.MSG_ID_MPC_FULL_STATE) == J.crc_extra(J.MSG_ID_MPC_FULL_STATE)
    assert M.crc_extra(M.MSG_ID_MPC_MOTORS_CMD) == J.crc_extra(J.MSG_ID_MPC_MOTORS_CMD)
    bad = bytearray(M.encode_full_state(t, x, m4))
    bad[12] ^= 0xFF
    assert M.decode_frame(bytes(bad)) is None


def test_mavlink_udp_roundtrip():
    srv = M.MavlinkUDP("127.0.0.1:0", mode="udpin")
    port = srv.sock.getsockname()[1]
    cli = M.MavlinkUDP(f"127.0.0.1:{port}", mode="udpout")
    try:
        x, m4 = _state(3)
        cli.send_full_state(42, x, m4)
        msg = srv.recv_match(type="MPC_FULL_STATE", timeout=2.0)
        assert msg is not None and msg.time_usec == 42
        np.testing.assert_array_equal(msg.state, x)
        srv.send_motors_cmd(43, np.full(6, 0.5), np.zeros(4), 3, 100)
        cmd = cli.recv_match(type="MPC_MOTORS_CMD", timeout=2.0)
        assert cmd is not None and cmd.mpc_on == 3 and cmd.weight_motors == 100
    finally:
        srv.close()
        cli.close()


# ------------------------------------------------------------ engine node

def _tiny_cfg(repo_root, with_traj):
    """The tiny config of tests/test_engine_runtime.py:21-30."""
    cfg = yaml.safe_load(open(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml")))
    cfg["horizon"] = 5
    cfg["num_short_dt"] = 5
    cfg["apg_mpc"]["max_iter"] = 10
    cfg["apg_mpc"]["max_no_improvement_iter"] = 10
    cfg["learned_model_params"] = os.path.join(repo_root, "configs/models/iris_sde.pkl")
    if with_traj:
        cfg["trajectory_path"] = os.path.join(repo_root, "configs/trajs/lemniscate.csv")
    return cfg


@pytest.fixture(scope="module")
def tiny_paths(repo_root, tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    (d / "traj.yaml").write_text(yaml.safe_dump(_tiny_cfg(repo_root, True)))
    (d / "pos.yaml").write_text(yaml.safe_dump(_tiny_cfg(repo_root, False)))
    return str(d / "traj.yaml"), str(d / "pos.yaml")


@pytest.fixture(scope="module")
def node(tiny_paths):
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import SDEControlNode

    clock = {"t": 0.0}
    n = SDEControlNode(*tiny_paths, seed=0, now_fn=lambda: clock["t"], device="cpu")
    assert n.mailbox_kind == ("native" if native_available() else "python")
    assert n.ctrl.device.type == "cpu"
    n._clock = clock
    n.start()
    yield n
    n.stop()


def _pump(node, x, t_usec, n=60, wait=0.02):
    """Inject states until a command comes back (the solver is async)."""
    out = None
    for _ in range(n):
        out = node.handle_state(x, t_usec)
        time.sleep(wait)
        if out is not None:
            break
    return out


def test_no_command_before_engagement(node):
    x = enu2ned(hover_state()).numpy()
    assert node.handle_state(x, 1e6) is None     # automata 'none' never actuates
    assert len(node.pick_seconds) >= 1


def test_services_and_command_flow(node):
    assert node.initialize_mpc()
    tgt = hover_state().numpy()
    tgt[2] = 1.5
    ok, msg = node.set_mode(CTRL_POSE_ACTIVE, target_pose=tgt)
    assert ok, msg
    x = enu2ned(hover_state()).numpy()
    node._clock["t"] = 10.0
    out = _pump(node, x, 10e6)
    assert out is not None, "no command produced by the async solver"
    motors, rates, mpc_on, weight = out
    assert motors.shape == (6,) and rates.shape == (4,)
    assert mpc_on == CONTROL_STATES["pos"]
    assert np.all(motors[:4] > 0.0) and np.all(motors[:4] <= 1.0)
    np.testing.assert_array_equal(motors[4:], 0.0)     # iris: padded to 6
    assert node.last_record.num_steps >= 1 and node.last_record.ctrl_state == "pos"
    assert len(node.solve_seconds) >= 1


def test_idle_then_traj_transition(node):
    assert node.set_mode(CTRL_INACTIVE)[0]
    assert node.initialize_mpc()
    assert node.set_mode(CTRL_TRAJ_IDLE)[0]
    x = enu2ned(hover_state()).numpy()
    node._clock["t"] = 20.0
    out = _pump(node, x, 20e6)
    assert out is not None and out[2] == CONTROL_STATES["idle"]
    ok, msg = node.set_mode(CTRL_TRAJ_ACTIVE)      # only from idle
    assert ok and "started" in msg
    node._clock["t"] = 20.5
    out = _pump(node, x, 20.5e6)
    assert out is not None and out[2] == CONTROL_STATES["traj"]


def test_plan_index_advances_with_time(node):
    """Same plan, later sample time -> later index (async pickup)."""
    x = enu2ned(hover_state()).numpy()
    node.handle_state(x, 21.0e6)
    time.sleep(0.5)
    node.handle_state(x, 21.0e6)
    i0 = node.last_record.mpc_indx
    node.handle_state(x, 21.0e6 + 2 * node.ctrl.traj.dt_usec)
    assert node.last_record.mpc_indx >= i0 + 1 or node.last_record.mpc_indx == 4


def test_service_channel_over_udp(node):
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import EngineServiceClient

    node.serve_services("127.0.0.1:0")
    port = node._svc_sock.getsockname()[1]
    cli = EngineServiceClient(f"127.0.0.1:{port}", timeout=3.0)
    try:
        node.set_mode(CTRL_INACTIVE)
        assert cli.initialize_mpc()
        tgt = hover_state().numpy()
        tgt[2] = 2.0
        ok, msg = cli.set_mode(CTRL_POSE_ACTIVE, target_pose=tgt)
        assert ok, msg
        assert node.ctrl.automata.pos_control
        np.testing.assert_allclose(node.ctrl.automata.target_x[2], 2.0)
        st = cli.status()
        assert "num_steps" in st and "ctrl_state" in st
        assert not cli._call({"cmd": "nope"})["ok"]
        raw = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for payload in (b"\x00\xff\xfe", b"{not json", b'{"cmd": "set_mode", "mode": "NaN"}',
                        b'{"cmd": "set_mode", "mode": 3, "target": "x"}', b"null",
                        b'{"cmd": 42}'):
            raw.sendto(payload, ("127.0.0.1", port))
        raw.close()
        assert "num_steps" in cli.status()                # still serving
        ok_bad, msg_bad = cli.set_mode(CTRL_POSE_ACTIVE, target_pose=[1.0])
        assert not ok_bad and "13" in msg_bad
        np.testing.assert_allclose(node.ctrl.automata.target_x[2], 2.0)
    finally:
        cli.close()


def test_collector_survives_failed_collect(node):
    orig = node.ctrl.collect_entry
    calls = {"n": 0}

    def flaky(entry):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected collect failure")
        return orig(entry)

    node.ctrl.collect_entry = flaky
    try:
        x = hover_state().numpy()
        node.set_mode(CTRL_POSE_ACTIVE, target_pose=x)
        t0 = node.ctrl.plan_sample_time_usec
        for k in range(100):
            node.handle_state(x, 50e6 + k * 2e4)
            time.sleep(0.02)
            if calls["n"] >= 2 and node.ctrl.plan_sample_time_usec > t0:
                break
        assert calls["n"] >= 2
        assert node.ctrl.plan_sample_time_usec > t0
        assert 0 <= node._inflight <= node.max_inflight
    finally:
        node.ctrl.collect_entry = orig
        node.set_mode(CTRL_INACTIVE)


def test_node_serves_mavlink(tiny_paths):
    """The wire path: MPC_FULL_STATE in over UDP, MPC_MOTORS_CMD back;
    ``stop`` joins every thread the node started."""
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import SDEControlNode

    n = SDEControlNode(*tiny_paths, seed=0, now_fn=lambda: 5.0, device="cpu")
    n.start()
    n.serve_mavlink("127.0.0.1:0")
    port = n.mav.sock.getsockname()[1]
    fcu = M.MavlinkUDP(f"127.0.0.1:{port}", mode="udpout")
    try:
        assert n.initialize_mpc()
        assert n.set_mode(CTRL_POSE_ACTIVE, target_pose=hover_state().numpy())[0]
        x = enu2ned(hover_state()).numpy()
        cmd = None
        for k in range(100):
            fcu.send_full_state(int(5e6) + k, x)
            cmd = fcu.recv_match(type="MPC_MOTORS_CMD", timeout=0.05)
            if cmd is not None and cmd.mpc_on == CONTROL_STATES["pos"]:
                break
        assert cmd is not None and cmd.mpc_on == CONTROL_STATES["pos"]
        assert np.all(cmd.motor_val_des[:4] > 0)
    finally:
        n.stop()
        fcu.close()
    assert not any(t.is_alive() for t in (n._solver_thread, n._mav_thread))


# ------------------------------------------------------------- controller

def test_pipelined_controller_matches_sync_shifted(tiny_paths):
    """pipeline=True publishes plan k-1 at call k with plan k-1's own
    sample stamp; the solve chain itself is the synchronous one."""
    from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController

    mk = lambda pipe: RecedingHorizonController(*tiny_paths, seed=0, now_fn=lambda: 0.0,
                                                device="cpu", pipeline=pipe)
    sync = mk(False)
    xs = [hover_state().numpy() for _ in range(5)]
    for i, x in enumerate(xs):
        x[0] += 0.05 * i
    stamps = [1e6 + 5e4 * k for k in range(5)]
    sync_plans = []
    for x, t in zip(xs, stamps):
        sync.solve_once(x, CONTROL_STATES["pos"], -1.0, x, sample_time_usec=t)
        sync_plans.append(sync.u_plan.copy())
    with mk(True) as pipe:
        for k, (x, t) in enumerate(zip(xs, stamps)):
            pipe.solve_once(x, CONTROL_STATES["pos"], -1.0, x, sample_time_usec=t)
            if k == 0:
                assert pipe.plan_sample_time_usec == stamps[0]   # cold start: its own
                np.testing.assert_array_equal(pipe.u_plan, sync_plans[0])
            else:
                assert pipe.plan_sample_time_usec == stamps[k - 1]
                np.testing.assert_array_equal(pipe.u_plan, sync_plans[k - 1])
        assert stamps[-1] - pipe.plan_sample_time_usec == pytest.approx(5e4)
    assert pipe._fetcher is None          # the fetch worker is released


def test_offset_estimator_resets_before_its_first_tick(tiny_paths):
    """On a fresh engagement the estimator is reset, then ticks: the
    integral holds exactly one tick of the new error (the original ticks
    first and resets after, dropping that tick)."""
    from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController
    from sde4mbrl_px4_tpu_torch.engine.offset import DisturbanceEstimator

    c = RecedingHorizonController(*tiny_paths, seed=0, now_fn=lambda: 0.0, device="cpu",
                                  offset_adaptation={"gain": 0.4, "limit": 1.0})
    assert isinstance(c.offset_est, DisturbanceEstimator)
    c.offset_est.offset_ned[:] = [0.7, -0.7, 0.7]       # a stale integral
    x = enu2ned(hover_state()).numpy()
    x[0] += 0.3                                          # 0.3 m north of the target
    tgt = hover_state().numpy()
    seen = []
    solve = c.pos.solve

    def spy(x_t, rng, st, t, xdes):
        seen.append(xdes.numpy().copy())
        return solve(x_t, rng, st, t, xdes)

    c.pos.solve = spy
    c.solve_once(x, CONTROL_STATES["pos"], -1.0, tgt, 1e6)
    step = c.pos.dt_usec / 1e6
    np.testing.assert_allclose(c.offset_est.offset_ned, [0.4 * step * -0.3, 0.0, 0.0],
                               atol=1e-9)
    np.testing.assert_allclose(seen[0][:3], tgt[:3] + np.array([0.0, -0.4 * step * 0.3, 0.0]),
                               atol=1e-7)
    # the next pos tick integrates over the measured 0.1 s, on top of it
    c.solve_once(x, CONTROL_STATES["pos"], -1.0, tgt, 1.1e6)
    np.testing.assert_allclose(c.offset_est.offset_ned[0], -0.4 * 0.3 * (step + 0.1),
                               atol=1e-9)


# --------------------------------------------------------------- launcher

def test_launcher_parses_the_shipped_launch_files(repo_root):
    from sde4mbrl_px4_tpu_torch import launch as L

    d = os.path.join(repo_root, "configs", "launch")
    kinds = {}
    for name in sorted(os.listdir(d)):
        cfg = L._load(os.path.join(d, name))
        kinds[name] = cfg["node"]
        if cfg["node"] == "sde_control":
            base = L.config_dir(cfg)
            for key in ("traj_ctrl", "sp_ctrl"):
                assert os.path.isfile(os.path.join(base, cfg[key])), (name, key)
        elif cfg["node"] == "fcu_sim":
            assert cfg["vehicle"] in ("iris", "hexa")
    assert sorted(set(kinds.values())) == ["fcu_sim", "geometric_controller", "router",
                                          "sde_control"]
    assert sum(v == "sde_control" for v in kinds.values()) == 3
    assert sum(v == "fcu_sim" for v in kinds.values()) == 2


@pytest.mark.parametrize("precision", ["default", "high"])
def test_launcher_refuses_what_it_does_not_run(tiny_paths, tmp_path, precision):
    """An engine config with ``matmul_precision: default`` (the bf16 trunk
    on the card, fp32 on the CPU) starts the engine and serves; a name the
    original does not know (``high``) is refused at build with its
    ``ValueError``."""
    from sde4mbrl_px4_tpu_torch import launch as L

    cfg = yaml.safe_load(open(tiny_paths[1]))
    cfg["matmul_precision"] = precision
    (tmp_path / "pos.yaml").write_text(yaml.safe_dump(cfg))
    p = tmp_path / "engine.yaml"
    p.write_text(yaml.safe_dump({"node": "sde_control", "config_dir": str(tmp_path),
                                 "traj_ctrl": tiny_paths[0], "sp_ctrl": "pos.yaml",
                                 "addr_mavlink_state_msg": f"127.0.0.1:{_free_port()}",
                                 "addr_services": f"127.0.0.1:{_free_port()}"}))
    if precision == "high":
        with pytest.raises(ValueError, match="matmul_precision 'high' not recognized"):
            L.launch_from_file(str(p), device="cpu", seconds=0.1)
        return
    node = L.launch_from_file(str(p), device="cpu", seconds=0.1)
    assert node.ctrl.device.type == "cpu" and node.ctrl.pos.cfg["matmul_precision"] == "default"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(repo_root, argv, stdin=None):
    """``python -m sde4mbrl_px4_tpu_torch.launch argv`` in a fresh process,
    its output collected line by line on a thread."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen([sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", *argv],
                            cwd=repo_root, env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            stdin=subprocess.PIPE if stdin is not None else subprocess.DEVNULL)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    if stdin is not None:
        proc.stdin.write(stdin)
        proc.stdin.close()
    return proc, lines, reader


def test_launcher_runs_router_node_for_seconds(repo_root, tmp_path):
    """``node: router`` on the shipped ``router_sitl.yaml``, its conf
    rewritten to free ports: READY with the native/python line, a frame sent
    to the FCU endpoint forwarded to the unfiltered telemetry sink, and exit
    0 when the seconds are up."""
    with open(os.path.join(repo_root, "configs", "router_sitl.conf")) as f:
        conf = f.read()
    fcu_port = _free_port()
    sinks = {}
    for name, port in (("telemetry", 14999), ("mpc", 14998), ("liveview", 14996)):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        s.settimeout(5.0)
        sinks[name] = s
        conf = conf.replace(f"Port = {port}", f"Port = {s.getsockname()[1]}")
    conf = conf.replace("Port = 14550", f"Port = {fcu_port}")
    (tmp_path / "router.conf").write_text(conf)
    cfg = yaml.safe_load(open(os.path.join(repo_root, "configs/launch/router_sitl.yaml")))
    assert cfg == {"node": "router", "conf": "../router_sitl.conf"}
    (tmp_path / "launch").mkdir()
    p = tmp_path / "launch" / "router.yaml"
    p.write_text(yaml.safe_dump({**cfg, "conf": "../router.conf"}))
    proc, lines, reader = _launch(repo_root, [str(p), "--seconds", "5"])
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        t0 = time.monotonic()
        while not any("[launch] READY" in ln for ln in lines) and proc.poll() is None:
            assert time.monotonic() - t0 < 60, lines
            time.sleep(0.05)
        frame = bytes(M.encode_full_state(42, hover_state().numpy()))
        client.sendto(frame, ("127.0.0.1", fcu_port))
        assert sinks["telemetry"].recvfrom(512)[0] == frame
        assert sinks["mpc"].recvfrom(512)[0] == frame            # 367 passes its filter
        proc.wait(timeout=60)
        reader.join(timeout=10)
    finally:
        client.close()
        for s in sinks.values():
            s.close()
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines)
    assert proc.returncode == 0 and "[launch] READY" in out, out
    native = os.path.exists(os.path.join(repo_root, "csrc", "libmpc_native.so"))
    assert f"router ({'native C++' if native else 'python'}) fanning out 4 endpoints" in out
    assert "'fcu': 1" in out, out


def test_launcher_repl_runs_a_stdin_script_on_cpu(repo_root, tiny_paths, tmp_path):
    """``--repl --cpu`` on an engine launch file (the tiny configs, free
    ports): READY, the mission verbs of a stdin script reach the engine's
    services, no ``error:`` line, exit 0 at ``exit``."""
    p = tmp_path / "engine.yaml"
    p.write_text(yaml.safe_dump({"node": "sde_control", "config_dir": "/",
                                 "traj_ctrl": tiny_paths[0], "sp_ctrl": tiny_paths[1],
                                 "addr_mavlink_state_msg": f"127.0.0.1:{_free_port()}",
                                 "addr_services": f"127.0.0.1:{_free_port()}"}))
    script = "controller_init\ncontroller_idle\nweight_motors 100\ncontroller_off\nexit\n"
    proc, lines, reader = _launch(repo_root, [str(p), "--repl", "--cpu"], stdin=script)
    try:
        proc.wait(timeout=240)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines)
    assert proc.returncode == 0 and "[launch] READY" in out, out
    assert "engine (cpu)" in out and "error:" not in out, out
    for line in ("Loaded the trajectory and the parameters", "entering idle",
                 "weight_motors updated", "controller deactivated"):
        assert line in out, out


def test_launcher_runs_geometric_node_for_seconds(repo_root, tmp_path):
    """``python -m sde4mbrl_px4_tpu_torch.launch`` on the shipped
    ``iris_geoctrl.yaml`` (on a free port) with ``--seconds``: READY, each
    MPC_FULL_STATE it is sent answered with an MPC_MOTORS_CMD of thrust and
    body rates (``weight_motors`` 0), and a clean exit 0 when the seconds
    are up."""
    import subprocess
    import sys

    if not os.path.exists(os.path.join(repo_root, "csrc", "libmpc_native.so")):
        pytest.skip("native library not built (make -C csrc)")
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    cfg = yaml.safe_load(open(os.path.join(repo_root, "configs/launch/iris_geoctrl.yaml")))
    cfg["addr_mavlink_state_msg"] = f"127.0.0.1:{port}"
    cfg["trajectory_path"] = os.path.join(repo_root, "configs", cfg["trajectory_path"])
    p = tmp_path / "geo.yaml"
    p.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen([sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", str(p),
                             "--seconds", "6"], cwd=repo_root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    link = M.MavlinkUDP(f"127.0.0.1:{port}", mode="udpout")
    x = enu2ned(hover_state()).numpy()
    x[2] -= 0.5                                    # 0.5 m below the hover (NED z down)
    replies = []
    try:
        t0 = time.monotonic()                      # the node's start-up, then its seconds
        while not any("[launch] READY" in ln for ln in lines) and proc.poll() is None:
            assert time.monotonic() - t0 < 120, lines
            time.sleep(0.05)
        t0 = time.monotonic()
        k = 0
        while len(replies) < 3 and time.monotonic() - t0 < 5.0:
            link.send_full_state(int(1e6 + k * 2e4), x)
            msg = link.recv_match(type="MPC_MOTORS_CMD", timeout=0.05)
            if msg is not None:
                replies.append(msg)
            k += 1
        proc.wait(timeout=60)
        reader.join(timeout=10)
    finally:
        link.close()
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines)
    assert not reader.is_alive() and proc.returncode == 0, out
    assert "[launch] READY" in out and "geometric controller on udp" in out, out
    assert len(replies) >= 3, out
    msg = replies[-1]
    assert msg.weight_motors == 0 and msg.mpc_on == 3
    tr = np.asarray(msg.thrust_and_angrate_des)
    assert np.all(np.isfinite(tr)) and 0.0 < tr[0] <= 1.0
    assert int(out.split("sent ")[1].split()[0]) >= 3


def test_launcher_runs_fcu_sim_until_sigterm(repo_root, tmp_path):
    """``python -m sde4mbrl_px4_tpu_torch.launch`` on the shipped iris SITL
    file (on a free port) in a fresh process: READY, MPC_FULL_STATE frames
    on the wire, and a clean exit 0 on SIGTERM."""
    import subprocess
    import sys

    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    probe.settimeout(30.0)
    port = probe.getsockname()[1]
    cfg = yaml.safe_load(open(os.path.join(repo_root, "configs/launch/iris_px4_sitl.yaml")))
    cfg.update(addr_mavlink_state_msg=f"127.0.0.1:{port}",
               config_dir=os.path.join(repo_root, "configs"))
    p = tmp_path / "fcu.yaml"
    p.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen([sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", str(p)],
                            cwd=repo_root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        msg = M.decode_frame(probe.recv(512))
        assert msg is not None and msg.get_type() == "MPC_FULL_STATE"
        np.testing.assert_allclose(np.linalg.norm(msg.state[6:10]), 1.0, atol=1e-3)
    finally:
        probe.close()
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert "[launch] READY" in out and "fcu_sim (iris) streaming" in out


def _sigterm_and_wait(proc, lines, reader) -> str:
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    reader.join(timeout=10)
    return "".join(lines)


def test_router_node_survives_sigterm_at_its_first_forwarded_frame(repo_root, tmp_path):
    """Fault 8: ``node: router`` with ``native: false`` (the Python router,
    whose pump threads forward frames before ``start()`` returns), frames
    sent to its FCU endpoint from before it starts, SIGTERM the moment the
    first forwarded frame reaches the telemetry sink: a clean exit 0, no
    traceback, not the rc -6 of an interrupted ``Thread.start``."""
    with open(os.path.join(repo_root, "configs", "router_sitl.conf")) as f:
        conf = f.read()
    fcu_port = _free_port()
    sinks = {}
    for name, port in (("telemetry", 14999), ("mpc", 14998), ("liveview", 14996)):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        sinks[name] = s
        conf = conf.replace(f"Port = {port}", f"Port = {s.getsockname()[1]}")
    (tmp_path / "router.conf").write_text(conf.replace("Port = 14550", f"Port = {fcu_port}"))
    p = tmp_path / "router.yaml"
    p.write_text(yaml.safe_dump({"node": "router", "conf": "router.conf", "native": False}))
    stop = threading.Event()
    frame = bytes(M.encode_full_state(42, hover_state().numpy()))

    def flood():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as c:
            while not stop.is_set():
                c.sendto(frame, ("127.0.0.1", fcu_port))
                time.sleep(0.0005)

    sender = threading.Thread(target=flood, daemon=True)
    sender.start()
    proc, lines, reader = _launch(repo_root, [str(p)])
    try:
        sinks["telemetry"].settimeout(60.0)
        assert sinks["telemetry"].recvfrom(512)[0] == frame
        out = _sigterm_and_wait(proc, lines, reader)
    finally:
        stop.set()
        for s in sinks.values():
            s.close()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "Traceback" not in out, out


def test_engine_node_survives_sigterm_in_its_start_up(repo_root, tiny_paths, tmp_path):
    """Fault 8's twin on the engine node (``--cpu``, the tiny configs):
    SIGTERM the moment its service channel first answers (its solver,
    MAVLink and service threads just started, before READY is needed):
    exit 0 with the stop line and no traceback."""
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import EngineServiceClient

    svc_port = _free_port()
    p = tmp_path / "engine.yaml"
    p.write_text(yaml.safe_dump({"node": "sde_control", "config_dir": "/",
                                 "traj_ctrl": tiny_paths[0], "sp_ctrl": tiny_paths[1],
                                 "addr_mavlink_state_msg": f"127.0.0.1:{_free_port()}",
                                 "addr_services": f"127.0.0.1:{svc_port}"}))
    proc, lines, reader = _launch(repo_root, [str(p), "--cpu"])
    client = EngineServiceClient(f"127.0.0.1:{svc_port}", timeout=0.05)
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None and time.monotonic() - t0 < 120, "".join(lines)
            try:
                client.status()
                break
            except OSError:
                continue
        out = _sigterm_and_wait(proc, lines, reader)
    finally:
        client.close()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "[launch] engine stopped" in out and "Traceback" not in out, out
