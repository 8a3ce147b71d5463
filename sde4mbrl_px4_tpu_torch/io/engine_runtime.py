"""Asynchronous MPC engine node (L7) — the ROS-free ``SDEControlROS``.

PyTorch counterpart of ``sde4mbrl_px4_tpu/io/engine_runtime.py``
(``SDEControlNode`` ``:54``, ``EngineServiceClient`` ``:409``), built over
the port's :class:`~sde4mbrl_px4_tpu_torch.engine.controller.RecedingHorizonController`
on ``device`` (the card by default, ``"cpu"`` for the plain versions):

- **ingress** (:meth:`SDEControlNode.handle_state`): called per incoming
  ``MPC_FULL_STATE`` — resolves the control automata, posts the state
  snapshot to the mailbox (doorbell), and WITHOUT WAITING picks the motor +
  thrust/body-rate command out of the latest finished plan by time index
  (reference ``mpc_state_callback``, ``sde_control.py:223-325``); its
  latency is kept per call in :attr:`SDEControlNode.pick_seconds`;
- **solver loop** (:meth:`SDEControlNode.solver_loop`): blocks on the
  doorbell, snapshots the inbox, dispatches one solve by mode; with
  ``pipeline`` a collector thread publishes each plan the moment its solve
  completes (reference ``mpc_process_fn``, ``sde_control.py:328-450``);
- **services** (:meth:`SDEControlNode.initialize_mpc`,
  :meth:`SDEControlNode.set_mode`, JSON over UDP in
  :meth:`SDEControlNode.serve_services`);
- **MAVLink loop** (:meth:`SDEControlNode.serve_mavlink`): blocking UDP
  receive thread (reference ``handle_mpc_state_msg``,
  ``sde_control.py:134-154``).

The solver runs in a thread, as in the original: its kernel launches leave
the GIL to the ingress thread. Solves are launched on the solver thread's
current stream; the collector's copy waits on the event each dispatch
records (``engine/controller.py::_fetch``), and nothing in the dispatch
path synchronizes the device. The mailbox is the native POSIX segment
where ``csrc/libmpc_native.so`` is built, else the Python fallback
(:attr:`SDEControlNode.mailbox_kind`; the original refuses to start
without the library).
"""
from __future__ import annotations

import collections
import json
import logging
import os
import queue
import socket
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES, CONTROL_STATE_NAMES
from sde4mbrl_px4_tpu_torch.engine.controller import OverrunMeter, RecedingHorizonController
from sde4mbrl_px4_tpu_torch.engine.telemetry import OptMPCStateRecord
from sde4mbrl_px4_tpu_torch.io.mailbox import Mailbox
from sde4mbrl_px4_tpu_torch.io.mavlink import MavlinkUDP

_LOG = logging.getLogger("sde4mbrl_px4_tpu_torch.engine")

__all__ = ["SDEControlNode", "EngineServiceClient"]

# Mailbox layouts (float64 lanes).
_IN_LEN = 3 + 13 + 13          # [sample_t_usec, ctrl_state, trajec_time] + x + target
_STATS = 9                     # sample_t, solve_time, avg_ls, stepsize, num_steps,
                               # grad_sqr, avg_stepsize, init_cost, opt_cost


class SDEControlNode:
    """Dual-solver async MPC engine with mailbox doorbell runtime."""

    def __init__(
        self,
        traj_cfg_path: str,
        pos_cfg_path: str,
        seed: int = 0,
        mailbox_name: Optional[str] = None,
        now_fn: Callable[[], float] = time.time,
        cmd_sink: Optional[Callable] = None,
        pipeline: bool = True,
        device: Optional[torch.device | str] = None,
    ):
        # pipeline=True (default): the solver loop only dispatches solves; a
        # collector thread publishes each plan the moment its solve
        # completes. In-flight solves are capped at 1 (freshness first:
        # overlapped dispatches serialize on the device and age every plan
        # by a full solve); while the device is busy, doorbells are skipped
        # and latest-wins hands the next dispatch the freshest state.
        # SDE4MBRL_MAX_INFLIGHT=2 trades staleness for throughput.
        # The controller's constructor makes a warm solve per config: on the
        # card that builds (or reuses) every kernel before start().
        self.ctrl = RecedingHorizonController(
            traj_cfg_path, pos_cfg_path, seed=seed, now_fn=now_fn, device=device,
        )
        self.pipeline = pipeline
        self.max_inflight = int(os.environ.get("SDE4MBRL_MAX_INFLIGHT", "1"))
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Disengaged ('none' mode) keep-warm rate divider (default 1 =
        # reference parity: a solve on every doorbell).
        self.idle_solve_div = int(os.environ.get("SDE4MBRL_IDLE_SOLVE_DIV", "1"))
        self._idle_ticks = 0
        self.now_fn = now_fn
        self.cmd_sink = cmd_sink      # callable(motors6, thrust_rates4, mpc_on, weight)
        self.max_h = max(self.ctrl.traj.horizon, self.ctrl.pos.horizon)
        out_len = _STATS + 1 + self.max_h * 6 + self.max_h * 4  # stats, is_traj, u, w

        name = mailbox_name or f"sde_mpc_torch_{os.getpid()}_{id(self):x}"
        self.mbx = Mailbox(name, _IN_LEN, out_len, owner=True)
        self.mailbox_kind = self.mbx.kind

        self._solver_thread: Optional[threading.Thread] = None
        self._mav_thread: Optional[threading.Thread] = None
        self._svc_thread: Optional[threading.Thread] = None
        self._svc_sock: Optional[socket.socket] = None
        self._running = False
        self.last_record = OptMPCStateRecord()
        self.dt_state_callback = 0.0
        self.dt_state_info = 0.0
        self.pick_seconds = collections.deque(maxlen=100_000)
        # solve time (dispatch to plan on the host) and iterations of each
        # published plan
        self.solve_seconds = collections.deque(maxlen=100_000)
        self.solve_steps = collections.deque(maxlen=100_000)
        self._last_state_time: Optional[float] = None
        self._last_index = 0
        self.overruns = OverrunMeter()
        self.mav: Optional[MavlinkUDP] = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._running = True
        self._solver_thread = threading.Thread(target=self.solver_loop, daemon=True,
                                               name="mpc-solver")
        self._solver_thread.start()

    def stop(self) -> None:
        """Stop every thread, then close the sockets, the mailbox and the
        controller (the receive threads are joined before the mailbox
        closes: a late ``handle_state`` must not post to a closed segment).
        Safe after a partial start: only the threads that run are joined."""
        self._running = False
        self.mbx.shutdown()
        for th in (self._solver_thread, self._mav_thread, self._svc_thread):
            # safe after a partial start: a thread whose start() was
            # interrupted (or never came) has nothing to join
            if th is not None and th.is_alive():
                th.join(timeout=5.0)
        if self.mav is not None:
            self.mav.close()
        if self._svc_sock is not None:
            self._svc_sock.close()
        self.mbx.close()
        self.ctrl.close()

    # -------------------------------------------------------------- services

    def initialize_mpc(self) -> bool:
        """``set_trajectory_and_params`` service semantics
        (``sde_control.py:453-477``): refuse while running; send 5 reset
        commands to the FCU; mark reset_done."""
        a = self.ctrl.automata
        if a.run_trajectory or a.pos_control:
            return False
        if self.cmd_sink is not None:
            for _ in range(5):
                self.cmd_sink(
                    np.zeros(6, np.float32), np.zeros(4, np.float32),
                    CONTROL_STATES["reset"], a.weight_motors,
                )
                time.sleep(0.01)
        a.reset_done = True
        return True

    def set_mode(self, mode: int, target_pose=None, weight_motors: int = 110):
        """``start_trajectory`` service semantics (``sde_control.py:480-562``)."""
        return self.ctrl.automata.set_mode(mode, target_pose, weight_motors)

    # --------------------------------------------------------------- ingress

    def handle_state(self, state13: np.ndarray, sample_time_usec: float):
        """Hot path per state message. Returns (motors6, thrust_rates4,
        mpc_on, weight_motors) or None (no plan yet / automata 'none')."""
        t0 = time.perf_counter()
        try:
            return self._handle_state(state13, sample_time_usec, t0)
        finally:
            self.dt_state_callback = time.perf_counter() - t0
            self.pick_seconds.append(self.dt_state_callback)

    def _handle_state(self, state13, sample_time_usec: float, t0: float):
        now = self.now_fn()
        self.dt_state_info = (now - self._last_state_time) if self._last_state_time else 0.0
        self._last_state_time = now

        a = self.ctrl.automata
        control_state, trajec_time, target = a.resolve()

        # Post to the solver and ring the doorbell.
        rec = np.empty(_IN_LEN, np.float64)
        rec[0] = sample_time_usec
        rec[1] = control_state
        rec[2] = trajec_time
        rec[3:16] = np.asarray(state13, np.float64)
        rec[16:29] = np.asarray(target, np.float64)
        self.mbx.post_inbox(rec)

        # Pick from the latest finished plan (never waits on a solve).
        out, seq = self.mbx.read_outbox()
        plan_sample_t = out[0]
        if seq == 0 or plan_sample_t <= 0:
            return None

        is_traj = out[_STATS] > 0.5
        active = self.ctrl.traj if is_traj else self.ctrl.pos
        # Overrun = the solver missed real time; clamp AND surface it.
        idx = self.overruns.clamp(
            int((sample_time_usec - plan_sample_t) / active.dt_usec),
            active.horizon, (sample_time_usec - plan_sample_t) / 1e3)
        self._last_index = idx
        u_flat = out[_STATS + 1 : _STATS + 1 + self.max_h * 6]
        w_flat = out[_STATS + 1 + self.max_h * 6 :]
        motors = u_flat.reshape(self.max_h, 6)[idx].astype(np.float32)
        rates = w_flat.reshape(self.max_h, 4)[idx].astype(np.float32)

        self.last_record = OptMPCStateRecord(
            stamp=now,
            avg_linesearch=out[2], stepsize=out[3], num_steps=int(out[4]),
            grad_norm=out[5], avg_stepsize=out[6], cost_init=out[7],
            opt_cost=out[8], solve_time=out[1],
            callback_dt=self.dt_state_callback, state_dt=self.dt_state_info,
            ctrl_state=CONTROL_STATE_NAMES[control_state],
            mpc_indx=idx,
        )

        if control_state == CONTROL_STATES["none"]:
            return None

        mpc_on = CONTROL_STATES["test"] if a.test_mode else control_state
        result = (motors, rates, mpc_on, a.weight_motors)
        if self.cmd_sink is not None:
            self.cmd_sink(*result)
        return result

    # ------------------------------------------------------------ solver side

    def solver_loop(self) -> None:
        """Doorbell-driven solve loop (reference ``mpc_process_fn``).

        pipeline mode: this thread dispatches; :meth:`_collector_loop`
        publishes on completion. Blocking mode solves + publishes inline.
        """
        col_thread = None
        if self.pipeline:
            self._solve_q: "queue.Queue" = queue.Queue()
            col_thread = threading.Thread(target=self._collector_loop, daemon=True,
                                          name="mpc-collector")
            col_thread.start()

        while self._running:
            rc = self.mbx.wait_bell(timeout_ms=200)
            if rc < 0:
                break
            if rc == 0:
                continue
            rec, _ = self.mbx.read_inbox()
            sample_t = rec[0]
            control_state = int(rec[1])
            trajec_time = float(rec[2])
            x = rec[3:16].astype(np.float32)
            target = rec[16:29].astype(np.float32)

            if control_state == CONTROL_STATES["none"] and self.idle_solve_div > 1:
                self._idle_ticks += 1
                if self._idle_ticks % self.idle_solve_div:
                    continue

            if self.pipeline:
                # Backpressure: count solves outstanding until PUBLISHED;
                # skip the doorbell when saturated (latest-wins).
                if self._inflight >= self.max_inflight:
                    continue
                entry = self.ctrl.solve_async(
                    x, control_state, trajec_time, target, sample_t
                )
                with self._inflight_lock:
                    self._inflight += 1
                self._solve_q.put(entry)
            else:
                record = self.ctrl.solve_once(
                    x, control_state, trajec_time, target, sample_t
                )
                self._post_plan(record)

        if col_thread is not None:
            self._solve_q.put(None)
            col_thread.join(timeout=5.0)

    def _collector_loop(self) -> None:
        """Publish each plan the moment its solve completes (in dispatch
        order: one stream, one solve in flight by default)."""
        while True:
            entry = self._solve_q.get()
            if entry is None:
                return
            try:
                record = self.ctrl.collect_entry(entry)
                self._post_plan(record)
            except Exception:  # noqa: BLE001 — a failed collect must not
                # kill the collector: the dispatch loop would then saturate
                # on _inflight and silently drop every future solve.
                _LOG.exception("solve collection failed; plan not published")
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    def _post_plan(self, record: OptMPCStateRecord) -> None:
        max_h = self.max_h
        out = np.zeros(self.mbx.outbox_len, np.float64)
        # Stamp with the sample time of the plan being published: the pickup
        # index is computed against the state the plan was solved from.
        out[0] = self.ctrl.plan_sample_time_usec
        out[1] = record.solve_time
        out[2] = record.avg_linesearch
        out[3] = record.stepsize
        out[4] = record.num_steps
        out[5] = record.grad_norm
        out[6] = record.avg_stepsize
        out[7] = record.cost_init
        out[8] = record.opt_cost
        out[_STATS] = 1.0 if self.ctrl.plan_is_traj else 0.0
        u = self.ctrl.u_plan
        u6 = u[:, :6] if u.shape[1] >= 6 else np.pad(u, ((0, 0), (0, 6 - u.shape[1])))
        out[_STATS + 1 : _STATS + 1 + max_h * 6] = u6.reshape(-1)
        out[_STATS + 1 + max_h * 6 :] = self.ctrl.w_plan.reshape(-1)
        self.mbx.post_outbox(out)
        self.solve_seconds.append(record.solve_time)
        self.solve_steps.append(record.num_steps)

    # ------------------------------------------------------------- services

    def serve_services(self, addr: str = "127.0.0.1:14997") -> None:
        """Wire-level controller services: JSON over UDP (the ROS-free
        ``set_trajectory_and_params`` / ``start_trajectory``,
        ``sde_control.py:86-89``)::

            {"cmd": "init"}                             -> {"ok": ..}
            {"cmd": "set_mode", "mode": 2,
             "target": [13 floats]?, "weight_motors": 110} -> {"ok", "msg"}
            {"cmd": "status"}                           -> telemetry record
        """
        host, port = addr.rsplit(":", 1)
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, int(port)))
        sock.settimeout(0.2)
        self._svc_sock = sock

        def loop():
            while self._running:
                try:
                    data, peer = sock.recvfrom(8192)
                except (OSError, TimeoutError):
                    continue
                try:
                    req = json.loads(data.decode())
                    cmd = req.get("cmd")
                    if cmd == "init":
                        resp = {"ok": self.initialize_mpc()}
                    elif cmd == "set_mode":
                        tgt = req.get("target")
                        ok, msg = self.set_mode(
                            int(req.get("mode", 0)),
                            target_pose=None if tgt is None else np.asarray(tgt, np.float32),
                            weight_motors=int(req.get("weight_motors", 110)),
                        )
                        resp = {"ok": ok, "msg": msg}
                    elif cmd == "status":
                        resp = {"ok": True, "record": self.last_record.to_dict(),
                                "overruns": self.overruns.count,
                                "inflight": self._inflight}
                    else:
                        resp = {"ok": False, "msg": f"unknown cmd {cmd!r}"}
                except Exception as e:  # noqa: BLE001 — keep the service alive
                    resp = {"ok": False, "msg": repr(e)}
                try:
                    sock.sendto(json.dumps(resp).encode(), peer)
                except OSError:
                    pass

        self._svc_thread = threading.Thread(target=loop, daemon=True, name="mpc-services")
        self._svc_thread.start()

    # ------------------------------------------------------------- transport

    def serve_mavlink(self, addr: str = "127.0.0.1:14998") -> None:
        """Attach the UDP MAVLink side-channel: listener thread ingesting
        MPC_FULL_STATE and replying MPC_MOTORS_CMD (reference
        ``init_mavlink_connection`` + ``handle_mpc_state_msg``,
        ``sde_control.py:113-154``)."""
        self.mav = MavlinkUDP(addr, mode="udpin")

        def sink(motors6, rates4, mpc_on, weight):
            try:
                self.mav.send_motors_cmd(
                    int(self.now_fn() * 1e6), motors6, rates4, mpc_on, weight
                )
            except RuntimeError:
                # server mode with no peer yet: the reference likewise only
                # replies after the first inbound message (:117-126)
                pass

        self.cmd_sink = sink

        def loop():
            while self._running:
                msg = self.mav.recv_match(type="MPC_FULL_STATE", timeout=0.1)
                if msg is not None and self._running:
                    self.handle_state(msg.state, float(msg.time_usec))

        self._mav_thread = threading.Thread(target=loop, daemon=True, name="mpc-mavlink")
        self._mav_thread.start()


class EngineServiceClient:
    """Client for the engine's JSON-over-UDP service channel (the ROS-free
    ``set_trajectory_and_params`` / ``start_trajectory`` client side,
    reference ``basic_control.py:110-121``)."""

    def __init__(self, addr: str = "127.0.0.1:14997", timeout: float = 2.0):
        host, port = addr.rsplit(":", 1)
        self._peer = (host, int(port))
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.settimeout(timeout)

    def _call(self, req: dict) -> dict:
        self.sock.sendto(json.dumps(req).encode(), self._peer)
        data, _ = self.sock.recvfrom(65535)
        return json.loads(data.decode())

    def initialize_mpc(self) -> bool:
        return bool(self._call({"cmd": "init"}).get("ok"))

    def set_mode(self, mode: int, target_pose=None, weight_motors: int = 110):
        req = {"cmd": "set_mode", "mode": int(mode),
               "weight_motors": int(weight_motors)}
        if target_pose is not None:
            req["target"] = [float(v) for v in np.asarray(target_pose).ravel()]
        r = self._call(req)
        return bool(r.get("ok")), r.get("msg", "")

    def status(self) -> dict:
        return self._call({"cmd": "status"}).get("record", {})

    def close(self):
        self.sock.close()
