"""Mission / operator layer (L6) — the ROS-free ``BasicControl`` + CLI.

Copied from ``sde4mbrl_px4_tpu/cli/mission.py`` (numpy): the port may not
import the JAX package, whose ``__init__`` imports JAX. The one change is
where the original computes with ``jnp``: :meth:`SimVehicle.step` runs the
port's ``baselines/geometric.py::geometric_control`` on float32 CPU
tensors (the PX4 position-loop stand-in is host code, like the plant), and
the frame and yaw helpers are the port's on CPU tensors. Nothing here
touches CUDA: a process that runs the mission layer may still start nodes.

Re-implements the reference's high-level mission node
(``sde4mbrl_px4/basic_control.py``, 646 LoC) and its prompt REPL
(``input_command.py``): arming, offboard switching, takeoff/land,
position/relative setpoints, MPC controller lifecycle
(init/on/off/idle/test), the ``weight_motors`` blend knob, the geometric
safety box, and the MPC-failsafe monitor that reverts to position hold.

Structure:

- :class:`VehicleBase` — the FCU-facing interface the mission layer
  drives (arm, mode, setpoints, odometry). The reference talks to mavros
  services/topics; here :class:`SimVehicle` adapts the closed-loop
  simulator (``sim/plant.py``), flying non-MPC position setpoints with the
  native geometric controller as the "PX4 position controller" stand-in.
- :class:`MissionControl` — the command state machine: every verb installs
  ``command_function`` + ``command_succeed`` closures retried by a 50 Hz
  loop until the vehicle state confirms (the reference's pattern,
  ``basic_control.py:355-394``), plus safety box and failsafe monitors.
- :func:`repl` — ``verb arg=value`` parser with reflection dispatch onto
  MissionControl (``input_command.py:63-91``).
"""
from __future__ import annotations

import os
import shlex
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np

import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
from sde4mbrl_px4_tpu_torch.core.types import (
    CTRL_INACTIVE,
    CTRL_POSE_ACTIVE,
    CTRL_TEST,
    CTRL_TRAJ_ACTIVE,
    CTRL_TRAJ_IDLE,
)

__all__ = ["VehicleBase", "SimVehicle", "MissionControl", "dispatch", "repl"]

# Reference MPC_STATUS decoding (``basic_control.py:35-42``).
MPC_STATUS = {
    -1: "MPC OFF | NOT INITIALIZED",
    0: "MPC OFF | NOT INITIALIZED",
    1: "MPC ON | TEST",
    2: "MPC OFF -> MPC timeout [Motor msg] delay > 20ms",
    3: "MPC OFF -> FCU time >= MPC horizon -> MPC too slow",
    4: "MPC OFF -> FCU time < MPC -> Shouldn't happen",
}


class VehicleBase:
    """FCU-facing interface the mission layer drives."""

    def arm(self, value: bool) -> None: ...
    def set_flight_mode(self, mode: str) -> None: ...  # "OFFBOARD" | "AUTO.LAND" | ...
    def push_setpoint(self, pos: np.ndarray, yaw: float) -> None: ...

    def set_param(self, name: str, value) -> bool:
        """Push one FCU firmware parameter (reference uses
        ``/mavros/param/set``, ``basic_control.py:110-121``). Default: not
        supported by this vehicle backend."""
        return False
    @property
    def armed(self) -> bool: ...
    @property
    def flight_mode(self) -> str: ...
    def position(self) -> np.ndarray: ...       # ENU
    def yaw(self) -> float: ...
    def mpc_status(self) -> int: ...            # MPC_STATUS code


class SimVehicle(VehicleBase):
    """Adapter over the closed-loop simulator.

    Flies OFFBOARD position setpoints with the geometric controller (the
    stand-in for PX4's cascaded position loop) whenever the MPC is not
    engaged; AUTO.LAND descends to the ground.
    """

    def __init__(self, fcu_sim, geo_params=None):
        from sde4mbrl_px4_tpu_torch.baselines.geometric import GeoParams, geometric_control

        self.fcu = fcu_sim
        self._armed = False
        self._mode = "POSCTL"
        self._setpoint = np.zeros(3)
        self._setpoint_yaw = 0.0
        self._was_mpc = False            # MPC held authority last tick
        self._failsafe_target = None     # position hold after an MPC dropout
        # Thrust map calibrated to the sim airframe: hover command
        # (hover_u) at a_des = g  =>  norm_thrust_const = hover_u / g.
        # Gentler position gains than the reference defaults: the sim's
        # P-only rate loop is slower than PX4's cascaded rate controller,
        # so the aggressive (8, 1.5) PD pair phase-lags into instability.
        self._geo = geo_params or GeoParams(
            norm_thrust_const=fcu_sim.hover_u / 9.81, norm_thrust_offset=0.0,
            kp=(2.0, 2.0, 4.0), kv=(2.0, 2.0, 3.0),
        )
        self._geo_fn = geometric_control

    # -- VehicleBase ---------------------------------------------------------

    def arm(self, value: bool) -> None:
        self._armed = bool(value)

    def set_flight_mode(self, mode: str) -> None:
        self._mode = mode

    def push_setpoint(self, pos: np.ndarray, yaw: float) -> None:
        self._setpoint = np.asarray(pos, np.float64)
        self._setpoint_yaw = float(yaw)
        # A fresh offboard setpoint supersedes any failsafe position hold
        # (PX4 semantics: new setpoints take over from the hold).
        self._failsafe_target = None

    def set_param(self, name: str, value) -> bool:
        self.fcu.params[str(name)] = value
        return True

    @property
    def armed(self) -> bool:
        return self._armed

    @property
    def flight_mode(self) -> str:
        return self._mode

    def _x_enu(self) -> torch.Tensor:
        return ned2enu(torch.as_tensor(np.asarray(self.fcu.plant.x, np.float32)))

    def position(self) -> np.ndarray:
        return self._x_enu()[0:3].numpy().copy()  # writable copy

    def yaw(self) -> float:
        return float(quat.yaw_from_q(self._x_enu()[6:10]))

    def mpc_status(self) -> int:
        return int(self.fcu.status)

    # -- simulation step -----------------------------------------------------

    def step(self, dt: float) -> None:
        """Advance the plant one period under the active control authority."""
        if not self._armed:
            self.fcu.plant.step(np.zeros(self.fcu.n_u, np.float32), dt)
            return
        # Resolve control authority FIRST: _effective_u applies the
        # engagement level + staleness watchdog and is the only place
        # fcu.status transitions — checking the stale status instead would
        # never hand authority to a freshly-engaged MPC command stream.
        u_mpc = self.fcu._effective_u()
        if self.fcu.status == self.fcu.MPC_ON:
            self._was_mpc = True
            self.fcu.plant.step(u_mpc, dt)
            return
        # PX4-side position control stand-in: geometric controller -> rate
        # loop -> motors.
        #
        # Failsafe semantics on an MPC dropout (watchdog timeout / OFF
        # after being ON): hold the CURRENT position — PX4's position-hold
        # failsafe — NOT the last mission setpoint. Yanking back toward a
        # stale setpoint makes brief watchdog flaps alternate two
        # controllers with different targets, which pumps the attitude
        # loop until it diverges (observed in the full-stack soak).
        if self._was_mpc:
            self._was_mpc = False
            self._failsafe_target = self.position()
        target = (self._failsafe_target.copy()
                  if self._failsafe_target is not None
                  else self._setpoint.copy())
        if self._mode == "AUTO.LAND":
            target = self.position()
            target[2] = 0.0  # descend in place
        cmd, _ = self._geo_fn(
            self._geo, self._x_enu(), torch.as_tensor(target),
            torch.zeros(3), torch.zeros(3),
            torch.tensor(self._setpoint_yaw, dtype=torch.float32),
        )
        cmd = cmd.numpy()
        # ENU/FLU rates -> FRD for the FCU rate loop; thrust passthrough.
        tr = np.array([cmd[3], cmd[0], -cmd[1], -cmd[2]], np.float32)
        u = self.fcu._rate_loop(tr)
        self.fcu.plant.step(u, dt)


class MissionControl:
    """Operator verbs + monitors (the reference's ``BasicControl``)."""

    def __init__(self, vehicle: VehicleBase, engine=None, log: Callable = print,
                 loop_hz: float = 50.0, auto_spin: bool = False):
        self.vehicle = vehicle
        self.engine = engine            # SDEControlNode (or None)
        self.log = log
        self.loop_dt = 1.0 / loop_hz

        self.command_to_send = False
        self.command_function: Callable = lambda: None
        self.command_succeed: Callable = lambda: False
        self.action_completed: Callable = lambda: False
        self.stop_offboard_mode = True
        self.ctrl_on = False
        self.security_check = False
        self.not_safe = False
        self.safe_box: Optional[np.ndarray] = None
        self.center_point: Optional[np.ndarray] = None
        self.last_mpc_state = -1
        self._setpoint = np.zeros(3)
        self._setpoint_yaw = 0.0
        self._running = False

        # Pre-flight firmware params: disable the PX4 RC-loss failsafe for
        # offboard flight, sent 5x like the reference (unacknowledged
        # param pushes over a lossy link; ``basic_control.py:147-149``).
        for _ in range(5):
            self.vehicle.set_param("COM_RCL_EXCEPT", 4)

        if auto_spin:
            self.start()

    # ---------------------------------------------------------------- loop

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._spin, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False

    def _spin(self):
        while self._running:
            self.tick()
            time.sleep(self.loop_dt)

    def tick(self):
        """One 50 Hz supervision tick (reference ``offboard_loop``,
        ``basic_control.py:355-394``)."""
        if self.command_to_send:
            self.command_function()
            if self.command_succeed():
                self.command_to_send = False
                self.command_function = lambda: None
                self.command_succeed = lambda: False
        if self.action_completed():
            self.action_completed = lambda: False

        # MPC failsafe monitor (``basic_control.py:438-453``): ON->OFF
        # transition reverts to position hold.
        st = self.vehicle.mpc_status()
        if st != self.last_mpc_state:
            self.log(f"MPC state: {MPC_STATUS.get(st, st)}")
            if self.last_mpc_state == 1 and st <= 0:
                self.log("Switching to position control")
                self.pos()
            self.last_mpc_state = st

        # Safety box (``basic_control.py:371-384``).
        if self.security_check and self.vehicle.flight_mode == "OFFBOARD":
            if self._outside_box():
                if not self.not_safe:
                    self.controller_off()
                    self.not_safe = True
                    self.log("Not safe, staying still")
                else:
                    self.pos(*self.center_point)
                    self.not_safe = False
            else:
                self.not_safe = False

        if not self.stop_offboard_mode:
            self.vehicle.push_setpoint(self._setpoint, self._setpoint_yaw)

    def wait_for_command(self, timeout: float = 5.0) -> bool:
        t0 = time.time()
        while time.time() - t0 < timeout:
            if not self.command_to_send:
                return True
            time.sleep(self.loop_dt)
        return False

    def wait_for_action(self, timeout: float = 30.0) -> bool:
        t0 = time.time()
        done_fn = self.action_completed
        while time.time() - t0 < timeout:
            if done_fn():
                return True
            time.sleep(self.loop_dt)
        return False

    # ---------------------------------------------------------------- verbs

    def _install_command(self, fn: Callable, succeed: Callable):
        """Install a retried command and fire it once immediately (the
        reference relies on its concurrent 50 Hz timer for the first firing,
        ``basic_control.py:355-365``; immediate first-fire keeps the
        synchronous single-thread mode equivalent)."""
        self.command_function = fn
        self.command_succeed = succeed
        self.command_to_send = True
        fn()
        if succeed():
            self.command_to_send = False
            self.command_function = lambda: None
            self.command_succeed = lambda: False

    def arm(self):
        self.log("Arming the motors...")
        self._install_command(lambda: self.vehicle.arm(True),
                              lambda: self.vehicle.armed)

    def disarm(self):
        self.log("Disarming the motors...")
        self.stop_offboard_mode = True
        self._install_command(lambda: self.vehicle.arm(False),
                              lambda: not self.vehicle.armed)

    def offboard(self):
        self.stop_offboard_mode = False
        self._set_setpoint_here()
        self._install_command(
            lambda: self.vehicle.set_flight_mode("OFFBOARD"),
            lambda: self.vehicle.flight_mode == "OFFBOARD",
        )

    def takeoff(self, z: float = 1.0, yaw: Optional[float] = None,
                use_ctrl: bool = False):
        self._arm_and_offboard_if_needed()
        p = self.vehicle.position()
        self._setpoint = np.array([p[0], p[1], z])
        self._setpoint_yaw = self.vehicle.yaw() if yaw is None else yaw
        self.log(f"Takeoff to {z}m, yaw={self._setpoint_yaw:.2f}")
        self.action_completed = lambda: abs(self.vehicle.position()[2] - z) <= 0.1
        if use_ctrl:
            self.ctrl_pos_current()
        elif self.ctrl_on:
            self.controller_off()

    def pos(self, x: Optional[float] = None, y: Optional[float] = None,
            z: Optional[float] = None, yaw: Optional[float] = None,
            use_ctrl: bool = False):
        self._arm_and_offboard_if_needed()
        p = self.vehicle.position()
        sp = np.array([
            p[0] if x is None else x,
            p[1] if y is None else y,
            p[2] if z is None else z,
        ])
        self._setpoint = sp
        self._setpoint_yaw = self.vehicle.yaw() if yaw is None else yaw
        self.log(f"Position to {np.round(sp, 2)} yaw={self._setpoint_yaw:.2f}")
        self.action_completed = (
            lambda: np.linalg.norm(self.vehicle.position() - sp) <= 0.1
        )
        if use_ctrl:
            self.ctrl_pos_current()
        elif self.ctrl_on:
            self.controller_off()

    def relpos(self, dx: float = 0, dy: float = 0, dz: float = 0,
               dyaw: float = 0, use_ctrl: bool = False):
        p = self.vehicle.position()
        self.pos(p[0] + dx, p[1] + dy, p[2] + dz, self.vehicle.yaw() + dyaw,
                 use_ctrl)

    def ctrl_pos(self, x=None, y=None, z=None, yaw=None):
        return self.pos(x, y, z, yaw, use_ctrl=True)

    def land(self):
        self.stop_offboard_mode = True
        if self.ctrl_on:
            self.controller_off()
        self.log("Landing...")
        self._install_command(
            lambda: self.vehicle.set_flight_mode("AUTO.LAND"),
            lambda: abs(self.vehicle.position()[2]) <= 0.1,
        )

    # -- safety box ----------------------------------------------------------

    def set_box(self, x: float = 0.2, y: float = 0.2, z: float = 0.2):
        p = self.vehicle.position()
        self.safe_box = np.array([p[0] - x, p[0] + x, p[1] - y, p[1] + y,
                                  p[2] - z, p[2] + z])
        self.center_point = p.copy()
        self.security_check = True
        self.not_safe = False
        self.log(f"Safety box set around {np.round(p, 2)}")

    def rm_box(self):
        self.security_check = False
        self.safe_box = None
        self.center_point = None
        self.not_safe = False

    def _outside_box(self) -> bool:
        p = self.vehicle.position()
        b = self.safe_box
        return bool(
            p[0] < b[0] or p[0] > b[1] or p[1] < b[2] or p[1] > b[3]
            or p[2] < b[4] or p[2] > b[5]
        )

    # -- controller lifecycle ------------------------------------------------

    def controller_init(self, config_name: str = ""):
        """``set_trajectory_and_params`` service call
        (``basic_control.py:502-524``)."""
        if self.engine is None:
            self.log("No engine attached")
            return
        ok = self.engine.initialize_mpc()
        self.log("Loaded the trajectory and the parameters" if ok
                 else "Failed to initialize the controller")

    def _controller_set_mode(self, mode: int, wmotors: int = 110):
        if self.engine is None:
            self.log("No engine attached")
            return
        # Zero roll/pitch on the target attitude (``basic_control.py:545-553``)
        target = np.zeros(13, np.float32)
        target[0:3] = self._setpoint
        target[6:10] = quat.q_from_yaw(
            torch.tensor(self._setpoint_yaw, dtype=torch.float32)).numpy()
        ok, msg = self.engine.set_mode(mode, target_pose=target,
                                       weight_motors=wmotors)
        self.log(msg)
        if ok and 0 <= wmotors <= 100:
            return
        self.ctrl_on = ok and mode in (CTRL_TRAJ_ACTIVE, CTRL_TRAJ_IDLE,
                                       CTRL_POSE_ACTIVE)

    def controller_on(self):
        self._controller_set_mode(CTRL_TRAJ_ACTIVE)
        self.stop_offboard_mode = True

    def controller_off(self):
        self.offboard()
        self._controller_set_mode(CTRL_INACTIVE)

    def controller_idle(self):
        self._controller_set_mode(CTRL_TRAJ_IDLE)
        self.stop_offboard_mode = True

    def controller_test(self):
        self._set_setpoint_here()
        self._controller_set_mode(CTRL_TEST)

    def weight_motors(self, wmotors: int):
        if not 0 <= wmotors <= 100:
            self.log("Weight motors must be between 0 and 100")
            return
        self._controller_set_mode(CTRL_TEST, wmotors)

    def ctrl_pos_current(self):
        self._controller_set_mode(CTRL_POSE_ACTIVE)
        self.stop_offboard_mode = True

    def push_params(self, path: str):
        """Bulk-apply a PX4 parameter dump file (QGC plain-text format) to
        the vehicle — the reproducible-setup analogue of the reference's
        shipped ``launch/params_hexa_ahg.params`` applied over
        ``/mavros/param/set`` (``basic_control.py:110-121``)."""
        from sde4mbrl_px4_tpu_torch.io.px4_params import parse_params_file

        params = parse_params_file(path)
        pushed = sum(bool(self.vehicle.set_param(k, v)) for k, v in params.items())
        self.log(f"Pushed {pushed}/{len(params)} params from {path}")
        if pushed < len(params):
            self.log("(vehicle backend rejected some params)")

    # -- helpers -------------------------------------------------------------

    def _set_setpoint_here(self):
        self._setpoint = self.vehicle.position().copy()
        self._setpoint_yaw = self.vehicle.yaw()

    def _arm_and_offboard_if_needed(self):
        if self.vehicle.flight_mode != "OFFBOARD":
            self.offboard()
            self.wait_for_command()
        if not self.vehicle.armed:
            self.arm()
            self.wait_for_command()


_VERBS = [
    "arm", "disarm", "takeoff", "land", "pos", "relpos", "offboard",
    "controller_init", "controller_on", "controller_off", "controller_idle",
    "controller_test", "set_box", "rm_box", "ctrl_pos", "weight_motors",
    "push_params",
]


def dispatch(ctl: MissionControl, line: str) -> bool:
    """Parse ``verb arg1 arg2 key=value`` and call the method (the
    reference's reflection dispatch, ``input_command.py:63-91``)."""
    parts = shlex.split(line.strip())
    if not parts:
        return True
    verb, *args = parts
    if verb == "help":
        print("Commands:", ", ".join(_VERBS))
        return True
    if verb in ("quit", "exit"):
        return False
    if not hasattr(ctl, verb) or verb.startswith("_"):
        print(f"Unknown command {verb!r} (help for list)")
        return True
    typ = (str if verb in ("controller_init", "push_params")
           else int if verb == "weight_motors" else float)
    a, kw = [], {}
    try:
        for tok in args:
            if "=" in tok:
                k, v = tok.split("=", 1)
                kw[k] = typ(v)
            else:
                a.append(typ(tok))
        getattr(ctl, verb)(*a, **kw)
    except Exception as e:  # keep the REPL alive (reference does the same)
        print(f"error: {e}")
    return True


# Process-wide readline-history state: the active history path (the atexit
# handler resolves it at save time, so a later _setup_line_editing with a
# different file is honored) and whether the handler is registered.
_HISTORY = {"path": None, "registered": False}


def _save_history():
    if _HISTORY["path"] is None:
        return
    try:
        import readline

        readline.write_history_file(_HISTORY["path"])
    except (ImportError, OSError):
        pass


def _setup_line_editing(history_file: Optional[str] = None):
    """Tab completion over the verb set + persistent history (the reference
    REPL uses prompt_toolkit with a word completer,
    ``input_command.py:23-30``; stdlib readline provides the same
    affordances without a dependency). Returns a save-history callable.
    Safe to call repeatedly in one process: the history file is loaded only
    when it changes (re-reading would append duplicates onto the live
    history), and the single atexit handler always saves to the CURRENT
    path."""
    try:
        import atexit
        import readline
    except ImportError:  # non-readline platform: plain input still works
        return lambda: None

    words = sorted(_VERBS + ["help", "quit", "exit"])

    def complete(text, state):
        matches = [w for w in words if w.startswith(text)]
        return matches[state] if state < len(matches) else None

    readline.set_completer(complete)
    readline.parse_and_bind("tab: complete")
    hist = history_file or os.path.expanduser("~/.sde4mbrl_px4_history")
    if hist != _HISTORY["path"]:
        _save_history()  # persist the previous file before switching
        readline.clear_history()
        try:
            readline.read_history_file(hist)
        except OSError:
            pass
        _HISTORY["path"] = hist
    readline.set_history_length(500)

    if not _HISTORY["registered"]:
        _HISTORY["registered"] = True
        atexit.register(_save_history)
    return _save_history


def repl(ctl: MissionControl, prompt: str = "Enter command >>> ",
         input_fn: Callable = input, line_editing: bool = True):
    """Blocking operator REPL (tab completion + history when ``input_fn``
    is the interactive default and stdin is a terminal: a script piped in
    gets neither, and no history file is written)."""
    if line_editing and input_fn is input and sys.stdin.isatty():
        _setup_line_editing()
    while True:
        try:
            line = input_fn(prompt)
        except (EOFError, KeyboardInterrupt):
            break
        if not dispatch(ctl, line):
            break
