"""SITL bring-up node (L7) — the ``px4_sitl.launch`` analogue.

Copied from ``sde4mbrl_px4_tpu/sim/sitl.py`` (``FCUSimNode`` ``:40``,
``fcu_sim_from_config`` ``:118``), over the port's plant
(``sim/plant.py``, on the host CPU) and MAVLink link (``io/mavlink.py``).

The reference boots its system-level harness with ``make px4_sitl gazebo``
plus ``launch/px4_sitl.launch`` / ``launch/hexa_px4.launch`` (SURVEY.md §4:
Gazebo stands in for the vehicle; the PX4 SITL firmware streams
``MPC_FULL_STATE`` and consumes ``MPC_MOTORS_CMD``). This framework's
stand-in is :class:`~sde4mbrl_px4_tpu_torch.sim.plant.FCUSim` (the SDE model
integrated at fine dt + the FCU watchdog/engagement behaviors);
:class:`FCUSimNode` here wraps it with the wire-level loop so it can be
brought up from the launch tier exactly like the reference's SITL:

    python -m sde4mbrl_px4_tpu_torch.launch configs/launch/iris_px4_sitl.yaml &
    python -m sde4mbrl_px4_tpu_torch.launch configs/launch/iris_sdectrl.yaml

Wire behavior (mirrors the FCU side of ``scripts/router_sitl.conf:13-19``):

- streams ``MPC_FULL_STATE`` (id 367) at ``state_rate_hz``, stamped with
  WALL time so the engine's trajectory clock and the plan's time-indexed
  pickup agree (``sde_control.py:292``);
- consumes ``MPC_MOTORS_CMD`` (id 368) into the FCU shim, which applies the
  engagement level, the 20 ms staleness watchdog and the ``weight_motors``
  blend before the motors reach the plant (``basic_control.py:35-42``);
- advances the plant in real time (paced to the wall clock, like Gazebo's
  real-time factor 1.0).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from sde4mbrl_px4_tpu_torch.io.mavlink import MavlinkUDP
from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant

__all__ = ["FCUSimNode", "fcu_sim_from_config"]


class FCUSimNode:
    """Threaded wire-level loop around :class:`FCUSim`.

    One thread receives ``MPC_MOTORS_CMD`` frames; one thread paces the
    plant at ``1/state_rate_hz`` and streams ``MPC_FULL_STATE``. ``stop()``
    joins both. The node owns its UDP endpoint (``udpout`` toward the
    engine's listen address, the topology of ``router_sitl.conf:14-16``).
    """

    def __init__(self, fcu: FCUSim, addr: str = "127.0.0.1:14998",
                 realtime: bool = True, step_fn=None):
        """``step_fn(dt)`` overrides how the plant advances each tick —
        e.g. ``SimVehicle.step`` so the PX4 position-loop stand-in keeps
        authority while the MPC is disengaged (the full-stack mission
        topology, ``examples/full_sitl_stack.py``). Default: the raw FCU
        engagement/watchdog shim (``FCUSim.run_control_period``)."""
        self.fcu = fcu
        self.addr = addr
        self.realtime = realtime
        self._step = step_fn or fcu.run_control_period
        self.link = MavlinkUDP(addr, mode="udpout")
        self._stop = threading.Event()
        self._rx: Optional[threading.Thread] = None
        self._sim: Optional[threading.Thread] = None
        self.ticks = 0

    # -- threads -----------------------------------------------------------
    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            m = self.link.recv_match(type="MPC_MOTORS_CMD", timeout=0.05)
            if m is not None:
                self.fcu.push_cmd(m.motor_val_des, m.thrust_and_angrate_des,
                                  m.mpc_on, m.weight_motors)

    def _sim_loop(self) -> None:
        dt = self.fcu.state_dt
        wall0 = time.time()
        k = 0
        while not self._stop.is_set():
            x, _ = self.fcu.full_state_msg()
            self.link.send_full_state(int(time.time() * 1e6), x,
                                      self.fcu.applied_motors4)
            if self.realtime:
                sleep = wall0 + (k + 1) * dt - time.time()
                if sleep > 0:
                    time.sleep(sleep)
                elif sleep < -0.25:
                    # Fell >250 ms behind wall time (host stall): RE-ANCHOR
                    # instead of replaying the missed periods. A catch-up
                    # burst fast-forwards the plant several plant-seconds in
                    # milliseconds while HOLDING one command open-loop — a
                    # non-physical teleport that reads as divergence (a real
                    # FCU never fast-forwards). Dropped periods are the
                    # honest behavior.
                    wall0 = time.time() - (k + 1) * dt
            self._step(dt)
            k += 1
            self.ticks = k

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._rx = threading.Thread(target=self._rx_loop, daemon=True,
                                    name="fcu-sim-rx")
        self._sim = threading.Thread(target=self._sim_loop, daemon=True,
                                     name="fcu-sim-plant")
        self._rx.start()
        self._sim.start()

    def stop(self) -> None:
        self._stop.set()
        for t in (self._rx, self._sim):
            if t is not None:
                t.join(timeout=1.0)
        self.link.close()


def fcu_sim_from_config(cfg: Dict[str, Any]) -> FCUSimNode:
    """Build the SITL node from a launch-tier config dict.

    Keys (launch YAML, the ``px4_sitl.launch`` parameter surface):

    - ``vehicle``: ``iris`` | ``hexa`` (reference SITL targets,
      ``README.md:27-32``);
    - ``model_params``: SDE param pickle for the plant (defaults to the
      vehicle's shipped checkpoint under ``config_dir/models/``);
    - ``config_dir``: base for relative paths (defaults like launch.py);
    - ``addr_mavlink_state_msg``: engine's MAVLink listen address;
    - ``state_rate_hz`` (default 100), ``sim_dt`` (default 0.005),
      ``process_noise`` (default false), ``seed``;
    - ``initial_position_ned``: optional [x, y, z] start offset.
    """
    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import vehicle_from_name

    vehicle = str(cfg.get("vehicle", "iris"))
    base = cfg.get("config_dir", "configs")
    if not os.path.isabs(base):
        cand = [os.path.abspath(base)]
        if cfg.get("_dir"):
            cand.append(os.path.join(os.path.dirname(
                os.path.dirname(cfg["_dir"])), base))
        base = next((c for c in cand if os.path.isdir(c)), cand[0])
    pkl = cfg.get("model_params", os.path.join("models", f"{vehicle}_sde.pkl"))
    if not os.path.isabs(pkl):
        pkl = os.path.join(base, pkl)

    params, _ = load_params(pkl)
    model = NeuralSDE.for_vehicle(vehicle_from_name(vehicle))
    plant = SDEPlant(
        model, params,
        sim_dt=float(cfg.get("sim_dt", 0.005)),
        process_noise=bool(cfg.get("process_noise", False)),
        seed=int(cfg.get("seed", 0)),
    )
    x0 = hover_state().numpy()
    off = cfg.get("initial_position_ned")
    if off is not None:
        x0[:3] = np.asarray(off, np.float32)
    plant.reset(x0)
    fcu = FCUSim(plant, state_rate_hz=float(cfg.get("state_rate_hz", 100.0)))
    addr = cfg.get("addr_mavlink_state_msg", "127.0.0.1:14998")
    return FCUSimNode(fcu, addr=addr,
                      realtime=bool(cfg.get("realtime", True)))
