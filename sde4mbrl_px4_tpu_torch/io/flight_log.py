"""Flight recording (L7) — the framework's ULog/PlotJuggler-asset analogue.

Copied from ``sde4mbrl_px4_tpu/io/flight_log.py`` (numpy only: the port
may not import the JAX package, whose ``__init__`` imports JAX), with
``read_tlog`` copied from ``sde4mbrl_px4_tpu/io/router.py:134-159`` (the
router itself is not ported yet).

- :class:`FlightRecorder` — accumulates per-tick records (state, command,
  reference, solver stats) and writes ``.npz`` flight logs, or ``.ulg``
  PX4 logs by the file's suffix (``io/ulog.py``);
- :func:`load_flight_log` reads an ``.npz`` log back;
- :func:`tlog_to_flight_log` decodes a router ``.tlog`` capture with the
  port's MAVLink codec (``io/mavlink.py::decode_frame``).
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["FlightRecorder", "load_flight_log", "read_tlog", "tlog_to_flight_log"]

_FIELDS = ("t", "state", "motors", "cmd_motors", "cmd_thrust_rates", "ref",
           "mpc_on", "weight_motors", "solve_time", "num_steps", "opt_cost",
           "mpc_indx")


class FlightRecorder:
    """Append-only in-memory flight log with .npz export."""

    def __init__(self):
        self._rows: List[Dict] = []

    def record(self, t: float, state: np.ndarray,
               cmd_motors: Optional[np.ndarray] = None,
               cmd_thrust_rates: Optional[np.ndarray] = None,
               ref: Optional[np.ndarray] = None,
               mpc_on: int = 0, weight_motors: int = 0,
               solve_time: float = 0.0, num_steps: int = 0,
               opt_cost: float = 0.0, mpc_indx: int = 0,
               motors: Optional[np.ndarray] = None) -> None:
        """``motors`` = ACHIEVED motor outputs (the m1..m4 readings the FCU
        reports in MPC_FULL_STATE) vs ``cmd_motors`` = COMMANDED — the pair
        the reference's v3 layout overlays (``actuator_motors/control`` vs
        ``mpc_motors_cmd/motor_val_des``, ``new_analyze_mpc_v3.xml``)."""
        self._rows.append(dict(
            t=float(t),
            state=np.asarray(state, np.float32).copy(),
            motors=(np.zeros(4, np.float32) if motors is None
                    else np.asarray(motors, np.float32).copy()),
            cmd_motors=(np.zeros(6, np.float32) if cmd_motors is None
                        else np.asarray(cmd_motors, np.float32).copy()),
            cmd_thrust_rates=(np.zeros(4, np.float32) if cmd_thrust_rates is None
                              else np.asarray(cmd_thrust_rates, np.float32).copy()),
            ref=(np.full(13, np.nan, np.float32) if ref is None
                 else np.asarray(ref, np.float32).copy()),
            mpc_on=int(mpc_on), weight_motors=int(weight_motors),
            solve_time=float(solve_time), num_steps=int(num_steps),
            opt_cost=float(opt_cost), mpc_indx=int(mpc_indx),
        ))

    def __len__(self) -> int:
        return len(self._rows)

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {}
        for f in _FIELDS:
            vals = [r[f] for r in self._rows]
            out[f] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
        return out

    def save(self, path: str) -> None:
        """Write the log: ``.npz`` (framework schema) or ``.ulg`` (PX4
        ULog with the standard topics, so PlotJuggler / PX4 Flight Review
        open it with the reference's committed layouts; io/ulog.py)."""
        path = os.path.expanduser(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if path.endswith(".ulg"):
            from sde4mbrl_px4_tpu_torch.io.ulog import flight_log_to_ulog

            flight_log_to_ulog(self.arrays(), path)
            return
        np.savez_compressed(path, **self.arrays())


def load_flight_log(path: str) -> Dict[str, np.ndarray]:
    d = np.load(os.path.expanduser(path))
    return {k: d[k] for k in d.files}


def read_tlog(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield ``(t_usec, frame)`` from a ``.tlog``. Frame length comes from
    the MAVLink header (v2: 12 + payload_len signature-less; v1: 8 +
    payload_len), so the file needs no separate framing. A record
    truncated at EOF (router killed mid-write) ends the iteration cleanly
    — the recoverable prefix is the flight log; a corrupt magic mid-file
    is still an error (that's damage, not truncation)."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + 10 <= len(data):        # timestamp + at least magic+len
        (t_usec,) = struct.unpack_from(">Q", data, off)
        off += 8
        magic = data[off]
        if magic == 0xFD:
            if off + 3 > len(data):
                return                   # truncated header at EOF
            n = 12 + data[off + 1] + (13 if data[off + 2] & 0x01 else 0)
        elif magic == 0xFE:
            n = 8 + data[off + 1]
        else:
            raise ValueError(f"{path}: bad frame magic 0x{magic:02x} at {off}")
        if off + n > len(data):
            return                       # truncated frame at EOF
        yield t_usec, data[off : off + n]
        off += n


def tlog_to_flight_log(path: str) -> Dict[str, np.ndarray]:
    """Decode a router flight log (``.tlog``, io/router.py Log/LogMode)
    into the framework flight-log schema.

    Rows follow the MPC_FULL_STATE stream (the vehicle's own time base,
    ``time_usec``); the command columns sample-and-hold the latest
    MPC_MOTORS_CMD seen before each state — exactly how the FCU applies
    them (ZOH between commands, ``sim/plant.py``)."""
    from sde4mbrl_px4_tpu_torch.io.mavlink import decode_frame

    rec = FlightRecorder()
    last_cmd = None
    for _t_wall, frame in read_tlog(path):
        msg = decode_frame(frame)
        if msg is None:
            continue
        if msg.get_type() == "MPC_MOTORS_CMD":
            last_cmd = msg
            continue
        kw = {}
        if last_cmd is not None:
            kw = dict(cmd_motors=last_cmd.motor_val_des,
                      cmd_thrust_rates=last_cmd.thrust_and_angrate_des,
                      mpc_on=int(last_cmd.mpc_on),
                      weight_motors=int(last_cmd.weight_motors))
        rec.record(msg.time_usec * 1e-6, msg.state, motors=msg.motors, **kw)
    if not len(rec):
        raise ValueError(f"{path}: no decodable MPC_FULL_STATE frames")
    return rec.arrays()
