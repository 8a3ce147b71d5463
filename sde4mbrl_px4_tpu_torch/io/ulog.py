"""PX4 ULog file IO — dependency-free reader/writer.

Copied from ``sde4mbrl_px4_tpu/io/ulog.py`` (numpy only; the port may not
import the JAX package): the same reader, and a writer whose bytes equal
the original's for the same log.

The reference's offline-analysis pipeline runs on PX4 ULog flight logs
(PlotJuggler layouts over ``actuator_motors``/``vehicle_rates_setpoint``
curves, ``launch/new_analyze_mpc_v3.xml``; SURVEY.md §2.14). This module
closes both directions of that workflow without external packages:

- :func:`read_ulog` — parse a ``.ulg`` file (format spec:
  https://docs.px4.io/main/en/dev_log/ulog_file_format.html) into
  per-topic NumPy column dicts;
- :func:`ulog_to_flight_log` — resample the standard PX4 topics
  (``vehicle_local_position``, ``vehicle_attitude``,
  ``vehicle_angular_velocity``, ``actuator_motors``,
  ``vehicle_rates_setpoint``) onto one timeline in this framework's
  flight-log schema, so ``tools/analyze.py`` renders REAL flights;
- :func:`flight_log_to_ulog` — export a framework flight log (``.npz``
  schema of ``io/flight_log.py``) as a ULog with those same topics, so
  PlotJuggler / PX4 Flight Review open OUR logs with the reference's
  committed layouts.

Scope: basic scalar/array field types (the standard vehicle topics use
nothing else); messages with nested struct fields are skipped on read.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["read_ulog", "write_ulog", "ulog_to_flight_log",
           "flight_log_to_ulog"]

_MAGIC = b"ULog\x01\x12\x35"

# ULog basic type -> (numpy dtype, size)
_TYPES = {
    "int8_t": "i1", "uint8_t": "u1", "int16_t": "i2", "uint16_t": "u2",
    "int32_t": "i4", "uint32_t": "u4", "int64_t": "i8", "uint64_t": "u8",
    "float": "f4", "double": "f8", "bool": "u1", "char": "S1",
}


def _parse_format(fmt: str) -> Tuple[str, Optional[np.dtype]]:
    """'name:type a;type[4] b;' -> (name, numpy struct dtype or None if the
    format uses nested (non-basic) types)."""
    name, _, body = fmt.partition(":")
    fields: List[Tuple[str, str, Tuple[int, ...]]] = []
    for f in body.split(";"):
        f = f.strip()
        if not f:
            continue
        typ, _, fname = f.partition(" ")
        n = 1
        if "[" in typ:
            typ, _, cnt = typ.partition("[")
            n = int(cnt.rstrip("]"))
        base = _TYPES.get(typ)
        if base is None:
            return name, None  # nested type: unsupported, skip topic
        if n == 1:
            fields.append((fname, base))
        else:
            fields.append((fname, base, (n,)))
    # ULog spec: a TRAILING padding field is elided from each data message
    # (it only pads the in-memory struct) — drop it so the dtype matches
    # the wire layout, else every row after the first misaligns on real
    # PX4 logs (e.g. vehicle_attitude's 'uint8_t[4] _padding0' tail).
    if fields and fields[-1][0].startswith("_padding"):
        fields.pop()
    return name, np.dtype(fields)


def read_ulog(path: str, topics: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse a .ulg file.

    Returns ``{"start_timestamp": usec, "info": {...}, "params": {...},
    "data": {topic_name: {field: np.ndarray}}}``. Multi-instance topics get
    ``name.N`` keys for N > 0. ``topics`` limits which topics are kept.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:7] != _MAGIC or len(raw) < 16:
        raise ValueError(f"{path}: not a ULog file")
    start_ts = struct.unpack_from("<Q", raw, 8)[0]

    formats: Dict[str, Optional[np.dtype]] = {}
    subs: Dict[int, Tuple[str, int]] = {}      # msg_id -> (topic, multi_id)
    buffers: Dict[int, bytearray] = {}
    info: Dict[str, Any] = {}
    params: Dict[str, Any] = {}

    off = 16
    n = len(raw)
    while off + 3 <= n:
        size, mtype = struct.unpack_from("<HB", raw, off)
        off += 3
        if off + size > n:
            break  # truncated tail (mid-write logs) — keep what we have
        payload = raw[off: off + size]
        off += size
        t = chr(mtype)
        # Per-message bodies from real (or corrupt) logs can be shorter
        # than their type requires — skip malformed ones, never raise
        # (the never-crash contract the fuzz tests pin down).
        if t == "F":
            name, dt = _parse_format(payload.decode("ascii", "replace"))
            formats[name] = dt
        elif t == "A":
            if len(payload) < 4:
                continue
            multi_id, msg_id = struct.unpack_from("<BH", payload, 0)
            topic = payload[3:].decode("ascii", "replace")
            subs[msg_id] = (topic, multi_id)
            buffers.setdefault(msg_id, bytearray())
        elif t == "D":
            if len(payload) < 2:
                continue
            (msg_id,) = struct.unpack_from("<H", payload, 0)
            if msg_id in buffers:
                buffers[msg_id] += payload[2:]
        elif t in ("I", "M"):
            o = 1 if t == "I" else 2           # M has an extra is_continued
            if len(payload) < o:
                continue
            klen = payload[o - 1]
            if len(payload) < o + klen:
                continue
            key = payload[o: o + klen].decode("ascii", "replace")
            info[key] = payload[o + klen:]
        elif t in ("P", "Q"):
            if not payload:
                continue
            klen = payload[0]
            if len(payload) < 1 + klen:
                continue
            key = payload[1: 1 + klen].decode("ascii", "replace")
            parts = key.split(" ", 1)
            val = payload[1 + klen:]
            if len(parts) == 2 and len(val) >= 4:
                if parts[0] == "float":
                    params[parts[1]] = struct.unpack("<f", val[:4])[0]
                elif parts[0] == "int32_t":
                    params[parts[1]] = struct.unpack("<i", val[:4])[0]
        # 'B', 'L', 'C', 'O', 'S', 'R': flags/log-strings/sync — no payload
        # we need; skipped by construction.

    data: Dict[str, Dict[str, np.ndarray]] = {}
    for msg_id, (topic, multi_id) in subs.items():
        dt = formats.get(topic)
        if dt is None:
            continue
        if topics is not None and topic not in topics:
            continue
        buf = bytes(buffers.get(msg_id, b""))
        if dt.itemsize == 0:  # zero-field format ("name:"): nothing to read
            continue
        cnt = len(buf) // dt.itemsize
        if cnt == 0:
            continue
        arr = np.frombuffer(buf[: cnt * dt.itemsize], dtype=dt)
        key = topic if multi_id == 0 else f"{topic}.{multi_id}"
        data[key] = {fname: np.array(arr[fname]) for fname in dt.names
                     if not fname.startswith("_padding")}
    return {"start_timestamp": start_ts, "info": info, "params": params,
            "data": data}


# --------------------------------------------------------------------- write

class _Writer:
    def __init__(self, f, start_ts_usec: int = 0):
        self.f = f
        f.write(_MAGIC + b"\x01" + struct.pack("<Q", start_ts_usec))
        # flag-bits message (compat/incompat all zero, no appended data)
        self._msg(ord("B"), b"\x00" * 40)
        self._next_id = 0

    def _msg(self, mtype: int, payload: bytes) -> None:
        self.f.write(struct.pack("<HB", len(payload), mtype) + payload)

    def fmt(self, format_str: str) -> None:
        self._msg(ord("F"), format_str.encode("ascii"))

    def subscribe(self, topic: str, multi_id: int = 0) -> int:
        mid = self._next_id
        self._next_id += 1
        self._msg(ord("A"), struct.pack("<BH", multi_id, mid)
                  + topic.encode("ascii"))
        return mid

    def data(self, msg_id: int, payload: bytes) -> None:
        self._msg(ord("D"), struct.pack("<H", msg_id) + payload)


def write_ulog(path: str, topics: Dict[str, Dict[str, np.ndarray]],
               start_ts_usec: int = 0) -> None:
    """Write ``{topic: {field: column}}`` as a .ulg file. Every topic must
    carry a ``timestamp`` column (uint64 µs, ULog convention). Column
    dtypes map onto ULog basic types; float columns are written as
    ``float``, the timestamp as ``uint64_t``."""
    def _ulog_type(col: np.ndarray, fname: str) -> str:
        if fname == "timestamp":
            return "uint64_t"
        k = np.asarray(col).dtype.kind
        return {"f": "float", "i": "int32_t", "u": "uint32_t",
                "b": "bool"}[k]

    with open(path, "wb") as f:
        w = _Writer(f, start_ts_usec)
        dts: Dict[str, np.dtype] = {}
        for topic, cols in topics.items():
            parts = []
            fields = []
            for fname, col in cols.items():
                col = np.asarray(col)
                ut = _ulog_type(col, fname)
                base = _TYPES[ut]
                if col.ndim == 2:
                    parts.append(f"{ut}[{col.shape[1]}] {fname}")
                    fields.append((fname, base, (col.shape[1],)))
                else:
                    parts.append(f"{ut} {fname}")
                    fields.append((fname, base))
            w.fmt(f"{topic}:" + ";".join(parts) + ";")
            dts[topic] = np.dtype(fields)
        for topic, cols in topics.items():
            mid = w.subscribe(topic)
            dt = dts[topic]
            n = len(np.asarray(cols["timestamp"]))
            rec = np.zeros(n, dtype=dt)
            for fname, col in cols.items():
                rec[fname] = np.asarray(col)  # numpy casts on assignment
            for row in rec:
                w.data(mid, row.tobytes())


# ----------------------------------------------------------------- bridging

def _interp_cols(t_usec: np.ndarray, src_t: np.ndarray,
                 col: np.ndarray) -> np.ndarray:
    """Per-column linear resample onto the target µs timeline."""
    col = np.asarray(col, np.float64)
    if col.ndim == 1:
        return np.interp(t_usec, src_t, col)
    return np.stack([np.interp(t_usec, src_t, col[:, j])
                     for j in range(col.shape[1])], axis=1)


def ulog_to_flight_log(path: str) -> Dict[str, np.ndarray]:
    """Map a PX4 ULog onto the framework flight-log schema
    (``io/flight_log.py``: t, state[13], cmd_motors[6],
    cmd_thrust_rates[4], ...), resampled onto the
    ``vehicle_local_position`` timeline. Missing topics yield zero
    columns (real logs don't always record every topic)."""
    log = read_ulog(path)
    d = log["data"]
    if "vehicle_local_position" not in d:
        raise ValueError(f"{path}: no vehicle_local_position topic")
    lp = d["vehicle_local_position"]
    t_usec = np.asarray(lp["timestamp"], np.float64)
    nrow = len(t_usec)

    state = np.zeros((nrow, 13), np.float32)
    for j, k in enumerate(("x", "y", "z", "vx", "vy", "vz")):
        if k in lp:
            state[:, j] = np.asarray(lp[k], np.float32)
    if "vehicle_attitude" in d and "q" in d["vehicle_attitude"]:
        att = d["vehicle_attitude"]
        state[:, 6:10] = _interp_cols(t_usec, np.asarray(att["timestamp"],
                                                         np.float64),
                                      att["q"]).astype(np.float32)
    else:
        state[:, 6] = 1.0
    if "vehicle_angular_velocity" in d and "xyz" in d["vehicle_angular_velocity"]:
        av = d["vehicle_angular_velocity"]
        state[:, 10:13] = _interp_cols(t_usec, np.asarray(av["timestamp"],
                                                          np.float64),
                                       av["xyz"]).astype(np.float32)

    cmd_motors = np.zeros((nrow, 6), np.float32)
    if "actuator_motors" in d and "control" in d["actuator_motors"]:
        am = d["actuator_motors"]
        ctl = np.asarray(am["control"])[:, :6]
        cmd_motors = _interp_cols(t_usec, np.asarray(am["timestamp"],
                                                     np.float64),
                                  ctl).astype(np.float32)

    cmd_tr = np.zeros((nrow, 4), np.float32)
    if "vehicle_rates_setpoint" in d:
        rs = d["vehicle_rates_setpoint"]
        rt = np.asarray(rs["timestamp"], np.float64)
        for j, k in enumerate(("roll", "pitch", "yaw")):
            if k in rs:
                cmd_tr[:, 1 + j] = _interp_cols(t_usec, rt,
                                                rs[k]).astype(np.float32)
        if "thrust_body" in rs:
            tb = np.asarray(rs["thrust_body"])
            cmd_tr[:, 0] = -_interp_cols(t_usec, rt,
                                         tb[:, 2]).astype(np.float32)

    zeros = np.zeros(nrow, np.float32)
    return {
        "t": (t_usec - t_usec[0]) / 1e6,
        "state": state,
        "cmd_motors": cmd_motors,
        "cmd_thrust_rates": cmd_tr,
        # NaN = "no reference" in the flight-log schema (FlightRecorder);
        # zeros would make analyze.py overlay a bogus origin-pinned ref.
        "ref": np.full((nrow, 13), np.nan, np.float32),
        "mpc_on": zeros.astype(np.int64),
        "weight_motors": zeros.astype(np.int64),
        "solve_time": zeros,
        "num_steps": zeros.astype(np.int64),
        "opt_cost": zeros,
        "mpc_indx": zeros.astype(np.int64),
    }


def flight_log_to_ulog(log: Dict[str, np.ndarray], path: str) -> None:
    """Export a framework flight log as a ULog with the standard PX4
    topics the reference's PlotJuggler layouts plot
    (``launch/new_analyze_mpc_v3.xml`` curves)."""
    t_usec = (np.asarray(log["t"], np.float64) * 1e6).astype(np.uint64)
    state = np.asarray(log["state"], np.float32)
    topics: Dict[str, Dict[str, np.ndarray]] = {
        "vehicle_local_position": {
            "timestamp": t_usec,
            "x": state[:, 0], "y": state[:, 1], "z": state[:, 2],
            "vx": state[:, 3], "vy": state[:, 4], "vz": state[:, 5],
        },
        "vehicle_attitude": {
            "timestamp": t_usec, "q": state[:, 6:10],
        },
        "vehicle_angular_velocity": {
            "timestamp": t_usec, "xyz": state[:, 10:13],
        },
    }
    cm = np.asarray(log.get("cmd_motors", np.zeros((len(t_usec), 6))),
                    np.float32)
    # actuator_motors = ACHIEVED outputs (PX4 semantics) when the log
    # carries the FCU's m1..m4 readings; legacy logs WITHOUT the field
    # fall back to the commanded values so existing layouts keep
    # rendering. Presence decides, not values: an all-zero achieved
    # column (never-armed capture) is real data — exporting commands in
    # its place would overlay the command against itself in the
    # cmd-vs-achieved layout and fake perfect tracking.
    have_achieved = "motors" in log
    am = np.asarray(log["motors"], np.float32) if have_achieved else cm
    topics["actuator_motors"] = {"timestamp": t_usec, "control": am}
    tr = np.asarray(log.get("cmd_thrust_rates", np.zeros((len(t_usec), 4))),
                    np.float32)
    topics["vehicle_rates_setpoint"] = {
        "timestamp": t_usec,
        "roll": tr[:, 1], "pitch": tr[:, 2], "yaw": tr[:, 3],
        "thrust_body": np.stack(
            [np.zeros_like(tr[:, 0]), np.zeros_like(tr[:, 0]), -tr[:, 0]],
            axis=1),
    }
    # The raw MPC command channel under its own topic — the curves the
    # reference's v3 layout overlays against the achieved motors/rates
    # (``new_analyze_mpc_v3.xml``: mpc_motors_cmd/motor_val_des.* vs
    # actuator_motors/control.*, thrust_and_angrate_des.* vs
    # vehicle_angular_velocity/xyz.*; ported layout:
    # configs/layouts/pj_mpc_cmd_vs_achieved.xml). Both channels here are
    # NED/FRD body frame, so no sign flips are needed in the layout (the
    # reference's -1 scales compensate its own frame mix).
    mpc_on = np.asarray(log.get("mpc_on", np.zeros(len(t_usec))), np.float32)
    wm = np.asarray(log.get("weight_motors", np.zeros(len(t_usec))),
                    np.float32)
    topics["mpc_motors_cmd"] = {
        "timestamp": t_usec,
        "motor_val_des": cm,
        "thrust_and_angrate_des": tr,
        "mpc_on": mpc_on,
        "weight_motors": wm,
    }
    write_ulog(path, topics,
               start_ts_usec=int(t_usec[0]) if len(t_usec) else 0)
