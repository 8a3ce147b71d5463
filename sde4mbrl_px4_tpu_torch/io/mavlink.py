"""MAVLink v2 wire protocol for the MPC side-channel (L7).

Copied from ``sde4mbrl_px4_tpu/io/mavlink.py`` (numpy, sockets, ctypes):
the port may not import the JAX package, whose ``__init__`` imports JAX.

Python mirror of the C++ codec (``csrc/mavlink_codec.cpp``); both implement
the reference's custom-dialect wire contract — ``MPC_FULL_STATE`` (id 367)
and ``MPC_MOTORS_CMD`` (id 368), the only two messages the MPC endpoint
sees (router filter, reference ``scripts/router_sitl.conf:18-19``; field
sets read/written at ``sde_control.py:246,607-613``; SURVEY.md §2.11).

The C++ library is the production path (loaded via ctypes when built);
this pure-Python implementation is the fallback and the cross-parity test
reference. crc_extra is derived with the canonical MAVLink algorithm so
the two implementations (and any other conforming generator) interoperate.
"""
from __future__ import annotations

import ctypes
import os
import socket
import struct
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "MSG_ID_MPC_FULL_STATE",
    "MSG_ID_MPC_MOTORS_CMD",
    "MPCFullState",
    "MPCMotorsCmd",
    "encode_full_state",
    "encode_motors_cmd",
    "decode_frame",
    "crc_extra",
    "MavlinkUDP",
    "load_native",
]

MSG_ID_MPC_FULL_STATE = 367
MSG_ID_MPC_MOTORS_CMD = 368
_FULL_STATE_LEN = 76
_MOTORS_CMD_LEN = 50


# ---------------------------------------------------------------------------
# CRC-16/MCRF4XX
# ---------------------------------------------------------------------------

def _crc_acc(data: int, crc: int) -> int:
    tmp = (data ^ (crc & 0xFF)) & 0xFF
    tmp = (tmp ^ (tmp << 4)) & 0xFF
    return ((crc >> 8) ^ (tmp << 8) ^ (tmp << 3) ^ (tmp >> 4)) & 0xFFFF


def _crc_buf(buf: bytes, crc: int = 0xFFFF) -> int:
    for b in buf:
        crc = _crc_acc(b, crc)
    return crc


def crc_extra(msgid: int) -> int:
    """Canonical mavlink crc_extra over name + wire-ordered field defs."""
    if msgid == MSG_ID_MPC_FULL_STATE:
        name = "MPC_FULL_STATE"
        fields = [("uint64_t", "time_usec", 0)] + [
            ("float", n, 0)
            for n in ("x", "y", "z", "vx", "vy", "vz", "qw", "qx", "qy", "qz",
                      "wx", "wy", "wz", "m1", "m2", "m3", "m4")
        ]
    elif msgid == MSG_ID_MPC_MOTORS_CMD:
        name = "MPC_MOTORS_CMD"
        fields = [
            ("uint64_t", "time_usec", 0),
            ("float", "motor_val_des", 6),
            ("float", "thrust_and_angrate_des", 4),
            ("uint8_t", "mpc_on", 0),
            ("uint8_t", "weight_motors", 0),
        ]
    else:
        raise ValueError(f"unknown msgid {msgid}")
    crc = _crc_buf((name + " ").encode())
    for ftype, fname, alen in fields:
        crc = _crc_buf((ftype + " " + fname + " ").encode(), crc)
        if alen:
            crc = _crc_acc(alen, crc)
    return ((crc & 0xFF) ^ (crc >> 8)) & 0xFF


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------

@dataclass
class MPCFullState:
    """FCU -> MPC full vehicle state (13-state + motor readings)."""

    time_usec: int
    state: np.ndarray          # (13,) [x,y,z,vx..,qw..,wx..] f32, NED/FRD
    motors: np.ndarray         # (4,) measured motor outputs

    # pymavlink-style attribute access (msg.x, msg.qw, ... as the reference
    # reads them at sde_control.py:246).
    def __getattr__(self, k):
        names = ("x", "y", "z", "vx", "vy", "vz", "qw", "qx", "qy", "qz",
                 "wx", "wy", "wz")
        if k in names:
            return float(self.state[names.index(k)])
        if k in ("m1", "m2", "m3", "m4"):
            return float(self.motors[int(k[1]) - 1])
        raise AttributeError(k)

    def get_type(self):
        return "MPC_FULL_STATE"


@dataclass
class MPCMotorsCmd:
    """MPC -> FCU motor command (motors + thrust/body-rate fallback)."""

    time_usec: int
    motor_val_des: np.ndarray          # (6,)
    thrust_and_angrate_des: np.ndarray  # (4,) [thrust, wx, wy, wz]
    mpc_on: int
    weight_motors: int

    def get_type(self):
        return "MPC_MOTORS_CMD"


def _frame(msgid: int, payload: bytes, seq: int, sysid: int, compid: int) -> bytes:
    plen = len(payload)
    while plen > 1 and payload[plen - 1] == 0:
        plen -= 1
    payload = payload[:plen]
    hdr = struct.pack(
        "<BBBBBBB", 0xFD, plen, 0, 0, seq & 0xFF, sysid & 0xFF, compid & 0xFF
    ) + struct.pack("<I", msgid)[:3]
    crc = _crc_buf(hdr[1:] + payload)
    crc = _crc_acc(crc_extra(msgid), crc)
    return hdr + payload + struct.pack("<H", crc)


def encode_full_state(time_usec: int, state13, motors4=None, seq: int = 0,
                      sysid: int = 1, compid: int = 1) -> bytes:
    state13 = np.asarray(state13, np.float32)
    motors4 = np.zeros(4, np.float32) if motors4 is None else np.asarray(motors4, np.float32)
    payload = struct.pack("<Q", int(time_usec)) + state13.tobytes() + motors4.tobytes()
    assert len(payload) == _FULL_STATE_LEN
    return _frame(MSG_ID_MPC_FULL_STATE, payload, seq, sysid, compid)


def encode_motors_cmd(time_usec: int, motor_val_des, thrust_and_angrate_des,
                      mpc_on: int, weight_motors: int, seq: int = 0,
                      sysid: int = 1, compid: int = 1) -> bytes:
    m = np.zeros(6, np.float32)
    mv = np.asarray(motor_val_des, np.float32)
    m[: mv.shape[0]] = mv
    w = np.asarray(thrust_and_angrate_des, np.float32)
    payload = (
        struct.pack("<Q", int(time_usec)) + m.tobytes() + w.tobytes()
        + struct.pack("<BB", int(mpc_on) & 0xFF, int(weight_motors) & 0xFF)
    )
    assert len(payload) == _MOTORS_CMD_LEN
    return _frame(MSG_ID_MPC_MOTORS_CMD, payload, seq, sysid, compid)


def decode_frame(buf: bytes):
    """Decode one v2 frame -> MPCFullState | MPCMotorsCmd | None (bad/unknown)."""
    if len(buf) < 12 or buf[0] != 0xFD:
        return None
    plen = buf[1]
    if len(buf) < 12 + plen:
        return None
    msgid = buf[7] | (buf[8] << 8) | (buf[9] << 16)
    try:
        extra = crc_extra(msgid)
    except ValueError:
        return None
    crc = _crc_acc(extra, _crc_buf(buf[1 : 10 + plen]))
    (rx,) = struct.unpack_from("<H", buf, 10 + plen)
    if crc != rx:
        return None
    full_len = _FULL_STATE_LEN if msgid == MSG_ID_MPC_FULL_STATE else _MOTORS_CMD_LEN
    payload = bytes(buf[10 : 10 + plen]) + b"\x00" * (full_len - plen)
    if msgid == MSG_ID_MPC_FULL_STATE:
        (t,) = struct.unpack_from("<Q", payload, 0)
        vals = np.frombuffer(payload, np.float32, count=17, offset=8)
        return MPCFullState(time_usec=t, state=vals[:13].copy(), motors=vals[13:].copy())
    (t,) = struct.unpack_from("<Q", payload, 0)
    vals = np.frombuffer(payload, np.float32, count=10, offset=8)
    return MPCMotorsCmd(
        time_usec=t,
        motor_val_des=vals[:6].copy(),
        thrust_and_angrate_des=vals[6:10].copy(),
        mpc_on=payload[48],
        weight_motors=payload[49],
    )


# ---------------------------------------------------------------------------
# Native library
# ---------------------------------------------------------------------------

_NATIVE = None


def load_native() -> Optional[ctypes.CDLL]:
    """Load the C++ codec (csrc/libmpc_native.so) if built; else None."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    so = os.path.join(here, "csrc", "libmpc_native.so")
    if not os.path.exists(so):
        return None
    lib = ctypes.CDLL(so)
    lib.mav_encode_full_state.restype = ctypes.c_int
    lib.mav_encode_motors_cmd.restype = ctypes.c_int
    lib.mav_frame_decode.restype = ctypes.c_int
    lib.mav_crc_extra.restype = ctypes.c_int
    _NATIVE = lib
    return lib


# ---------------------------------------------------------------------------
# UDP endpoint (pymavlink's mavutil.mavlink_connection('udpin:...') stand-in,
# reference sde_control.py:117)
# ---------------------------------------------------------------------------

class MavlinkUDP:
    """Minimal UDP MAVLink endpoint.

    ``udpin`` (bind/server) or ``udpout`` (connect/client) like pymavlink.
    ``recv_match(type=..., timeout=...)`` mirrors the reference's listener
    loop call (``sde_control.py:145``).
    """

    def __init__(self, addr: str, mode: str = "udpin"):
        host, port = addr.rsplit(":", 1)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._peer = None
        self.seq = 0
        if mode == "udpin":
            self.sock.bind((host, int(port)))
        else:
            self.sock.connect((host, int(port)))
            self._peer = (host, int(port))
        self.mode = mode

    def recv_match(self, type: Optional[str] = None, blocking: bool = True,
                   timeout: Optional[float] = 0.1):
        deadline = (None if not blocking or timeout is None
                    else time.monotonic() + timeout)
        try:
            while True:
                if deadline is None:
                    self.sock.settimeout(timeout if blocking else 0.0)
                else:
                    # Re-arm with the REMAINING window so swallowed errors
                    # below can't extend the call past its deadline.
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self.sock.settimeout(remaining)
                # A connected (udpout) socket surfaces ICMP port-unreachable
                # as ConnectionRefusedError when the peer is not up yet
                # (e.g. fcu_sim launched before the engine). UDP MAVLink is
                # lossy by contract — swallow and keep listening.
                try:
                    buf, peer = self.sock.recvfrom(512)
                except ConnectionRefusedError:
                    continue
                if self.mode == "udpin":
                    self._peer = peer
                msg = decode_frame(buf)
                if msg is None:
                    continue
                if type is None or msg.get_type() == type:
                    return msg
        except (socket.timeout, BlockingIOError):
            return None

    def _send(self, frame: bytes):
        try:
            if self.mode == "udpin":
                if self._peer is None:
                    raise RuntimeError("no peer yet; receive first (server mode)")
                self.sock.sendto(frame, self._peer)
            else:
                self.sock.send(frame)
        except ConnectionRefusedError:
            pass  # peer not up yet — UDP datagrams drop, they don't fail
        self.seq = (self.seq + 1) & 0xFF

    def send_full_state(self, time_usec: int, state13, motors4=None):
        self._send(encode_full_state(time_usec, state13, motors4, seq=self.seq))

    def send_motors_cmd(self, time_usec: int, motor_val_des,
                        thrust_and_angrate_des, mpc_on: int, weight_motors: int):
        self._send(
            encode_motors_cmd(time_usec, motor_val_des, thrust_and_angrate_des,
                              mpc_on, weight_motors, seq=self.seq)
        )

    def close(self):
        self.sock.close()
