"""MAVLink stream router (L7) — the ``mavlink-routerd`` replacement.

Copied from ``sde4mbrl_px4_tpu/io/router.py`` (sockets, termios, ctypes):
the port may not import the JAX package, whose ``__init__`` imports JAX.
CRC verdicts come from the port's codec (``io/mavlink.py``), and
:class:`NativeRouter` loads ``csrc/libmpc_native.so`` through the port's
``io/mavlink.py::load_native``, as the mailbox does.

The reference fans the FCU's MAVLink stream out with mavlink-routerd:
full stream to mavros, and ONLY the MPC messages (id 367 out / 368 in) to
the MPC endpoint, configured in INI-style conf files
(``scripts/router_sitl.conf``; SURVEY.md §2.8). This module implements the
same topology natively:

- :class:`Endpoint` — a UDP endpoint in ``Server`` mode (bind, learn the
  peer from inbound traffic — the conf's ``Mode = Server``) or ``Normal``
  mode (send to a fixed address, also bind to receive);
- :class:`Router` — forwards every frame received on one endpoint to all
  others, applying per-endpoint ``AllowMsgIdIn`` / ``AllowMsgIdOut``
  filters exactly as mavlink-router does (Out = messages allowed to be
  sent OUT of the router to that endpoint; In = messages accepted IN from
  that endpoint);
- :func:`parse_conf` — reads the reference's conf syntax (sections,
  ``Key = Value``, ``#`` comments), e.g. ``scripts/router_sitl.conf:13-19``.

Only frame headers are inspected (msgid at bytes 7..9 of a v2 frame);
payloads pass through untouched, so the router is dialect-agnostic like
the original.

Flight logging (``[General]`` ``Log = <dir>`` / ``LogMode = always|
while-armed``, present-but-commented in the reference conf,
``scripts/router_sitl.conf:27-28``): every frame the router ACCEPTS is
appended to a ``.tlog`` in the configured directory (the pymavlink tlog
format: 8-byte big-endian µs timestamp + raw frame), gated on the vehicle
arm state learned from HEARTBEAT when mode is ``while-armed``. Replay with
:func:`read_tlog` — each frame decodes through the same
``io/mavlink.decode_frame`` the live analysis view uses
(``sim/analyze.py --live``).
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

__all__ = ["Endpoint", "SerialEndpoint", "Deframer", "Router",
           "NativeRouter", "parse_conf", "parse_general", "GeneralConf",
           "FrameLog", "read_tlog", "next_log_path", "native_router_supports"]


def _msgid(frame: bytes) -> Optional[int]:
    if len(frame) >= 10 and frame[0] == 0xFD:
        return frame[7] | (frame[8] << 8) | (frame[9] << 16)
    if len(frame) >= 6 and frame[0] == 0xFE:  # v1 frames: 1-byte msgid
        return frame[5]
    return None


def _heartbeat_armed(frame: bytes) -> Optional[bool]:
    """Arm bit from an AUTOPILOT HEARTBEAT (msgid 0), else None.

    Only component MAV_COMP_ID_AUTOPILOT1 (1) gates the arm state — a GCS
    or companion heartbeat (compid 190/191/...) reports ITS OWN base_mode
    with the armed bit clear, and trusting it would disarm the log gate
    once per second mid-flight (mavlink-router gates on the flight stack's
    heartbeat the same way). base_mode is payload byte 6 (custom_mode u32,
    type, autopilot, base_mode, ...); bit 0x80 =
    MAV_MODE_FLAG_SAFETY_ARMED. MAVLink v2 zero-trims trailing payload
    bytes, so a missing byte means base_mode 0 = disarmed.
    """
    if _msgid(frame) != 0:
        return None
    if frame[0] == 0xFD:
        off, compid = 10, frame[6]
    else:
        off, compid = 6, frame[4]
    if compid != 1:                      # not the autopilot's heartbeat
        return None
    plen = frame[1]
    if plen > 6 and len(frame) >= off + 7:
        return bool(frame[off + 6] & 0x80)
    return False


@dataclass
class GeneralConf:
    """``[General]`` section of a router conf — the flight-logging knobs
    (mavlink-router's ``Log``/``LogMode``; other keys are accepted and
    ignored, as the daemon's TCP/stat options have no analogue here)."""

    log_dir: Optional[str] = None
    log_mode: str = "while-armed"     # "always" | "while-armed"


def next_log_path(log_dir: str) -> str:
    """Sequential flight-log name in ``log_dir`` (mavlink-router style:
    zero-padded index so lexicographic == chronological)."""
    os.makedirs(log_dir, exist_ok=True)
    existing = [f for f in os.listdir(log_dir)
                if f.endswith(".tlog") and f[:5].isdigit()]
    nxt = 1 + max((int(f[:5]) for f in existing), default=0)
    return os.path.join(
        log_dir, f"{nxt:05d}-{time.strftime('%Y-%m-%d_%H-%M-%S')}.tlog")


class FrameLog:
    """Append-only ``.tlog`` writer (8-byte big-endian µs timestamp + raw
    frame — the pymavlink tlog convention), arm-gated in ``while-armed``
    mode. Thread-safe: the Python router pumps one thread per endpoint."""

    def __init__(self, path: str, mode: str = "always"):
        if mode not in ("always", "while-armed"):
            raise ValueError(f"LogMode {mode!r}: use always or while-armed")
        self.path = path
        self.mode = mode
        self.armed = False
        self.frames_logged = 0
        self._lock = threading.Lock()
        self._f = open(path, "ab")

    def log(self, frame: bytes) -> None:
        armed = _heartbeat_armed(frame)
        with self._lock:
            if armed is not None:
                self.armed = armed
            if self.mode == "while-armed" and not self.armed:
                return
            self._f.write(struct.pack(">Q", int(time.time() * 1e6)) + frame)
            self.frames_logged += 1

    def close(self) -> None:
        with self._lock:
            self._f.close()


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


@dataclass
class Endpoint:
    name: str
    address: str
    port: int
    mode: str = "Normal"                      # "Server" | "Normal"
    allow_in: Optional[Set[int]] = None       # None = allow all
    allow_out: Optional[Set[int]] = None
    sock: socket.socket = field(default=None, repr=False)  # type: ignore
    peer: Optional[Tuple[str, int]] = None

    def open(self) -> None:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.mode == "Server":
            self.sock.bind((self.address, self.port))
        else:
            # Normal mode: bind an ephemeral port and talk to the fixed peer.
            self.sock.bind(("0.0.0.0", 0))
            self.peer = (self.address, self.port)
        self.sock.settimeout(0.1)

    @property
    def bound_port(self) -> int:
        return self.sock.getsockname()[1]

    def send(self, frame: bytes) -> None:
        if self.peer is None:
            return  # Server endpoint with no known peer yet
        mid = _msgid(frame)
        if self.allow_out is not None and (mid is None or mid not in self.allow_out):
            return
        try:
            self.sock.sendto(frame, self.peer)
        except OSError:
            pass

    def recv(self) -> Optional[bytes]:
        try:
            frame, peer = self.sock.recvfrom(65535)
        except (socket.timeout, OSError):
            return None
        if self.mode == "Server":
            self.peer = peer
        mid = _msgid(frame)
        if self.allow_in is not None and (mid is None or mid not in self.allow_in):
            return None
        return frame

    def close(self) -> None:
        if self.sock:
            self.sock.close()


def _frame_crc_verdict(frame: bytes) -> Optional[bool]:
    """CRC verdict for one complete v1/v2 frame: True/False when the
    msgid belongs to the known dialect, None when it cannot be judged
    (unknown msgid — the router stays dialect-agnostic)."""
    from sde4mbrl_px4_tpu_torch.io import mavlink as _mav

    mid = _msgid(frame)
    if mid is None:
        return None
    try:
        extra = _mav.crc_extra(mid)
    except ValueError:
        return None
    plen = frame[1]
    hdr = 9 if frame[0] == 0xFD else 5
    crc = _mav._crc_buf(frame[1 : 1 + hdr + plen])
    crc = _mav._crc_acc(extra, crc)
    rx = frame[1 + hdr + plen] | (frame[2 + hdr + plen] << 8)
    return crc == rx


class Deframer:
    """MAVLink stream reassembler for byte-stream transports (UART).

    UDP delivers one frame per datagram, but a serial link is a byte
    stream: frames arrive fragmented and concatenated, so the router must
    re-frame before it can filter/forward (mavlink-routerd does the same
    for its UartEndpoints). ``feed(bytes)`` returns every COMPLETE frame
    terminated inside the data so far; partial tails are buffered. Bytes
    that are not a valid v1/v2 frame start are skipped until the next
    0xFD/0xFE magic, and a known-dialect frame that fails CRC resyncs ONE
    byte in — so a corrupted length byte costs one frame, not the good
    frames its fake length would have swallowed (mavlink-routerd
    semantics; frames of unknown dialects pass through unvalidated).
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        frames: List[bytes] = []
        buf = self._buf
        off = 0
        while True:
            # resync: scan to the next frame magic
            while off < len(buf) and buf[off] not in (0xFD, 0xFE):
                off += 1
            if off + 2 > len(buf):
                break                        # need magic + len byte
            if buf[off] == 0xFD:
                if off + 3 > len(buf):
                    break                    # v2 length needs incompat flags
                n = 12 + buf[off + 1] + (13 if buf[off + 2] & 0x01 else 0)
            else:
                n = 8 + buf[off + 1]
            if off + n > len(buf):
                break                        # incomplete tail: keep buffering
            cand = bytes(buf[off : off + n])
            if _frame_crc_verdict(cand) is False:
                off += 1                     # corrupt known frame: resync +1
                continue
            frames.append(cand)
            off += n
        del buf[:off]
        return frames


@dataclass
class SerialEndpoint:
    """UART endpoint (conf ``[UartEndpoint X]`` ``Device``/``Baud`` — the
    reference flies the real hexa through one at 921600 baud,
    ``scripts/router_hexa.conf:2-4``). Raw termios byte stream with
    MAVLink re-framing on receive; same filter semantics as
    :class:`Endpoint`. A pty pair stands in for the wire in tests (ptys
    ignore baud, so a failed baud ioctl is tolerated there)."""

    name: str
    device: str
    baud: int = 57600
    allow_in: Optional[Set[int]] = None
    allow_out: Optional[Set[int]] = None
    fd: int = -1
    _deframer: Deframer = field(default_factory=Deframer, repr=False)
    _pending: List[bytes] = field(default_factory=list, repr=False)

    def open(self) -> None:
        import termios

        # O_NONBLOCK: without it, open(2) on a modem-control line blocks
        # on carrier-detect before CLOCAL can even be applied (the C++
        # twin guards the same way, csrc/router.cpp router_add_uart).
        self.fd = os.open(self.device,
                          os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
        try:
            attrs = termios.tcgetattr(self.fd)
            # raw 8N1 (cfmakeraw equivalent)
            attrs[0] = 0                                   # iflag
            attrs[1] = 0                                   # oflag
            attrs[2] = (termios.CS8 | termios.CREAD |
                        termios.CLOCAL)                    # cflag
            attrs[3] = 0                                   # lflag
            attrs[6] = list(attrs[6])
            attrs[6][termios.VMIN] = 0
            attrs[6][termios.VTIME] = 1                    # 100 ms read gate
            rate = getattr(termios, f"B{self.baud}", None)
            if rate is not None:
                attrs[4] = attrs[5] = rate                 # ispeed/ospeed
            termios.tcsetattr(self.fd, termios.TCSANOW, attrs)
        except termios.error:
            pass  # pty test harness: raw/baud ioctls may be unsupported

    @property
    def bound_port(self) -> int:  # interface parity with Endpoint
        return -1

    def send(self, frame: bytes) -> None:
        mid = _msgid(frame)
        if self.allow_out is not None and (mid is None or
                                           mid not in self.allow_out):
            return
        try:
            os.write(self.fd, frame)
        except OSError:
            pass

    def recv(self) -> Optional[bytes]:
        if self._pending:
            return self._check_in(self._pending.pop(0))
        try:
            data = os.read(self.fd, 65536)
        except BlockingIOError:
            time.sleep(0.01)  # non-blocking fd, nothing buffered
            return None
        except OSError:
            # device died (unplugged adapter: EIO/ENXIO) — back off hard
            # instead of busy-spinning the pump thread at 100% CPU
            time.sleep(0.1)
            return None
        if not data:
            time.sleep(0.01)  # EOF/no data: don't spin the pump thread
            return None
        frames = self._deframer.feed(data)
        if not frames:
            return None
        self._pending = frames[1:]
        return self._check_in(frames[0])

    def _check_in(self, frame: bytes) -> Optional[bytes]:
        mid = _msgid(frame)
        if self.allow_in is not None and (mid is None or
                                          mid not in self.allow_in):
            return None
        return frame

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


class Router:
    """Fan frames from each endpoint to every other endpoint.

    ``log_dir``/``log_mode`` enable flight logging of every ACCEPTED frame
    (post ``AllowMsgIdIn``) — the ``[General]`` ``Log``/``LogMode``
    directives (:func:`parse_general`)."""

    def __init__(self, endpoints: List[Endpoint],
                 log_dir: Optional[str] = None,
                 log_mode: str = "while-armed"):
        self.endpoints = endpoints
        self._threads: List[threading.Thread] = []
        self._opened: List[Endpoint] = []
        self._running = False
        self.stats: Dict[str, int] = {e.name: 0 for e in endpoints}
        self.log_dir, self.log_mode = log_dir, log_mode
        self.framelog: Optional[FrameLog] = None

    def start(self) -> None:
        """Open every endpoint, then start one pump thread per endpoint:
        frames flow before this returns. An interrupt part way (a SIGTERM
        raised as ``KeyboardInterrupt`` inside a ``Thread.start``) leaves a
        partial start that :meth:`stop` takes down."""
        for e in self.endpoints:
            e.open()
            self._opened.append(e)
        if self.log_dir:
            self.framelog = FrameLog(next_log_path(self.log_dir),
                                     self.log_mode)
        self._running = True
        for e in self.endpoints:
            th = threading.Thread(target=self._pump, args=(e,), daemon=True)
            self._threads.append(th)
            th.start()

    def _pump(self, src: Endpoint) -> None:
        while self._running:
            frame = src.recv()
            if frame is None:
                continue
            self.stats[src.name] += 1
            if self.framelog is not None:
                self.framelog.log(frame)
            for dst in self.endpoints:
                if dst is not src:
                    dst.send(frame)

    def stop(self) -> None:
        """Stop the pumps and close what :meth:`start` opened; safe after a
        partial start: it joins only the threads that run and closes only
        the endpoints that were opened."""
        self._running = False
        for th in self._threads:
            if th.is_alive():
                th.join(timeout=1.0)
        for e in self._opened:
            e.close()
        self._opened = []
        if self.framelog is not None:
            self.framelog.close()


def parse_conf(text: str) -> List[Endpoint]:
    """Parse the mavlink-router conf dialect the reference ships:
    ``[UdpEndpoint Name]`` sections (``Mode``/``Address``/``Port``,
    ``scripts/router_sitl.conf:13-19``) -> :class:`Endpoint`, and
    ``[UartEndpoint Name]`` sections (``Device``/``Baud`` — the real-hexa
    wire, ``scripts/router_hexa.conf:2-4``) -> :class:`SerialEndpoint`;
    both take ``AllowMsgIdIn``/``AllowMsgIdOut``. The ``[General]``
    section is read by :func:`parse_general`."""
    endpoints: List[Endpoint] = []
    cur: Optional[dict] = None

    def flush():
        nonlocal cur
        if cur is not None:
            if cur.get("kind") == "uart":
                endpoints.append(SerialEndpoint(
                    name=cur["name"],
                    device=cur.get("device", ""),
                    baud=int(cur.get("baud", 57600)),
                    allow_in=cur.get("allow_in"),
                    allow_out=cur.get("allow_out"),
                ))
            else:
                endpoints.append(Endpoint(
                    name=cur["name"],
                    address=cur.get("address", "127.0.0.1"),
                    port=int(cur.get("port", 0)),
                    mode=cur.get("mode", "Normal"),
                    allow_in=cur.get("allow_in"),
                    allow_out=cur.get("allow_out"),
                ))
        cur = None

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            flush()
            section = line.strip("[]").split()
            if section[0] == "UdpEndpoint":
                cur = {"name": section[1] if len(section) > 1 else "ep"}
            elif section[0] == "UartEndpoint":
                cur = {"name": section[1] if len(section) > 1 else "uart",
                       "kind": "uart"}
            else:
                cur = None
            continue
        if cur is None or "=" not in line:
            continue
        key, val = (t.strip() for t in line.split("=", 1))
        k = key.lower()
        if k == "mode":
            cur["mode"] = val.capitalize()
        elif k == "address":
            cur["address"] = val
        elif k == "port":
            cur["port"] = val
        elif k == "device":
            cur["device"] = val
        elif k == "baud":
            # mavlink-routerd accepts "baud" or "baud:flow-control" style
            # lists; first numeric token wins here (no flow control).
            cur["baud"] = val.replace(",", " ").split()[0]
        elif k == "allowmsgidin":
            cur.setdefault("allow_in", set()).update(
                int(v) for v in val.replace(",", " ").split()
            )
        elif k == "allowmsgidout":
            cur.setdefault("allow_out", set()).update(
                int(v) for v in val.replace(",", " ").split()
            )
    flush()
    return endpoints


def parse_general(text: str) -> GeneralConf:
    """Parse the ``[General]`` section's flight-logging directives
    (``Log``, ``LogMode`` — reference ``scripts/router_sitl.conf:20-28``;
    the daemon's other keys are read and ignored)."""
    g = GeneralConf()
    in_general = False
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            in_general = line.strip("[]").split()[0] == "General"
            continue
        if not in_general or "=" not in line:
            continue
        key, val = (t.strip() for t in line.split("=", 1))
        k = key.lower()
        if k == "log" and val:
            g.log_dir = val
        elif k == "logmode" and val:
            mode = val.lower()
            if mode not in ("always", "while-armed"):
                raise ValueError(
                    f"LogMode {val!r}: use always or while-armed")
            g.log_mode = mode
    return g


def native_router_supports(endpoints: List, general: Optional[GeneralConf] = None) -> bool:
    """Whether ``csrc/libmpc_native.so`` is built with the router core and
    with what this topology asks of it: flight logging (``router_set_log``)
    when ``general`` names a log directory, UART endpoints
    (``router_add_uart``) when there are any. A library built before either
    existed still serves a topology that needs neither (the original's
    ``launch.py:172-185``)."""
    from sde4mbrl_px4_tpu_torch.io.mavlink import load_native

    lib = load_native()
    if lib is None or not hasattr(lib, "router_new"):
        return False
    if general is not None and general.log_dir and not hasattr(lib, "router_set_log"):
        return False
    return (not any(isinstance(e, SerialEndpoint) for e in endpoints)
            or hasattr(lib, "router_add_uart"))


class NativeRouter:
    """C++ router core (csrc/router.cpp) behind the same interface as
    :class:`Router` — the actual ``mavlink-routerd``-equivalent for
    deployment (poll(2) loop, no GIL on the forwarding path). The Python
    :class:`Router` is the behavioral twin; both are parity-tested against
    the same topology (tests/test_torch_router.py)."""

    def __init__(self, endpoints: List[Endpoint],
                 log_dir: Optional[str] = None,
                 log_mode: str = "while-armed"):
        import ctypes

        from sde4mbrl_px4_tpu_torch.io.mavlink import load_native

        lib = load_native()
        if lib is None or not hasattr(lib, "router_new"):
            # A library built before csrc/router.cpp existed loads fine but
            # lacks the router symbols — tell the user to rebuild instead
            # of dying on dlsym later.
            raise RuntimeError(
                "native router not available: rebuild with `make -C csrc`")
        lib.router_new.restype = ctypes.c_void_p
        lib.router_add_udp.restype = ctypes.c_int
        lib.router_add_udp.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        has_uart = hasattr(lib, "router_add_uart")
        if has_uart:
            lib.router_add_uart.restype = ctypes.c_int
            lib.router_add_uart.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
        lib.router_start.restype = ctypes.c_int
        lib.router_start.argtypes = [ctypes.c_void_p]
        lib.router_rx_frames.restype = ctypes.c_long
        lib.router_rx_frames.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.router_bound_port.restype = ctypes.c_int
        lib.router_bound_port.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.router_stop_free.argtypes = [ctypes.c_void_p]
        has_log = hasattr(lib, "router_set_log")
        if has_log:
            lib.router_set_log.restype = ctypes.c_int
            lib.router_set_log.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.router_frames_logged.restype = ctypes.c_long
            lib.router_frames_logged.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = ctypes.c_void_p(lib.router_new())
        self.endpoints = endpoints
        self._idx: Dict[str, int] = {}
        self.log_path: Optional[str] = None
        if log_dir:
            if not has_log:
                lib.router_stop_free(self._h)
                raise RuntimeError(
                    "native router lacks flight logging: rebuild with "
                    "`make -C csrc`")
            if log_mode not in ("always", "while-armed"):
                lib.router_stop_free(self._h)
                raise ValueError(
                    f"LogMode {log_mode!r}: use always or while-armed")
            self.log_path = next_log_path(log_dir)
            if lib.router_set_log(
                    self._h, self.log_path.encode(),
                    1 if log_mode == "always" else 2) != 0:
                lib.router_stop_free(self._h)
                raise OSError(f"cannot open flight log {self.log_path}")

        def _ids(s: Optional[Set[int]]):
            if s is None:
                return None
            arr = (ctypes.c_int * (len(s) + 1))(*sorted(s), -1)
            return arr

        for e in endpoints:
            if isinstance(e, SerialEndpoint):
                if not has_uart:
                    lib.router_stop_free(self._h)
                    raise RuntimeError(
                        "native router lacks UART endpoints: rebuild with "
                        "`make -C csrc`")
                rc = lib.router_add_uart(
                    self._h, e.name.encode(), e.device.encode(),
                    int(e.baud), _ids(e.allow_in), _ids(e.allow_out))
                if rc < 0:
                    lib.router_stop_free(self._h)
                    raise OSError(f"endpoint {e.name}: cannot open serial "
                                  f"device {e.device}")
            else:
                rc = lib.router_add_udp(
                    self._h, e.name.encode(), e.address.encode(), int(e.port),
                    1 if e.mode == "Server" else 0, _ids(e.allow_in),
                    _ids(e.allow_out))
                if rc < 0:
                    lib.router_stop_free(self._h)
                    raise OSError(f"endpoint {e.name}: bind/socket failed")
            self._idx[e.name] = rc
        self._started = False

    def start(self) -> None:
        if self._lib.router_start(self._h) != 0:
            raise OSError("router thread start failed")
        self._started = True

    @property
    def stats(self) -> Dict[str, int]:
        if self._h is None:  # after stop(): handle freed, don't pass NULL
            return {name: -1 for name in self._idx}
        return {name: int(self._lib.router_rx_frames(self._h, i))
                for name, i in self._idx.items()}

    def bound_port(self, name: str) -> int:
        if self._h is None:
            raise RuntimeError("router stopped")
        return int(self._lib.router_bound_port(self._h, self._idx[name]))

    @property
    def frames_logged(self) -> int:
        if self._h is None or self.log_path is None:
            return 0
        return int(self._lib.router_frames_logged(self._h))

    def stop(self) -> None:
        if self._h:
            self._lib.router_stop_free(self._h)
            self._h = None
