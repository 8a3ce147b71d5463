"""Shared-memory mailbox with doorbell (L7).

Copied from ``sde4mbrl_px4_tpu/io/mailbox.py`` (numpy, ctypes): the port
may not import the JAX package, whose ``__init__`` imports JAX. The native
POSIX segment is the repo's root ``csrc/shm_mailbox.cpp``, built into
``csrc/libmpc_native.so`` by ``make -C csrc``; where that library is not
built, :class:`Mailbox` runs the pure-Python fallback the original's
docstring names (a lock per direction and one condition for the doorbell,
the reference's own mechanism, ``sde_control.py:616-663``). The fallback
is one object in one process: attaching to it by name (``owner=False``)
needs the native segment.

Protocol (single producer / single consumer per direction, as in the
reference):

- ingress side calls :meth:`post_inbox` (state snapshot) which rings the
  doorbell (reference ``_mpc_event.set()``, ``sde_control.py:270``);
- solver side blocks in :meth:`wait_bell`, then :meth:`read_inbox`,
  solves, and :meth:`post_outbox` (the finished plan);
- ingress side :meth:`read_outbox` never blocks — it picks up the latest
  finished plan (reference ``sde_control.py:274-280``).
"""
from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np

__all__ = ["Mailbox", "native_available"]


def _lib() -> Optional[ctypes.CDLL]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    so = os.path.join(here, "csrc", "libmpc_native.so")
    if not os.path.exists(so):
        return None
    lib = ctypes.CDLL(so)
    lib.mbx_open.restype = ctypes.c_void_p
    lib.mbx_read_inbox.restype = ctypes.c_uint64
    lib.mbx_read_outbox.restype = ctypes.c_uint64
    lib.mbx_inbox_seq.restype = ctypes.c_uint64
    lib.mbx_outbox_seq.restype = ctypes.c_uint64
    lib.mbx_wait_bell.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    return _lib() is not None


class _PySegment:
    """The fallback's segment: the native header's fields, in Python."""

    def __init__(self, inbox_len: int, outbox_len: int):
        self.inbox = np.zeros(inbox_len, np.float64)
        self.outbox = np.zeros(outbox_len, np.float64)
        self.inbox_seq = 0
        self.outbox_seq = 0
        self.in_lock = threading.Lock()
        self.out_lock = threading.Lock()
        self.bell = threading.Condition()
        self.bell_pending = False
        self.shutdown = False


class Mailbox:
    """Named mailbox: float64 inbox + float64 outbox.

    float64 because the payload carries microsecond timestamps (the
    reference keeps these in float64 shm arrays too — ``info_mpc_pre`` at
    ``sde_control.py:638``).

    ``owner=True`` creates/unlinks the segment; attach with the same name
    and sizes from another process (native segment only). ``native`` None
    takes the native segment where ``csrc/libmpc_native.so`` is built and
    the Python fallback where it is not; True or False asks for one of
    them (True raises without the library). :attr:`kind` says which one
    runs.
    """

    def __init__(self, name: str, inbox_len: int, outbox_len: int, owner: bool,
                 native: Optional[bool] = None):
        self.name = name if name.startswith("/") else "/" + name
        self.inbox_len = inbox_len
        self.outbox_len = outbox_len
        self.owner = owner
        self.lib = _lib() if native in (None, True) else None
        if native and self.lib is None:
            raise RuntimeError(
                "native mailbox requires csrc/libmpc_native.so (make -C csrc)")
        self.kind = "native" if self.lib is not None else "python"
        self.base = None
        self._seg: Optional[_PySegment] = None
        if self.lib is not None:
            self.base = self.lib.mbx_open(
                self.name.encode(), inbox_len * 8, outbox_len * 8, int(owner))
            if not self.base:
                raise OSError(f"mbx_open failed for {self.name}")
        elif owner:
            self._seg = _PySegment(inbox_len, outbox_len)
        else:
            raise OSError(f"attaching to {self.name} needs the native mailbox "
                          "(csrc/libmpc_native.so, make -C csrc)")
        self._in_buf = np.zeros(inbox_len, np.float64)
        self._out_buf = np.zeros(outbox_len, np.float64)

    # -- producer side ------------------------------------------------------

    def post_inbox(self, values: np.ndarray) -> None:
        v = np.ascontiguousarray(values, np.float64)
        if self._seg is None:
            self.lib.mbx_post_inbox(
                ctypes.c_void_p(self.base),
                v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                v.nbytes,
            )
            return
        s = self._seg
        with s.in_lock:
            n = min(v.shape[0], s.inbox.shape[0])   # the native memcpy's bound
            s.inbox[:n] = v[:n]
            s.inbox_seq += 1
        with s.bell:
            s.bell_pending = True
            s.bell.notify()

    def read_outbox(self) -> Tuple[np.ndarray, int]:
        if self._seg is None:
            seq = self.lib.mbx_read_outbox(
                ctypes.c_void_p(self.base),
                self._out_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._out_buf.nbytes,
            )
            return self._out_buf.copy(), int(seq)
        s = self._seg
        with s.out_lock:
            return s.outbox.copy(), s.outbox_seq

    # -- solver side --------------------------------------------------------

    def wait_bell(self, timeout_ms: int = -1) -> int:
        """1 = rung, 0 = timeout, -1 = shutdown."""
        if self._seg is None:
            return self.lib.mbx_wait_bell(ctypes.c_void_p(self.base), timeout_ms)
        s = self._seg
        deadline = None if timeout_ms < 0 else time.monotonic() + timeout_ms / 1e3
        with s.bell:
            while not s.bell_pending and not s.shutdown:
                if deadline is None:
                    s.bell.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not s.bell.wait(remaining):
                    if not s.bell_pending and not s.shutdown:
                        return 0
            rc = -1 if s.shutdown else 1
            s.bell_pending = False
            return rc

    def read_inbox(self) -> Tuple[np.ndarray, int]:
        if self._seg is None:
            seq = self.lib.mbx_read_inbox(
                ctypes.c_void_p(self.base),
                self._in_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._in_buf.nbytes,
            )
            return self._in_buf.copy(), int(seq)
        s = self._seg
        with s.in_lock:
            return s.inbox.copy(), s.inbox_seq

    def post_outbox(self, values: np.ndarray) -> None:
        v = np.ascontiguousarray(values, np.float64)
        if self._seg is None:
            self.lib.mbx_post_outbox(
                ctypes.c_void_p(self.base),
                v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                v.nbytes,
            )
            return
        s = self._seg
        with s.out_lock:
            n = min(v.shape[0], s.outbox.shape[0])
            s.outbox[:n] = v[:n]
            s.outbox_seq += 1

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> None:
        if self._seg is None:
            self.lib.mbx_shutdown(ctypes.c_void_p(self.base))
            return
        with self._seg.bell:
            self._seg.shutdown = True
            self._seg.bell.notify_all()

    def close(self) -> None:
        if self.base:
            self.lib.mbx_close(
                ctypes.c_void_p(self.base), self.name.encode(), int(self.owner)
            )
            self.base = None
