"""Router forwarding throughput: the native C++ core against the Python twin.

PyTorch-port counterpart of ``tools/bench_router.py``, over the port's
router (``io/router.py``) and codec (``io/mavlink.py``). It sends
MPC_FULL_STATE frames at the FCU (server) endpoint from one producer on
loopback UDP and counts how many arrive at a filtered sink (``AllowMsgIdOut
367``) per second: the transport layer's hot path (the reference runs
mavlink-routerd's forwarding loop there). The window ends at the last
forwarded frame, not after the drain's silence, so a fast implementation's
rate is not deflated by the fixed timeout.

    python -m sde4mbrl_px4_tpu_torch.sim.bench_router [--frames 20000]

Host code: no torch, no card.
"""
from __future__ import annotations

import argparse
import socket
import sys
import time
from typing import Optional

import numpy as np

from sde4mbrl_px4_tpu_torch.io import mavlink as mav
from sde4mbrl_px4_tpu_torch.io.router import Endpoint, NativeRouter, Router

__all__ = ["forward_rate", "run", "main"]


def forward_rate(impl, n_frames: int) -> dict:
    """Frames forwarded through ``impl`` (``Router`` or ``NativeRouter``)
    to a filtered sink, and the rate over the window they took."""
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    sink.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    eps = [Endpoint("fcu", "127.0.0.1", 0, mode="Server"),
           Endpoint("mpc", "127.0.0.1", sink.getsockname()[1],
                    allow_out={mav.MSG_ID_MPC_FULL_STATE},
                    allow_in={mav.MSG_ID_MPC_MOTORS_CMD})]
    r = impl(eps)
    r.start()
    src = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    src.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
    try:
        fcu_port = r.bound_port("fcu") if impl is NativeRouter else eps[0].bound_port
        frame = bytes(mav.encode_full_state(1, np.zeros(13, np.float32)))
        got = 0
        t0 = t_last = time.perf_counter()
        sink.setblocking(False)
        for k in range(n_frames):
            src.sendto(frame, ("127.0.0.1", fcu_port))
            if k % 64 == 0:            # drain as we go: the sink buffer never fills
                try:
                    while True:
                        sink.recvfrom(512)
                        got += 1
                        t_last = time.perf_counter()
                except BlockingIOError:
                    pass
        sink.settimeout(0.25)
        try:
            while True:
                sink.recvfrom(512)
                got += 1
                t_last = time.perf_counter()
        except socket.timeout:
            pass
    finally:
        r.stop()
        src.close()
        sink.close()
    dt = max(t_last - t0, 1e-9)
    res = {"frames": n_frames, "forwarded": got, "seconds": dt, "frames_per_s": got / dt,
           "loss": (n_frames - got) / n_frames}
    print(f"{impl.__name__:13s} {got}/{n_frames} frames forwarded in {dt:.3f}s = "
          f"{res['frames_per_s']:,.0f} frames/s (loss {res['loss']:.1%})", flush=True)
    return res


def run(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.bench_router",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20000)
    args = ap.parse_args(argv)
    py = forward_rate(Router, args.frames)
    nat = forward_rate(NativeRouter, args.frames)
    ratio = nat["frames_per_s"] / py["frames_per_s"]
    print(f"native/python speedup: {ratio:.2f}x", flush=True)
    return {"python": py, "native": nat, "native_over_python": ratio}


def main(argv: Optional[list] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
