"""Fleet serving engine (L6): many vehicles on one card or a mesh of ranks.

PyTorch counterpart of ``sde4mbrl_px4_tpu/parallel/fleet.py::FleetEngine``
(``:36-161``): B vehicles' receding-horizon solves run as one batched solve
per control tick (``parallel/batched.py``, any solver family: one launch of
the whole-solve kernel over a grid of B scenarios for linesearch APG and the
policy hybrid; MPPI, fixed-step APG and the pure policy on the cost oracle,
one launch per evaluation over the B scenarios), with the warm starts (and
the policy's cold flags, ``num_steps``) on the card from tick to tick, and
plans pipelined as in the single-vehicle engine (``engine/controller.py``):
``step`` dispatches tick k and returns the plans of tick k-1.

How tick k's plans reach the host without a device-wide sync: the
dispatch copies the state, target and time rows into pinned host buffers
and on to the card with ``non_blocking``; after the solve's launches it
copies ``u_opt`` and ``x_evol`` into pinned host buffers with
``non_blocking`` and records a CUDA event (one recorded before the input
copies gives the tick's device time, ``device_ms``). Tick k+1 waits on that
event only (``Event.synchronize``), after it has dispatched its own solve,
so the collect of tick k overlaps the solve of tick k+1. Both buffer sets
are double-buffered by tick parity: a buffer is written again only two
ticks later, after the event that covers its last copy was waited on.
Nothing at dispatch reads the device or copies from pageable memory (either
would wait for the tick in flight): MPPI's per-tick draws go to the card
from pinned memory (``solver/mppi.py::draw_mppi_noise``), and the policy's
cold-start select is a device-side ``where``. The one exception is a
config without ``apg_mpc.linesearch``: the fixed-step loop reads one scalar
per iteration (whether a scenario still runs), so its dispatch waits.

Configs with particles and the particle options (``risk_lambda``,
``initial_state_std``, MPPI over K x P paths) serve as any other: each
tick draws its Brownian block and starts from the engine's generator.

Over a mesh of ranks (``parallel/mesh.py``; the original's multi-process
branch, ``:64-90``, ``:144-156``): each rank serves its rows of the fleet,
``batch / dp`` vehicles (``mesh.rows``), passing and receiving only those
rows, on its own device; a tick needs no collective. The vehicles' draws
are their rows of the whole fleet's (``build_mpc``'s ``shard``), so a
vehicle flies the same on every mesh.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc
from sde4mbrl_px4_tpu_torch.parallel.mesh import Mesh

__all__ = ["FleetEngine"]


class FleetEngine:
    """Batched receding-horizon serving of ``batch`` vehicles on one device,
    or of this rank's ``batch / dp`` of them over a ``mesh`` (``B`` is the
    rows this process serves; ``batch`` must divide over dp, as the
    original's ``:47-50`` asks).

    ``step(states, targets, curr_ts)`` solves its B scenarios and returns
    the PREVIOUS tick's plans (pipelined; the first tick returns its own,
    with age 0). Inputs are host numpy: ``states`` in the solver's NED frame,
    ``targets`` in the config's ``convert_to_enu`` convention, as for the
    single-vehicle ``mpc_fn``. ``device=None`` is the card; ``"cpu"`` runs
    the plain solves (blocking: there is nothing to overlap).
    """

    def __init__(self, cfg: Dict[str, Any], mesh: Optional[Mesh] = None,
                 batch: Optional[int] = None, seed: int = 0,
                 convert_to_enu: bool = True, pipeline: bool = True,
                 device: Optional[torch.device | str] = None):
        if batch is None or int(batch) < 1:
            raise ValueError(f"a fleet of {batch} vehicles")
        if mesh is not None and int(batch) % mesh.dp:
            raise ValueError(f"batch {batch} must divide over the dp axis ({mesh.dp})")
        self.mesh = mesh
        # the rows this process serves: all of them, or its rows over dp
        self.B = int(batch) // (mesh.dp if mesh is not None else 1)
        self.pipeline = pipeline
        self.reset_b, self.mpc_b, self.bundle = make_batched_mpc(
            dict(cfg), mesh, convert_to_enu=convert_to_enu, device=device)
        self.device = self.bundle.device
        self.H = int(self.bundle.time_steps.shape[0])
        self.n_u = self.bundle.model.n_u
        self.dt = float(self.bundle.time_steps[0])
        self.rngs = torch.Generator().manual_seed(seed)
        cuda = self.device.type == "cuda"
        pinned = lambda *shape: torch.empty(shape, dtype=torch.float32, pin_memory=cuda)
        # per tick parity: the input rows (states, targets, times) and the
        # plans' host copies (u_opt, x_evol)
        self._in = [(pinned(self.B, 13), pinned(self.B, 13), pinned(self.B))
                    for _ in range(2)]
        self._out = [(pinned(self.B, self.H, self.n_u), pinned(self.B, self.H + 1, 13))
                     for _ in range(2)]
        self._tick = 0
        self._opt = None       # the warm starts, on the device
        self._pending = None   # (parity, events, t_dispatch) of the plans not yet returned
        # device ms from a tick's input copies to its plans' host copies, of
        # the newest collected tick (None on the CPU)
        self.device_ms = None

    def reset(self, states: np.ndarray) -> None:
        """(Re)initialise every warm start from the fleet's states."""
        xs = torch.as_tensor(np.asarray(states, np.float32), device=self.device)
        self._opt = self.reset_b(xs, self.rngs, xs)
        self._pending = None

    def _put(self, parity: int, states, targets, curr_ts) -> tuple:
        """The tick's input rows on the device, through its pinned buffers."""
        rows = self._in[parity]
        for buf, a in zip(rows, (states, targets, curr_ts)):
            buf.copy_(torch.from_numpy(np.asarray(a, np.float32).reshape(buf.shape)))
        return tuple(buf.to(self.device, non_blocking=True) for buf in rows)

    def _collect(self, parity: int, events) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a tick's copies (its end event only) and return its
        plans."""
        if events is not None:
            start, done = events
            done.synchronize()
            self.device_ms = start.elapsed_time(done)
        u, x_evol = self._out[parity]
        return u.numpy().copy(), x_evol.numpy().copy()

    def step(self, states: np.ndarray, targets: np.ndarray,
             curr_ts: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray, float]:
        """One fleet control tick.

        Args:
            states: (B, 13) vehicle states (solver frame, NED).
            targets: (B, 13) per-vehicle targets.
            curr_ts: (B,) per-vehicle times on the reference trajectory
                (trajectory configs; zeros otherwise).

        Returns ``(u_now (B, n_u), x_evol (B, H+1, 13), age_s)``: the
        controls to apply now and the predicted trajectories of the newest
        collected plans, and the plans' age. ``u_now`` is the plan row
        matching the age, ``u[min(round(age / dt), H-1)]``, as the
        single-vehicle engine's time-indexed pickup.
        """
        if self._opt is None:
            self.reset(states)
        parity = self._tick % 2
        self._tick += 1
        ts = np.zeros(self.B, np.float32) if curr_ts is None else curr_ts
        cuda = self.device.type == "cuda"
        events = None
        if cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        xs, xdes, ts = self._put(parity, states, targets, ts)
        sol = self.mpc_b(xs, self.rngs, self._opt, ts, xdes)
        self.rngs, self._opt = sol.rng, sol.opt_state
        u_host, x_host = self._out[parity]
        u_host.copy_(sol.u_opt, non_blocking=cuda)
        x_host.copy_(sol.x_evol, non_blocking=cuda)
        if cuda:
            events[1].record()
        now = time.perf_counter()
        if self.pipeline and self._pending is not None:
            prev, prev_events, t_prev = self._pending
            self._pending = (parity, events, now)
            (u, x_evol), age = self._collect(prev, prev_events), now - t_prev
        else:
            self._pending = (parity, events, now) if self.pipeline else None
            (u, x_evol), age = self._collect(parity, events), 0.0
        idx = min(int(round(age / self.dt)), self.H - 1)
        return u[:, idx, :], x_evol, age
