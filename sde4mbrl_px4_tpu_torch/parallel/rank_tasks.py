"""The rank programs of the mesh layer, one function per route (L6).

Each function runs on every rank of a process group that
``parallel/distributed.py::spawn_ranks`` formed (or any group that exists;
without one it is the (1, 1) mesh of this process), builds the mesh over
the group (``devices``: None the card, ``cuda:(rank % device_count)``;
``"cpu"`` the CPU), drives one route through its user entry point with the
mesh, and returns what the caller compares: the gathered rows (every rank
holds the same), the rank's kernel launches over the route (the counts set
to 0 just before it) and its times. The tests, ``chip_smoke.py`` phase 29
and ``sim/bench_scaling.py`` call them by name::

    spawn_ranks("sde4mbrl_px4_tpu_torch.parallel.rank_tasks:dp_solve", 2,
                dict(cfg=cfg, B=8, devices="cpu"))

A route's draws come from a generator seeded alike on every rank, so a
scenario's draws are those of the one-process run of the same seed.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.parallel.distributed import (
    gather_to_host, global_batch_inputs, global_mesh, is_multiprocess, ordered_sum)

__all__ = ["dp_solve", "fleet", "labels", "particle_solve", "scaling", "suite", "train", "tune"]


def _mesh(shape: Optional[Sequence[int]], devices):
    return global_mesh(None if shape is None else tuple(shape), devices=devices)


def launches() -> Dict[str, int]:
    from sde4mbrl_px4_tpu_torch.launch import kernel_launches

    return kernel_launches()


def zero_launches() -> None:
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    for fn in (AK.apg_solve_kernel, CO.value_batch_kernel, CO.value_and_grad_kernel,
               CO.trajectory_kernel):
        fn.launches = 0
    for fn in (CO.value_batch_kernel, CO.value_and_grad_kernel):
        fn.launches_moments = fn.launches_global = 0


def global_launches() -> Dict[str, int]:
    """The launches of the oracle's particle global-weight forms (trunks past
    the shared-memory forms), counted in ``launches()`` too."""
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    return {"value_batch": CO.value_batch_kernel.launches_global,
            "value_and_grad": CO.value_and_grad_kernel.launches_global}


def moments_launches() -> Dict[str, int]:
    """The launches of the oracle's shared-moments forms (the risk of a
    particle-sharded solve), counted in ``launches()`` too."""
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    return {"value_batch": CO.value_batch_kernel.launches_moments,
            "value_and_grad": CO.value_and_grad_kernel.launches_moments}


class _Timer:
    """Wall ms of a span, and its device ms on a CUDA device (events on the
    current stream; synchronised at the end)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            self.device_ms = self.ev[0].elapsed_time(self.ev[1])
        else:
            self.device_ms = None
        self.wall_ms = 1e3 * (time.perf_counter() - self.t0)
        return False


def dp_solve(cfg: Dict[str, Any], B: int, seed: int = 0, spread: float = 0.5,
             steps: int = 2, shape=None, devices=None) -> Dict[str, Any]:
    """``make_batched_mpc(cfg, mesh)`` over ``global_batch_inputs(mesh, B,
    seed, spread)``, each rank its B/dp rows: a reset and ``steps`` solves
    holding ``xs`` (the first cold, the others warm). Returns each step's
    gathered ``u_opt`` (B, H, n_u) and ``num_steps``, the last ``x_evol``,
    the rank's launches, its wall and device ms per step and the ms of one
    gather of the plans (after a barrier)."""
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc

    mesh = _mesh(shape, devices)
    reset_b, mpc_b, _ = make_batched_mpc(cfg, mesh)
    xs, gen, ts = global_batch_inputs(mesh, B, seed=seed, spread=spread)
    st = reset_b(xs, gen, xs)
    zero_launches()
    sols, wall, dev_ms = [], [], []
    for _ in range(steps):
        with _Timer(mesh.device) as t:
            sol = mpc_b(xs, gen, st, ts, xs)
        st = sol.opt_state
        sols.append(sol)
        wall.append(t.wall_ms)
        dev_ms.append(t.device_ms)
    n = launches()
    if is_multiprocess():
        import torch.distributed as dist

        dist.barrier()                 # the gather's time, not a wait for a slower rank
    t0 = time.perf_counter()
    u = gather_to_host(sols[-1].u_opt, mesh)
    gather_ms = 1e3 * (time.perf_counter() - t0)
    return {"u": [gather_to_host(s.u_opt, mesh) for s in sols[:-1]] + [u],
            "num_steps": [gather_to_host(s.opt_state.num_steps, mesh) for s in sols],
            "x_evol": gather_to_host(sols[-1].x_evol, mesh), "launches": n,
            "wall_ms": wall, "device_ms": dev_ms, "gather_ms": gather_ms,
            "rank": mesh.rank, "rows": int(xs.shape[0]), "device": str(mesh.device)}


def fleet_inputs(B: int, seed: int = 7):
    """The fleet check's states and ENU targets (the JAX package's
    ``tests/_fleet_dist_worker.py``): hover states, targets moved by
    ``np.random.RandomState(seed).uniform(-1, 1)`` in NED x and y."""
    from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import hover_state

    rs = np.random.RandomState(seed)
    states = np.tile(hover_state().numpy(), (B, 1)).astype(np.float32)
    targets = states.copy()
    targets[:, 0:2] += rs.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
    return states, ned2enu(torch.from_numpy(targets)).numpy()


def fleet(cfg: Dict[str, Any], B: int, ticks: int = 4, shape=None,
          devices=None) -> Dict[str, Any]:
    """A ``FleetEngine(cfg, mesh, batch=B, pipeline=False)`` tick loop on
    :func:`fleet_inputs`, each rank stepping its rows with the plans'
    ``x_evol[:, 1]``; returns the gathered states after ``ticks`` ticks,
    the launches and the ticks' wall ms."""
    from sde4mbrl_px4_tpu_torch.parallel.fleet import FleetEngine

    mesh = _mesh(shape, devices)
    eng = FleetEngine(cfg, mesh, batch=B, seed=0, pipeline=False)
    states, targets = fleet_inputs(B)
    rows = mesh.rows(B)
    x, tgt = states[rows], targets[rows]
    zero_launches()
    wall = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        u, x_evol, _ = eng.step(x, tgt)
        wall.append(1e3 * (time.perf_counter() - t0))
        assert u.shape == (eng.B, eng.n_u), u.shape
        x = np.asarray(x_evol[:, 1, :])
    return {"states": gather_to_host(x, mesh), "launches": launches(), "wall_ms": wall,
            "rows": eng.B}


def particle_solve(cfg: Dict[str, Any], seed: int = 3, solves: int = 1,
                   iter_budget: Optional[int] = None, shape=(1, 2), devices=None,
                   draws: Optional[list] = None) -> Dict[str, Any]:
    """``make_particle_sharded_mpc(cfg, mesh)``: ``solves`` chained solves
    from hover with x moved by 0.4 m (the JAX package's
    ``tests/test_sharding.py:81-104``), drawn from ``torch.Generator().
    manual_seed(seed)`` on every rank, or from ``draws``, each solve's
    whole (P, H, 13) block (numpy; or a tuple of the loader's forms).
    Returns the last solve's plan, cost, iterations and ``x_evol``, every
    solve's plan, wall ms and iterations, their ``SolveTimer`` statistics
    (p50/p99), the host seconds in the collectives, and the launches (of
    them the shared-moments and the global-weight forms' apart)."""
    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine.profiling import SolveTimer
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_particle_sharded_mpc

    mesh = _mesh(shape, devices)
    reset_fn, mpc_fn, _ = make_particle_sharded_mpc(cfg, mesh)
    x0 = hover_state(mesh.device)
    x0[0] = 0.4
    gen = torch.Generator().manual_seed(seed)
    if draws is not None:
        one = lambda d: (tuple(None if a is None else torch.as_tensor(a) for a in d)
                         if isinstance(d, tuple) else torch.as_tensor(d))
        gen = iter([one(d) for d in draws])
    st = reset_fn(x0, gen, x0)
    zero_launches()
    ordered_sum.seconds, ordered_sum.calls = 0.0, 0
    wall, iters, plans = [], [], []
    timer = SolveTimer()
    for _ in range(solves):
        with _Timer(mesh.device) as t, timer:
            sol = mpc_fn(x0, gen, st, 0.0, x0, iter_budget)
            iters.append(float(sol.opt_state.num_steps))
        st = sol.opt_state
        wall.append(t.wall_ms)
        plans.append(sol.u_opt.cpu().numpy())
    return {"u": plans[-1], "plans": plans, "opt_cost": float(sol.opt_state.opt_cost),
            "num_steps": float(sol.opt_state.num_steps), "x_evol": sol.x_evol.cpu().numpy(),
            "wall_ms": wall, "iterations": iters, "solve_stats": timer.stats(),
            "collective_s": ordered_sum.seconds, "collective_calls": ordered_sum.calls,
            "launches": launches(), "moments_launches": moments_launches(),
            "global_launches": global_launches(), "mc_index": mesh.mc_index}


def train(params: Dict[str, Any], t: np.ndarray, x: np.ndarray, u: np.ndarray,
          train_cfg: Dict[str, Any], shape=None, devices=None) -> Dict[str, Any]:
    """Data-parallel ``train_sde(..., mesh=mesh)`` of the iris model from
    the numpy tree ``params`` on the logged arrays; returns the fitted tree
    (numpy), the final loss and the wall seconds."""
    from sde4mbrl_px4_tpu_torch.learning.trainer import TrainConfig, TrajectoryDataset, train_sde
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config

    mesh = _mesh(shape, devices)
    cfg = TrainConfig(**train_cfg)
    model = NeuralSDE.for_vehicle(iris_config(), mesh.device)
    t0 = time.perf_counter()
    fitted, metrics = train_sde(model, params, TrajectoryDataset(t, x, u, cfg.window), cfg,
                                mesh=mesh, log=lambda *a: None)
    to_np = lambda tree: ({k: to_np(v) for k, v in tree.items()} if isinstance(tree, dict)
                          else tree.cpu().numpy())
    return {"params": to_np(fitted), "final_loss": metrics["final_loss"],
            "wall_s": time.perf_counter() - t0}


def labels(cfg: Dict[str, Any], xs, ts, xdes, u_prevs=None, expert_max_iter: int = 300,
           shape=None, devices=None) -> Dict[str, Any]:
    """``label_states(cfg, xs, ts, xdes, mesh=mesh)`` with the expert at
    ``expert_max_iter``; returns the labels (n, H, n_u), the launches and
    the wall ms."""
    from sde4mbrl_px4_tpu_torch.learning.distill import DistillConfig, label_states

    mesh = _mesh(shape, devices)
    zero_launches()
    with _Timer(mesh.device) as t:
        lab = label_states(cfg, xs, ts, xdes, None,
                           DistillConfig(expert_max_iter=expert_max_iter), mesh=mesh,
                           u_prevs=u_prevs)
    return {"labels": lab.cpu().numpy(), "launches": launches(), "wall_ms": t.wall_ms}


def tune(kind: str, cfg: Dict[str, Any], grid: np.ndarray, steps: int = 40, seed: int = 0,
         crn: bool = True, shape=None, devices=None) -> Dict[str, Any]:
    """``tune_mppi`` (``kind`` "mppi") or ``tune_cost_weights`` ("weights")
    with ``mesh``; returns the sorted results, the launches and the wall
    ms."""
    from sde4mbrl_px4_tpu_torch.tuning.tuner import tune_cost_weights, tune_mppi

    mesh = _mesh(shape, devices)
    fn = tune_mppi if kind == "mppi" else tune_cost_weights
    zero_launches()
    t0 = time.perf_counter()
    results = fn(cfg, grid, steps=steps, seed=seed, crn=crn, mesh=mesh)
    return {"results": results, "launches": launches(),
            "wall_ms": 1e3 * (time.perf_counter() - t0)}


def scaling(cfg: Dict[str, Any], b_per_rank: int, steps: int, devices=None,
            spawned: Optional[float] = None) -> Dict[str, Any]:
    """One rank of ``sim/bench_scaling.py``'s process sweep: ``b_per_rank``
    scenarios on this rank's rows of a batch over every rank (or alone,
    without a group), one warm-up solve, then ``steps`` timed solves (in a
    group, all ranks start them together, after a barrier).
    Returns the rank's solves/s, its ms per step, its iterations per solve
    and the seconds from ``spawned`` (the parent's wall clock) to a ready
    mesh."""
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc

    mesh = _mesh(None, devices)
    ready_s = None if spawned is None else time.time() - spawned
    reset_b, mpc_b, _ = make_batched_mpc(cfg, mesh)
    B = b_per_rank * mesh.dp
    xs, gen, ts = global_batch_inputs(mesh, B, seed=7, spread=0.5)
    st = reset_b(xs, gen, xs)
    sol = mpc_b(xs, gen, st, ts, xs)
    if is_multiprocess():
        import torch.distributed as dist

        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()                 # the ranks' timed steps overlap
    with _Timer(mesh.device) as t:
        for _ in range(steps):
            sol = mpc_b(xs, gen, sol.opt_state, ts, xs)
        its = float(sol.opt_state.num_steps.mean())
    dt = t.wall_ms / 1e3 / steps
    return {"rank": mesh.rank, "world": mesh.size, "rows": int(xs.shape[0]),
            "solves_per_sec": int(xs.shape[0]) / dt, "ms_per_step": 1e3 * dt,
            "device_ms_per_step": None if t.device_ms is None else t.device_ms / steps,
            "steps_per_solve": its, "ready_s": ready_s}


def suite(routes: Sequence) -> list:
    """Several of the programs above, one after the other in the same
    world (one spawn instead of one each): ``routes`` is a list of ``(name,
    kwargs)``; returns their results in order."""
    return [globals()[name](**kw) for name, kw in routes]
