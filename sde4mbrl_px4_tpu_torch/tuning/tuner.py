"""Batched hyper-parameter tuning on the card's scenario axis (L6).

PyTorch counterpart of ``sde4mbrl_px4_tpu/tuning/tuner.py``, with its
names and call signatures. A grid of N candidate controllers flies the
closed loop together, one scenario of a batched solve each
(``engine/mpc_loader.py::build_mpc``, the loader's tuner hooks), where the
original vmaps the closed loop over the candidates (``:184``, ``:351``):

- :func:`tune_mppi` scores (``sigma``, ``temperature``, ``noise_beta``)
  rows of the sampling solver. Each control period is one batched MPPI
  solve: ``iters + 2`` launches of ``value_batch`` over N x K plans and one
  ``trajectory`` over the N plans, whose ``x_evol[:, 1]`` is the next
  state (the plant is the model's mean dynamics, as in the original's
  ``:148-159``).
- :func:`tune_cost_weights` scores (p, v, q, w) scale factors on the
  config's tracking weights with the configured solver: on the linesearch
  APG route one launch of the whole-solve kernel over the N candidates a
  period, each candidate's weights in its own row of the kernel's consts.
  The plant is ``ops/rollout.py::em_step`` over the N states (its rows
  padded to a multiple of 64, :func:`_plant_step`), with one
  (13,) Euler-Maruyama draw a period (``noisy_plant``).

Trajectory configs fly their reference trajectory from its start,
setpoint configs a 1 m position step; the score is the distance of the
next state's position to the reference ``state_from_traj(t + dt)``, the
same for every candidate and computed on the host from the table. Scores
accumulate on the device; the only host read is the (N, ...) result at the
end, as the original's single ``np.asarray``.

**Noise is an input.** ``draws`` is an iterator of each period's draws,
which is how tests hand in the original's: for :func:`tune_mppi` the pair
``(eps, c0)``, each (iters, K, H, nZ) / (iters, K, nZ) shared by the
candidates or with a leading N; for :func:`tune_cost_weights` the plant's
(13,) or (N, 13) draw. Without it the sweep draws every period's noise up
front from ``torch.Generator().manual_seed(seed)`` and moves it to the
device in one copy. ``crn`` (common random numbers, the default) gives
every candidate the same draws: one draw, expanded over N; ``crn=False``
draws each candidate its own. A solver that draws in
:func:`tune_cost_weights` (``solver: mppi``, particles) takes a generator
seeded with ``seed + 1``, per candidate.

The original runs its sweeps on XLA (``use_pallas=False``, ``:90-94``);
here they run on the kernels, and the plain versions on CPU tensors
(``device="cpu"``).

``mesh=`` (``parallel/mesh.py``; the original's ``:172-183``,
``:339-350``) shards the candidates over its dp axis, on the mesh's
device: the grid is padded to a multiple of dp with its first row (as the
original pads), each rank flies its rows as one batched solve a period on
the same per-scenario knobs and weights, and the scores are gathered in
rank order on every rank and cut back to N. Per-candidate draws are each
candidate's draws of the padded grid (the padding rows repeat the first
candidate's), so a candidate's score does not depend on the mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc
from sde4mbrl_px4_tpu_torch.models.trajectory import load_trajectory_csv, make_state_from_traj
from sde4mbrl_px4_tpu_torch.ops.rollout import em_step
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig, draw_mppi_noise

__all__ = ["TuneResult", "WeightTuneResult", "make_mppi_grid",
           "make_weight_grid", "tune_mppi", "tune_cost_weights"]


class TuneResult(NamedTuple):
    """One scored candidate (sorted best-first in ``tune_mppi``'s output)."""

    sigma: float
    temperature: float
    noise_beta: float
    mean_pos_err: float      # mean ||pos - ref|| over the closed loop [m]
    final_pos_err: float     # ||pos - ref|| at the last step [m]

    def yaml_block(self, samples: int, iters: int) -> str:
        """The ``mppi:`` YAML block reproducing this candidate."""
        return (
            "mppi:\n"
            f"  samples: {samples}\n"
            f"  sigma: {self.sigma:.6g}\n"
            f"  temperature: {self.temperature:.6g}\n"
            f"  iters: {iters}\n"
            f"  noise_beta: {self.noise_beta:.6g}\n"
        )


class WeightTuneResult(NamedTuple):
    """One scored cost-weight candidate: scale factors on the config's
    ``perr``/``verr``/``qerr``/``werr`` tracking weights."""

    p_scale: float
    v_scale: float
    q_scale: float
    w_scale: float
    score: float             # mean pos err + effort_weight * control effort
    mean_pos_err: float      # [m] over the closed loop (stochastic plant)
    effort: float            # mean ||u - uref||^2 per step

    def yaml_block(self, base_cost_params: Dict[str, Any]) -> str:
        """The updated ``cost_params:`` tracking-weight lines."""
        def scaled(key, s):
            v = np.atleast_1d(np.asarray(
                base_cost_params.get(key, 0.0), np.float64)) * s
            return "[" + ", ".join(f"{x:.6g}" for x in v) + "]"

        return ("cost_params:\n"
                f"  perr: {scaled('perr', self.p_scale)}\n"
                f"  verr: {scaled('verr', self.v_scale)}\n"
                f"  qerr: {scaled('qerr', self.q_scale)}\n"
                f"  werr: {scaled('werr', self.w_scale)}\n")


def _grid(*axes: Sequence[float]) -> np.ndarray:
    """Cartesian product of the axes, the first varying slowest -> (N,
    len(axes)) float32 rows (the original's ``meshgrid(indexing="ij")``)."""
    g = np.meshgrid(*(np.asarray(a, np.float32) for a in axes), indexing="ij")
    return np.stack([a.reshape(-1) for a in g], axis=-1)


def make_mppi_grid(sigmas: Sequence[float], temperatures: Sequence[float],
                   noise_betas: Sequence[float]) -> np.ndarray:
    """Cartesian product -> (N, 3) float32 candidate rows."""
    return _grid(sigmas, temperatures, noise_betas)


def make_weight_grid(p_scales: Sequence[float], v_scales: Sequence[float],
                     q_scales: Sequence[float], w_scales: Sequence[float]) -> np.ndarray:
    """Cartesian product -> (N, 4) float32 candidate rows."""
    return _grid(p_scales, v_scales, q_scales, w_scales)


def _checked_grid(grid, width: int, what: str) -> np.ndarray:
    grid = np.asarray(grid, np.float32)
    if grid.ndim != 2 or grid.shape[1] != width:
        raise ValueError(f"grid must be (N, {width}) [{what}]; got {grid.shape}")
    return grid


def _padded(grid: np.ndarray, mesh) -> np.ndarray:
    """The grid padded to a multiple of the mesh's dp with its first row
    (the original's ``:172-183``); the grid itself without a mesh."""
    if mesh is None:
        return grid
    pad = (-grid.shape[0]) % mesh.dp
    return np.concatenate([grid, np.repeat(grid[:1], pad, axis=0)]) if pad else grid


def _mine(t: Optional[torch.Tensor], rows: slice, Np: int, lead: int) -> Optional[torch.Tensor]:
    """A draw with a per-candidate axis at ``lead`` (N rows, N <= Np): padded
    to Np with the first candidate's rows and cut to this rank's ``rows``;
    a shared draw (no such axis, fewer dims) as it is."""
    if t is None or rows == slice(None):
        return t
    n = int(t.shape[lead])
    if n < Np:
        first = t.narrow(lead, 0, 1)
        t = torch.cat([t, first.expand(*t.shape[:lead], Np - n, *t.shape[lead + 1:])], lead)
    return t[(slice(None),) * lead + (rows,)]


# the plant's products take a multiple of this many rows, whatever the grid
PLANT_ROWS = 64


def _plant_step(model, params, x: torch.Tensor, u: torch.Tensor, dt: torch.Tensor,
                noise: Optional[torch.Tensor]) -> torch.Tensor:
    """``em_step`` of the candidates' states, its rows padded (with the first
    candidate's) to a multiple of ``PLANT_ROWS``: cuBLAS picks its GEMM by
    shape, and a row's bits with it (on the card 14 rows and 28 differ in
    the last bit), so one shape for every grid of up to ``PLANT_ROWS``
    candidates gives a candidate the same plant in one process and on any
    mesh."""
    n = int(x.shape[0])
    pad = (-n) % PLANT_ROWS
    if pad:
        grow = lambda t: torch.cat([t, t[:1].expand(pad, *t.shape[1:])])
        x, u = grow(x), grow(u)
        noise = None if noise is None else grow(noise)
    return em_step(model, params, x, u, dt, noise)[:n]


def _gathered(out: np.ndarray, mesh, N: int) -> np.ndarray:
    """Every rank's rows of the scores, in rank order, cut back to N."""
    if mesh is None:
        return out
    from sde4mbrl_px4_tpu_torch.parallel.distributed import gather_to_host

    return gather_to_host(out, mesh)[:N]


class _Workload(NamedTuple):
    """The closed loop every candidate flies: start, target, the periods'
    times on the device and the scoring references (steps, 3) in the
    solver frame."""

    x0: torch.Tensor           # (13,) NED
    xdes: torch.Tensor         # (13,) the config's frame
    times: torch.Tensor        # (steps,) float32
    refs: torch.Tensor         # (steps, 3)
    dt: float


def _workload(cfg: Dict[str, Any], bundle, steps: int, convert_to_enu: bool) -> _Workload:
    """The original's ``:122-135`` and scoring references (``:153-158``):
    a trajectory config engages at the trajectory's start and is scored
    against ``state_from_traj(t + dt)``, a setpoint config starts 1 m off
    (NED x) the hover target. Times are float32 as the original's
    ``jnp.float32(t0) + k * dt``; the references are sampled on the host
    from the table and moved to the device in one copy."""
    dev = bundle.device
    dt = float(cfg["_time_steps"][0])
    dt32 = np.float32(dt)
    t = np.float32(0.0) + np.arange(steps, dtype=np.float32) * dt32
    if bundle.state_from_traj is not None:
        x0 = bundle.state_from_traj(0.0)
        x0 = enu2ned(x0) if convert_to_enu else x0
        xdes = x0
        host = make_state_from_traj(load_trajectory_csv(cfg["trajectory_path"],
                                                        convert_to_ned=False))
        refs = host(torch.from_numpy(t + dt32))
        refs = (enu2ned(refs) if convert_to_enu else refs)[:, :3]
    else:
        x0 = hover_state(dev)
        x0[0] = 1.0                                   # a 1 m step (NED)
        xdes = hover_state(dev)
        tgt = enu2ned(hover_state()) if convert_to_enu else hover_state()
        refs = tgt[:3].expand(steps, 3)
    return _Workload(x0=x0.to(dev), xdes=xdes.to(dev), times=torch.from_numpy(t).to(dev),
                     refs=refs.contiguous().to(dev), dt=dt)


def _per_candidate(t: Optional[torch.Tensor], N: int, dims: int,
                   dev: torch.device) -> Optional[torch.Tensor]:
    """A draw on the device with a leading N: one of ``dims`` axes is shared
    by the candidates (expanded, no copy), one of ``dims + 1`` is theirs."""
    if t is None:
        return None
    t = t.to(dev, torch.float32)
    if t.dim() == dims:
        return t.expand(N, *t.shape)
    if t.dim() != dims + 1 or int(t.shape[0]) != N:
        raise ValueError(f"a period's draw must be shared ({dims} axes) or per candidate "
                         f"({N}, ...), got {tuple(t.shape)}")
    return t


def tune_mppi(cfg: Dict[str, Any], grid: np.ndarray, steps: int = 40, seed: int = 0,
              crn: bool = True, mesh=None, convert_to_enu: bool = True,
              device: Optional[torch.device | str] = None,
              draws: Optional[Iterator] = None) -> list:
    """Score every (sigma, temperature, noise_beta) row of ``grid`` by
    closed-loop tracking error; returns ``TuneResult`` rows sorted
    best-first (module docstring). ``cfg``'s ``solver`` is forced to
    ``mppi``; its ``mppi.samples`` and ``iters`` stay as configured.
    ``device=None`` is the card; ``mesh`` the module docstring's."""
    grid = _checked_grid(grid, 3, "sigma, temperature, noise_beta")
    N = int(grid.shape[0])
    padded = _padded(grid, mesh)
    Np = int(padded.shape[0])
    rows = slice(None) if mesh is None else mesh.rows(Np)
    if mesh is not None:
        device = mesh.device
    base = dict(cfg)
    base["solver"] = "mppi"
    static = MPPIConfig.from_config(base)
    cfg_probe, probe, _ = build_mpc(dict(base), convert_to_enu, device)
    dev = probe.device
    hp = torch.from_numpy(padded[rows]).to(dev)
    Nl = int(hp.shape[0])
    knobs = MPPIConfig(samples=static.samples, sigma=hp[:, 0], temperature=hp[:, 1],
                       iters=static.iters, noise_beta=hp[:, 2])
    _, bundle, pieces = build_mpc(dict(base), convert_to_enu, dev, mppi_params=knobs,
                                  state_from_traj=probe.state_from_traj)
    w = _workload(cfg_probe, bundle, steps, convert_to_enu)
    H, nZ = int(bundle.time_steps.shape[0]), int(bundle.lb_z.shape[0])
    if draws is None:
        gen = torch.Generator().manual_seed(int(seed))
        lead = (steps,) if crn else (steps, N)
        # the knobs' values do not enter the draws, only whether c0 is drawn
        eps, c0 = draw_mppi_noise(gen, knobs, H, nZ, dev, batch=lead)
        draws = zip(eps, c0)
    periods = ((_per_candidate(_mine(e, rows, Np, 0) if e is not None and e.dim() == 5 else e,
                               Nl, 4, dev),
                _per_candidate(_mine(c, rows, Np, 0) if c is not None and c.dim() == 4 else c,
                               Nl, 3, dev))
               for e, c in draws)
    N_all, N = N, Nl
    x = w.x0.expand(N, 13)
    xdes = w.xdes.expand(N, 13)
    st = pieces.reset(x, None, xdes)
    errs = []
    with torch.no_grad():
        for k in range(steps):
            sol = pieces.solve(x, periods, st, w.times[k].expand(N), xdes)
            x, st = sol.x_evol[:, 1], sol.opt_state
            errs.append(torch.linalg.norm(x[:, :3] - w.refs[k], dim=-1))
        errs = torch.stack(errs)                                  # (steps, N)
        out = torch.stack([errs.mean(0), errs[-1]], dim=-1).cpu().numpy()
    out, N = _gathered(out, mesh, N_all), N_all
    results = [TuneResult(sigma=float(grid[i, 0]), temperature=float(grid[i, 1]),
                          noise_beta=float(grid[i, 2]), mean_pos_err=float(out[i, 0]),
                          final_pos_err=float(out[i, 1]))
               for i in range(N)]
    results.sort(key=lambda r: r.mean_pos_err)
    return results


def tune_cost_weights(cfg: Dict[str, Any], grid: np.ndarray, steps: int = 40, seed: int = 0,
                      crn: bool = True, mesh=None, convert_to_enu: bool = True,
                      noisy_plant: bool = True, effort_weight: float = 0.0,
                      device: Optional[torch.device | str] = None,
                      draws: Optional[Iterator] = None) -> list:
    """Score a grid of tracking-weight candidates — (p, v, q, w) scale
    factors on the config's ``perr``/``verr``/``qerr``/``werr`` — by
    closed-loop performance with the configured solver on a plant with one
    Euler-Maruyama draw a period (``noisy_plant``; the solver plans on the
    mean dynamics). ``effort_weight`` adds ``mean ||u - uref||^2`` to the
    score. Returns ``WeightTuneResult`` rows sorted by score (module
    docstring). ``device=None`` is the card; ``mesh`` the module
    docstring's (a solver that draws draws the padded grid's scenarios,
    each rank keeping its rows: ``build_mpc``'s ``shard``)."""
    grid = _checked_grid(grid, 4, "p, v, q, w scale")
    N = int(grid.shape[0])
    padded = _padded(grid, mesh)
    Np = int(padded.shape[0])
    rows, shard = slice(None), (0, 1)
    if mesh is not None:
        device, rows, shard = mesh.device, mesh.rows(Np), (mesh.dp_index, mesh.dp)
    base = dict(cfg)
    cfg_probe, probe, _ = build_mpc(dict(base), convert_to_enu, device)
    dev, base_cp = probe.device, probe.cost_params
    hp = torch.from_numpy(padded[rows]).to(dev)
    cp = base_cp._replace(perr=base_cp.perr * hp[:, 0:1], verr=base_cp.verr * hp[:, 1:2],
                          qerr=base_cp.qerr * hp[:, 2:3], werr=base_cp.werr * hp[:, 3:4])
    _, bundle, pieces = build_mpc(dict(base), convert_to_enu, dev,
                                  state_from_traj=probe.state_from_traj,
                                  cost_params_override=cp, shard=shard)
    w = _workload(cfg_probe, bundle, steps, convert_to_enu)
    if noisy_plant and draws is None:
        gen = torch.Generator().manual_seed(int(seed))
        shape = (steps, 13) if crn else (steps, N, 13)
        draws = torch.randn(shape, generator=gen, dtype=torch.float32)
        # one copy that does not wait for the work in flight
        draws = draws.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" \
            else draws.to(dev)
    N_all, N = N, int(hp.shape[0])
    noise = (_per_candidate(_mine(d, rows, Np, 0) if d.dim() == 2 else d, N, 1, dev)
             for d in draws) if noisy_plant else None
    solver_rng = torch.Generator().manual_seed(int(seed) + 1)
    dt = torch.full((), w.dt, dtype=torch.float32, device=dev)
    x = w.x0.expand(N, 13)
    xdes = w.xdes.expand(N, 13)
    st = pieces.reset(x, None, xdes)
    errs, effs = [], []
    with torch.no_grad():
        for k in range(steps):
            sol = pieces.solve(x, solver_rng, st, w.times[k].expand(N), xdes)
            u0, st = sol.u_opt[:, 0], sol.opt_state
            x = _plant_step(bundle.model, bundle.params, x, u0, dt,
                            next(noise) if noisy_plant else None)
            errs.append(torch.linalg.norm(x[:, :3] - w.refs[k], dim=-1))
            effs.append(torch.sum((u0 - base_cp.uref) ** 2, dim=-1))
        mean_err, mean_eff = torch.stack(errs).mean(0), torch.stack(effs).mean(0)
        out = torch.stack([mean_err + float(np.float32(effort_weight)) * mean_eff, mean_err,
                           mean_eff], dim=-1).cpu().numpy()
    out, N = _gathered(out, mesh, N_all), N_all
    results = [WeightTuneResult(p_scale=float(grid[i, 0]), v_scale=float(grid[i, 1]),
                                q_scale=float(grid[i, 2]), w_scale=float(grid[i, 3]),
                                score=float(out[i, 0]), mean_pos_err=float(out[i, 1]),
                                effort=float(out[i, 2]))
               for i in range(N)]
    results.sort(key=lambda r: r.score)
    return results
