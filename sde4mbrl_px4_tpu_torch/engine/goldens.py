"""Flagship golden-trace replays for the port.

PyTorch counterpart of ``sde4mbrl_px4_tpu/engine/goldens.py``
(``replay_pos``, ``replay_traj``, ``replay_engagement``): the same pinned
plant states, seeds and simulated clock, driven through the port's
:class:`~sde4mbrl_px4_tpu_torch.engine.controller.RecedingHorizonController`,
so the port's command traces are held against the committed
``tests/goldens/iris_*.npz``. Give every replay a controller of its own:
a replay rewinds the controller's warm starts (:func:`fresh`), and the
engagement replay replaces its automata.

Command-row layout: ``[u6, w4, idx]``. :func:`compare_to_golden` applies the
cross-backend gates of ``bench.py:250`` (warm-started APG is fp-chaotic:
commands gate at the chaos scale, the converged cost tightly, the pickup
index exactly).
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
from sde4mbrl_px4_tpu_torch.core.types import (
    CONTROL_STATES, CTRL_TRAJ_ACTIVE, CTRL_TRAJ_IDLE, hover_state)

__all__ = ["golden_dir", "fresh", "replay_traj", "replay_pos",
           "replay_engagement", "compare_to_golden", "GATES"]

# bench.py:250 — |du| <= 0.03, |dw| <= 0.08, relative cost <= 0.02
GATES = {"u": 0.03, "w": 0.08, "cost_rel": 0.02}


def golden_dir(repo_root: str) -> str:
    return os.path.join(repo_root, "tests", "goldens")


def fresh(c, seed: int = 0) -> None:
    """Restore a controller's solver state to construction state."""
    c.rng_traj = torch.Generator().manual_seed(seed)
    c.rng_pos = torch.Generator().manual_seed(seed + 1)
    c.opt_state_traj = c.traj.default_opt_state
    c.opt_state_pos = c.pos.default_opt_state
    c._curr_ctrl = None
    c._idle_traj = False
    c.plan_sample_time_usec = -1.0


def _traj_state_ned(c, t: float) -> np.ndarray:
    x = enu2ned(c.traj.state_from_traj(np.float32(t)))
    return x.cpu().numpy().astype(np.float32)


def replay_traj(c, n: int = 6, traj_t0: float = 3.0):
    """Trajectory-mode replay on pinned plant states sampled from the
    reference itself. Returns ``(cmds[n, 11], costs[n])``."""
    fresh(c)
    cmds, costs = [], []
    for k in range(n):
        x = _traj_state_ned(c, traj_t0 + 0.05 * k)
        t_usec = 1e6 + k * 50_000.0
        rec = c.solve_once(x, CONTROL_STATES["traj"], traj_t0 + 0.05 * k,
                           hover_state().numpy(), t_usec)
        if rec.num_steps < 1:
            raise RuntimeError("trajectory solve executed no iteration")
        u6, w4, idx = c.pick_command(t_usec)
        cmds.append(np.concatenate([u6, w4, [idx]]))
        costs.append(rec.opt_cost)
    return np.stack(cmds), np.asarray(costs, np.float32)


def replay_pos(c, n: int = 6):
    """Position-hold replay around a pinned perturbed-state sequence.
    Returns ``(cmds[n, 11], costs[n])``."""
    fresh(c)
    rs = np.random.RandomState(7)
    x0 = enu2ned(hover_state()).numpy().astype(np.float32)
    cmds, costs = [], []
    for k in range(n):
        x_k = x0 + 0.05 * rs.randn(13).astype(np.float32)
        x_k[6:10] /= np.linalg.norm(x_k[6:10])
        t_usec = 1e6 + k * 50_000.0
        rec = c.solve_once(x_k, CONTROL_STATES["pos"], -1.0,
                           hover_state().numpy(), t_usec)
        u6, w4, idx = c.pick_command(t_usec)
        cmds.append(np.concatenate([u6, w4, [idx]]))
        costs.append(rec.opt_cost)
    return np.stack(cmds), np.asarray(costs, np.float32)


def replay_engagement(c, n_none: int = 4, n_idle: int = 10, n_traj: int = 28,
                      overrun_at: int = 20) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Engagement-sequence replay: none -> idle (pre-warming the trajectory
    solver every 2nd tick) -> traj engaged on a simulated clock -> one
    injected horizon-overrun pickup. Returns ``(modes[n], cmds[n, 11],
    costs[n])``. Replaces ``c.automata`` with a fresh one on that clock."""
    from sde4mbrl_px4_tpu_torch.engine.controller import ControlAutomata

    fresh(c)
    clock = [0.0]
    a = ControlAutomata(state_from_traj=c.automata.state_from_traj,
                        now_fn=lambda: clock[0], reset_done=True)
    c.automata = a

    rs = np.random.RandomState(3)
    x_hover = enu2ned(hover_state()).numpy().astype(np.float32)
    modes, cmds, costs = [], [], []
    overruns0 = c.overruns.count
    for k in range(n_none + n_idle + n_traj):
        clock[0] = 0.05 * k
        if k == n_none:
            ok, msg = a.set_mode(CTRL_TRAJ_IDLE)
            if not ok:
                raise RuntimeError(msg)
        if k == n_none + n_idle:
            ok, msg = a.set_mode(CTRL_TRAJ_ACTIVE)
            if not (ok and "started" in msg):
                raise RuntimeError(msg)
        control_state, tt, target = a.resolve()

        if control_state == CONTROL_STATES["traj"]:
            x = _traj_state_ned(c, max(tt, 0.0))
        else:
            x = x_hover + 0.02 * rs.randn(13).astype(np.float32)
            x[6:10] /= np.linalg.norm(x[6:10])

        t_usec = 1e6 + k * 50_000.0
        rec = c.solve_once(x, control_state, tt, np.asarray(target), t_usec)
        if control_state != CONTROL_STATES["idle"] and rec.num_steps < 1:
            raise RuntimeError(f"tick {k}: solve executed no iteration")
        pick_t = t_usec + (1.5e6 if k == n_none + n_idle + overrun_at else 0.0)
        u6, w4, idx = c.pick_command(pick_t)
        modes.append(control_state)
        cmds.append(np.concatenate([u6, w4, [idx]]))
        costs.append(rec.opt_cost)
    if c.overruns.count != overruns0 + 1:
        raise RuntimeError("overrun tick was not recorded")
    return (np.asarray(modes, np.int32), np.stack(cmds),
            np.asarray(costs, np.float32))


def compare_to_golden(trace: np.ndarray, costs: np.ndarray,
                      golden_path: str) -> Dict[str, float]:
    """Worst differences against a committed golden and whether every
    gate holds: ``{"du", "dw", "cost_rel", "idx_exact", "ok"}``."""
    ref = np.load(golden_path)
    du = float(np.abs(trace[:, :6] - ref["trace"][:, :6]).max())
    dw = float(np.abs(trace[:, 6:10] - ref["trace"][:, 6:10]).max())
    idx_ok = bool((trace[:, 10] == ref["trace"][:, 10]).all())
    dc = float((np.abs(costs - ref["costs"])
                / np.maximum(np.abs(ref["costs"]), 1e-6)).max())
    ok = (du <= GATES["u"] and dw <= GATES["w"] and dc <= GATES["cost_rel"]
          and idx_ok)
    return {"du": du, "dw": dw, "cost_rel": dc, "idx_exact": idx_ok, "ok": ok}
