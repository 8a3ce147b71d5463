"""Flagship golden-trace replays for the port.

PyTorch counterpart of ``sde4mbrl_px4_tpu/engine/goldens.py``
(``replay_pos``, ``replay_traj``, ``replay_engagement``,
``replay_solver_family``): the same pinned plant states, seeds and
simulated clock, driven through the port's
:class:`~sde4mbrl_px4_tpu_torch.engine.controller.RecedingHorizonController`
(or, for a solver family, its raw ``(reset_fn, mpc_fn)`` pair), so the
port's command traces are held against the committed
``tests/goldens/iris_*.npz`` and ``family_*_trace.npz``. Give every
controller replay a controller of its own: a replay rewinds the
controller's warm starts (:func:`fresh`), and the engagement replay
replaces its automata.

Command-row layout: ``[u6, w4, idx]``. :func:`compare_to_golden` applies the
cross-backend gates of ``bench.py:250`` (warm-started APG is fp-chaotic:
commands gate at the chaos scale, the converged cost tightly, the pickup
index exactly).

:func:`constrained_problem` and :func:`constrained_plans` are the
fixed-budget state-constraint problem that the kernel-against-plain checks
on the card and the CPU parity tests share; :func:`padded_trunk` the
shipped model at trunk widths outside the P=1 kernels' register layout
(zero-padded, or with new units drawn like the shipped ones).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
from sde4mbrl_px4_tpu_torch.core.types import (
    CONTROL_STATES, CTRL_TRAJ_ACTIVE, CTRL_TRAJ_IDLE, hover_state)

__all__ = ["golden_dir", "fresh", "replay_traj", "replay_pos",
           "replay_engagement", "replay_solver_family", "compare_to_golden",
           "constrained_problem", "constrained_plans", "padded_trunk", "GATES",
           "SOLVER_FAMILIES", "ENGAGEMENT_GATED_FROM"]

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


# original :190-196
SOLVER_FAMILIES = {
    "p512anti": dict(base="iris_traj_mpc.yaml",
                     mut={"num_particles": 512, "antithetic": True,
                          "apg_mpc.max_iter": 6}),
    "mppi": dict(base="iris_posctrl_mpc.yaml", mut={"solver": "mppi"}),
    "policy": dict(base="iris_traj_mpc.yaml", mut={"solver": "policy"}),
}


def replay_solver_family(repo_root: str, family: str, n: int = 4, draws=None,
                         device=None, traj_t0: float = 3.0,
                         policy_path: str | None = None) -> np.ndarray:
    """Pinned-seed replay of one solver family's raw ``(reset_fn, mpc_fn)``
    pair (original :199-237): ``n`` warm receding-horizon solves along the
    trajectory from ``traj_t0`` (a config with a trajectory table, as
    ``p512anti``) or from a pinned offset state (``mppi``), each from the
    last one's ``x_evol[1]``, recording rows ``[u_opt[0], num_steps]``.
    ``draws`` is what ``mpc_fn`` gets as ``rng``: None for
    ``torch.Generator().manual_seed(0)``, or an iterator of each solve's
    draws (MPPI's ``(eps, c0)``, a (P, H, 13) Brownian block for particles;
    the original's own draws, in tests). ``policy_path`` (the ``policy``
    family) is a policy checkpoint to replay in place of the untrained init
    the config draws from its seed (the original's init is threefry draws,
    which tests carry across in a checkpoint file)."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    spec = SOLVER_FAMILIES[family]
    cfg = load_yaml_config(os.path.join(repo_root, "configs", spec["base"]))
    for key, val in spec["mut"].items():
        blk = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            blk = blk[p]
        blk[parts[-1]] = val
    if policy_path is not None:
        cfg["policy"] = dict(cfg.get("policy") or {}, params_path=policy_path)
    cfg, (reset_fn, mpc_fn), sft, bundle = make_mpc_from_config(cfg, device=device)
    dt = float(cfg["_time_steps"][0])
    rng = torch.Generator().manual_seed(0) if draws is None else draws
    if sft is not None:
        x = enu2ned(sft(np.float32(traj_t0)))
        t0 = traj_t0
    else:
        x = hover_state(bundle.device)
        x[0], x[2] = 0.5, -0.3
        t0 = 0.0
    st = reset_fn(x, rng, x)
    rows = []
    for k in range(n):
        u, st, rng, x_evol = mpc_fn(x, rng, st, np.float32(t0 + k * dt), x)
        x = x_evol[1]
        rows.append(np.concatenate([u[0].cpu().numpy().astype(np.float32),
                                    [float(st.num_steps)]]))
    return np.stack(rows)


# The first engagement-replay tick whose commands and cost are gated, per
# airframe. The hexa replay's idle ticks publish unconverged 100-iteration
# pos plans whose commands move by ~0.13 when the JAX package's own replay
# gets its states perturbed by 1e-6 relative, and its first engaged traj
# ticks start from those warm starts
# (test_torch_hexa_engagement.py::test_jax_hexa_engagement_is_fp_chaotic);
# from tick 20 on, both packages hold the gates. Modes and pickup indices
# are exact on every tick.
ENGAGEMENT_GATED_FROM = {"iris": 0, "hexa": 20}


def compare_to_golden(trace: np.ndarray, costs: np.ndarray,
                      golden_path: str, first: int = 0) -> Dict[str, float]:
    """Worst differences against a committed golden and whether every
    gate holds: ``{"du", "dw", "cost_rel", "idx_exact", "ok"}``. Commands
    and costs are compared from row ``first`` on, the pickup index on every
    row."""
    ref = np.load(golden_path)
    du = float(np.abs(trace[first:, :6] - ref["trace"][first:, :6]).max())
    dw = float(np.abs(trace[first:, 6:10] - ref["trace"][first:, 6:10]).max())
    idx_ok = bool((trace[:, 10] == ref["trace"][:, 10]).all())
    dc = float((np.abs(costs[first:] - ref["costs"][first:])
                / np.maximum(np.abs(ref["costs"][first:]), 1e-6)).max())
    ok = (du <= GATES["u"] and dw <= GATES["w"] and dc <= GATES["cost_rel"]
          and idx_ok)
    return {"du": du, "dw": dw, "cost_rel": dc, "idx_exact": idx_ok, "ok": ok}


def constrained_problem(b):
    """The fixed-budget state-constraint problem that the kernel-against-
    plain checks and the CPU parity tests share, on bundle ``b``'s device:
    a start past the velocity box (x0[3] = 0.6, as
    ``tests/test_prox_slack.py:85``), a hover reference, ``u_prev`` at
    uref, and a warm start of ``reset_fn``'s shape: the controls at
    uref + 0.02, the slack columns (nZ - n_u) at 0, inside every box of the
    shipped block. Returns ``(x0, x_ref, u_prev, z_init)``."""
    dev, H = b.device, int(b.time_steps.shape[0])
    x0 = hover_state(dev)
    x0[3] = 0.6
    x_ref = hover_state(dev).expand(H + 1, 13).contiguous()
    u_prev = b.cost_params.uref.clone()
    z_init = torch.cat([u_prev.expand(H, b.model.n_u) + 0.02,
                        torch.zeros(H, b.cost_params.n_slack, device=dev)], 1)
    return x0, x_ref, u_prev, z_init.contiguous()


def constrained_plans(b, K: int, seed: int) -> torch.Tensor:
    """(K, H, nZ) decision rows for bundle ``b``'s oracle: controls uniform
    in [0.3, 0.95] from ``seed``, slack targets uniform in [-0.9, 0.9]
    (inside and past the shipped boxes) from ``seed + 1000``."""
    H, n_u, m = int(b.time_steps.shape[0]), b.model.n_u, b.cost_params.n_slack
    u = np.random.RandomState(seed).uniform(0.3, 0.95, (K, H, n_u))
    s = np.random.RandomState(seed + 1000).uniform(-0.9, 0.9, (K, H, m))
    return torch.from_numpy(np.concatenate([u, s], -1).astype(np.float32)).to(b.device)


def padded_trunk(params: Dict[str, Any], hidden: int,
                 seed: int | None = None) -> Dict[str, Any]:
    """``params`` with the trunk's hidden layers padded to ``hidden`` units,
    a width outside the P=1 kernels' register layout (64 units), so a check
    drives the shared-memory step of ``value_batch`` and ``trajectory`` on
    the shipped model's dynamics. With ``seed`` None the padding is zero: the
    same function (a padded unit's pre-activation is 0, its swish 0, and it
    feeds nothing). With a ``seed`` the padded weights (into, between and out
    of the new units) are drawn from numpy at each layer's spread of the
    shipped weights, biases 0: new units like the shipped ones, which move
    the costs by ~1e-3 relative, so a step that drops them fails a check."""
    net = params["net"]
    h0 = int(net["w1"].shape[0])
    pad = int(hidden) - h0
    if pad < 0:
        raise ValueError(f"padded_trunk: {hidden} units is below the trunk's {h0}")
    fill = torch.nn.functional.pad
    out = dict(net, w0=fill(net["w0"], (0, pad)), b0=fill(net["b0"], (0, pad)),
               w1=fill(net["w1"], (0, pad, 0, pad)), b1=fill(net["b1"], (0, pad)),
               w2=fill(net["w2"], (0, 0, 0, pad)))
    if seed is not None:
        rs = np.random.RandomState(seed)
        for k in ("w0", "w1", "w2"):
            w = out[k].clone()
            new = torch.ones_like(w, dtype=torch.bool)
            new[:h0 if k != "w0" else None, :h0 if k != "w2" else None] = False
            draw = rs.standard_normal(int(new.sum())) * float(net[k].double().std())
            w[new] = torch.from_numpy(draw.astype(np.float32)).to(w.device)
            out[k] = w
    return dict(params, net=out)
