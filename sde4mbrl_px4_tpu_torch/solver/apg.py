"""Accelerated proximal-gradient (APG) trajectory optimizer, plain PyTorch (L4).

PyTorch counterpart of ``sde4mbrl_px4_tpu/solver/apg.py::apg_solve``
(``:173``) on its production path, the vector linesearch (``:283``): all
``maxls`` Armijo candidates evaluated as one batch, the first (largest)
accepted step wins. Nesterov momentum ``max(k/(k+3), beta_init)`` with
adaptive restart (optionally resetting the momentum counter), best-iterate
tracking, atol/rtol and stagnation stops, the three ``reset_option`` trial
steps (increase / conservative / Barzilai-Borwein), the diagonal
``precond`` metric, the ``t_init`` stepsize carry and the ``iter_budget``
cap. Without a ``linesearch`` block the solver takes fixed steps of
``stepsize`` (``:346-351``). The loop runs on the host and reads its stop
test every iteration: this is the plain version the whole-solve kernel
(``ops/cuda/apg_kernel.py``) is held against, and the fixed-step solver
that the cost-oracle kernels (``ops/cuda/cost_oracle.py``) serve.

Candidate steps use the exact ``decrease_factor**k`` (Python doubles cast
to fp32), as the kernels do (``sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py:224-231``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

__all__ = ["APGConfig", "APGState", "CostOracle", "apg_solve", "box_project",
           "df_powers", "resolve_t_init"]


class CostOracle(NamedTuple):
    """The cost evaluations a solver needs, however they are computed
    (counterpart of ``sde4mbrl_px4_tpu/solver/apg.py:39-61`` with the
    ``trajectory`` of ``ops/pallas/solve_kernels.py:359-369``):

    - ``value(u) -> ()``;
    - ``value_batch(U[K, H, n]) -> (K,)``;
    - ``value_and_grad(u) -> ((), (H, n))``;
    - ``trajectory(u) -> (H+1, 13)``, the mean rollout of a plan (None when
      the oracle wraps a bare cost function).
    """

    value: Callable
    value_batch: Callable
    value_and_grad: Callable
    trajectory: Optional[Callable] = None

    @staticmethod
    def from_fn(cost_fn: Callable) -> "CostOracle":
        def value_and_grad(u):
            with torch.enable_grad():
                u_ = u.detach().requires_grad_(True)
                f = cost_fn(u_)
                (g,) = torch.autograd.grad(f, u_)
            return f.detach(), g

        return CostOracle(value=cost_fn, value_batch=torch.func.vmap(cost_fn),
                          value_and_grad=value_and_grad)


class APGConfig(NamedTuple):
    """Static solver configuration (the ``apg_mpc`` YAML block)."""

    max_iter: int = 200
    max_no_improvement_iter: int = 200
    stepsize: float = 1.0
    moment_scale: Optional[float] = None
    beta_init: float = 0.25
    atol: float = 1e-8
    rtol: float = 1e-6
    use_linesearch: bool = True
    init_stepsize: float = 0.01
    max_stepsize: float = 1.0
    coef: float = 0.01
    decrease_factor: float = 0.7
    increase_factor: float = 1.3
    reset_option: str = "increase"  # or "conservative" | "bb"
    maxls: int = 4
    momentum_restart: bool = True

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "APGConfig":
        a = cfg["apg_mpc"]
        ls = a.get("linesearch")
        kw = dict(
            max_iter=int(a.get("max_iter", 200)),
            max_no_improvement_iter=int(a.get("max_no_improvement_iter", a.get("max_iter", 200))),
            stepsize=float(a.get("stepsize", 1.0)),
            moment_scale=None if a.get("moment_scale") is None else float(a["moment_scale"]),
            beta_init=float(a.get("beta_init", 0.25)),
            atol=float(a.get("atol", 1e-8)),
            rtol=float(a.get("rtol", 1e-6)),
            use_linesearch=ls is not None,
            momentum_restart=bool(a.get("momentum_restart", True)),
        )
        if ls is not None:
            kw.update(
                init_stepsize=float(ls.get("init_stepsize", 0.01)),
                max_stepsize=float(ls.get("max_stepsize", 1.0)),
                coef=float(ls.get("coef", 0.01)),
                decrease_factor=float(ls.get("decrease_factor", 0.7)),
                increase_factor=float(ls.get("increase_factor", 1.3)),
                reset_option=str(ls.get("reset_option", "increase")),
                maxls=int(ls.get("maxls", 4)),
            )
        return APGConfig(**kw)


class APGState(NamedTuple):
    """Warm-start + observability state (fp32 0-dim tensors but ``yk``)."""

    yk: torch.Tensor             # (H, nZ) best iterate
    num_steps: torch.Tensor
    stepsize: torch.Tensor
    avg_stepsize: torch.Tensor
    avg_linesearch: torch.Tensor
    grad_sqr: torch.Tensor
    init_cost: torch.Tensor
    opt_cost: torch.Tensor


def box_project(u: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    return torch.clamp(u, lb, ub)


def df_powers(cfg: APGConfig) -> list:
    """``[float32(DF**k) for k in 0..maxls]`` from Python doubles."""
    return [float(torch.tensor(cfg.decrease_factor ** k, dtype=torch.float32))
            for k in range(cfg.maxls + 1)]


def resolve_t_init(cfg: APGConfig, t_init: Optional[torch.Tensor],
                   device) -> torch.Tensor:
    """The first trial stepsize on ``device`` (0-dim, or the shape of a
    batch of carried stepsizes): the carried stepsize clamped to [1e-6,
    max_stepsize] when positive, else ``init_stepsize`` (no host sync)."""
    init = torch.full((), cfg.init_stepsize, dtype=torch.float32, device=device)
    if t_init is None:
        return init
    ti = torch.as_tensor(t_init, dtype=torch.float32, device=device)
    return torch.where(ti > 0.0, torch.clamp(ti, 1e-6, cfg.max_stepsize), init)


def apg_solve(oracle: CostOracle, u_init: torch.Tensor, lb: torch.Tensor,
              ub: torch.Tensor, cfg: APGConfig, t_init: Optional[torch.Tensor] = None,
              precond: Optional[torch.Tensor] = None,
              iter_budget: Optional[int] = None) -> APGState:
    """Minimize a cost over box-constrained control sequences.

    The oracle evaluates the cost: ``value_and_grad`` at every iterate,
    ``value_batch`` over the ``maxls`` linesearch candidates, ``value`` at
    the fixed-step trial point. Returns the :class:`APGState` whose ``yk``
    is the best iterate (not shifted). See the module docstring for the
    options; without the linesearch ``t_init`` is ignored.
    """
    value_and_grad = oracle.value_and_grad
    dev = u_init.device
    dfp = df_powers(cfg)
    df_k = torch.tensor(dfp[:cfg.maxls], dtype=torch.float32, device=dev)
    if precond is None:
        dscale = lambda g: g
        dquad = lambda d: d * d
    else:
        D = torch.broadcast_to(precond.to(torch.float32), u_init.shape)
        dscale = lambda g: D * g
        dquad = lambda d: d * d / D
    proj = lambda u: box_project(u, lb, ub)

    kmax = cfg.max_iter if iter_budget is None else min(
        cfg.max_iter, max(int(iter_budget), 1))

    u0 = proj(u_init)
    f0, g0 = value_and_grad(u0)
    k = k_m = no_imp = 0
    u = y = best_u = y_prev = u0
    g_prev = g0
    f_u = best_f = f0
    if cfg.use_linesearch:
        t = resolve_t_init(cfg, t_init, dev)
    else:
        t = torch.tensor(cfg.stepsize, dtype=torch.float32, device=dev)
    sum_t = torch.zeros((), dtype=torch.float32, device=dev)
    sum_ls = torch.zeros((), dtype=torch.float32, device=dev)
    done = False
    while k < kmax and not done:
        f_y, g = value_and_grad(y)
        if cfg.use_linesearch:
            t_acc, n_ls, ok, u_trial, f_trial = _vector_linesearch(
                cfg, oracle.value_batch, y, f_y, g, t, k, y_prev, g_prev, proj,
                dscale, dquad, df_k, dfp[cfg.maxls])
        else:
            # fixed step (original :346-351)
            t_acc, n_ls = t, 1.0
            u_trial = proj(y - t_acc * dscale(g))
            f_trial = oracle.value(u_trial)
            ok = bool(f_trial <= f_y)

        u_new = u_trial if ok else u
        f_new = f_trial if ok else f_u

        kf = float(k_m if cfg.momentum_restart else k)
        beta = (cfg.moment_scale if cfg.moment_scale is not None
                else max(float(torch.tensor(kf / (kf + 3.0), dtype=torch.float32)),
                         cfg.beta_init))
        restart = (not ok) or bool(f_new > f_u)
        y_new = u_new if restart else u_new + beta * (u_new - u)
        k_m = 0 if restart else k_m + 1

        improved = bool(f_new < best_f - 1e-12)
        best_f = torch.minimum(f_new, best_f)
        best_u = u_new if improved else best_u
        no_imp = 0 if improved else no_imp + 1
        converged = ok and bool(torch.abs(f_u - f_new) <= cfg.atol + cfg.rtol * torch.abs(f_u))
        done = converged or no_imp >= cfg.max_no_improvement_iter

        y_prev, g_prev = y, g
        u, y, f_u, t = u_new, y_new, f_new, t_acc
        sum_t = sum_t + t_acc
        sum_ls = sum_ls + n_ls
        k += 1

    _, g_fin = value_and_grad(best_u)
    n_steps = float(max(k, 1))
    return APGState(
        yk=best_u,
        num_steps=torch.tensor(float(k), device=dev),
        stepsize=torch.as_tensor(t, dtype=torch.float32, device=dev),
        avg_stepsize=sum_t / n_steps,
        avg_linesearch=sum_ls / n_steps,
        grad_sqr=torch.sum(g_fin * g_fin),
        init_cost=f0,
        opt_cost=best_f,
    )


def _vector_linesearch(cfg: APGConfig, value_batch: Callable, y, f_y, g, t,
                       k: int, y_prev, g_prev, proj, dscale, dquad, df_k,
                       df_K: float):
    """Trial stepsize by ``reset_option``, then all ``maxls`` Armijo
    candidates in one batched evaluation; the first (largest) accepted
    step wins. Returns ``(t_acc, n_ls, ok, u_trial, f_trial)``."""
    K = cfg.maxls
    tmax = cfg.max_stepsize
    if cfg.reset_option == "bb":
        s = y - y_prev
        r = g - g_prev
        sr = torch.sum(s * r)
        rr = torch.sum(r * dscale(r))
        t_bb = sr / torch.clamp(rr, min=1e-12)
        t_inc = torch.clamp(t * cfg.increase_factor, max=tmax)
        t0 = (torch.where(sr > 1e-12, torch.clamp(t_bb, 1e-6, tmax), t_inc)
              if k > 0 else t_inc)
    elif cfg.reset_option == "increase":
        t0 = torch.clamp(t * cfg.increase_factor, max=tmax)
    else:
        t0 = t

    ts = t0 * df_k                                           # (K,)
    u_ts = proj(y[None] - ts[:, None, None] * dscale(g)[None])  # (K, H, n)
    f_ts = value_batch(u_ts)
    d = u_ts - y[None]
    lin = torch.sum(g[None] * d, dim=(1, 2))
    quad = torch.sum(dquad(d), dim=(1, 2)) / (2.0 * torch.clamp(ts, min=1e-12))
    ok_k = f_ts <= f_y + (1.0 - cfg.coef) * lin + quad
    idx = torch.argmax(ok_k.to(torch.int32))
    ok = bool(torch.any(ok_k))
    t_acc = ts[idx] if ok else t0 * df_K
    n_ls = float(int(idx) + 1) if ok else float(K)
    return t_acc, n_ls, ok, u_ts[idx], f_ts[idx]
