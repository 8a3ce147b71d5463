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
``stepsize`` (``:346-351``). This is the plain version the whole-solve
kernel (``ops/cuda/apg_kernel.py``) is held against, and the fixed-step
solver that the cost-oracle kernels (``ops/cuda/cost_oracle.py``) serve.

Candidate steps use the exact ``decrease_factor**k`` (Python doubles cast
to fp32), as the kernels do (``sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py:224-231``).

The loop is :func:`apg_solve_batched`, over B scenarios at once, with the
semantics of the JAX package's ``vmap`` of its ``while_loop``: each
scenario stops on its own tests and its carry is frozen from then on, so
each scenario's result is its solo solve's. Its stop tests stay on the
device; the loop reads one scalar per iteration (whether any scenario is
still running). :func:`apg_solve` is that loop at B = 1.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

__all__ = ["APGConfig", "APGState", "CostOracle", "apg_solve", "apg_solve_batched",
           "box_project", "df_powers", "resolve_t_init"]


class CostOracle(NamedTuple):
    """The cost evaluations a solver needs, however they are computed
    (counterpart of ``sde4mbrl_px4_tpu/solver/apg.py:39-61`` with the
    ``trajectory`` of ``ops/pallas/solve_kernels.py:359-369``):

    - ``value(u) -> ()``;
    - ``value_batch(U[K, H, n]) -> (K,)``;
    - ``value_and_grad(u) -> ((), (H, n))``;
    - ``trajectory(u) -> (H+1, 13)``, the mean rollout of a plan (None when
      the oracle wraps a bare cost function);
    - with a risk cost over particles (``ops/cuda/cost_oracle.py``; None
      elsewhere), for a solve over a block of them:
      ``value_batch_moments(U[K, H, n]) -> (K, 3)``, each plan's risk-free
      cost and the mean and centred second moment of its particles'
      totals, and ``value_and_grad_moments(u, moments (2,)) -> ((), (H,
      n))``, the risk-free cost and the gradient of the block's share of the
      risk cost, given the mean and std of the totals over all particles.
    """

    value: Callable
    value_batch: Callable
    value_and_grad: Callable
    trajectory: Optional[Callable] = None
    value_batch_moments: Optional[Callable] = None
    value_and_grad_moments: Optional[Callable] = None

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
    options; without the linesearch ``t_init`` is ignored. This is
    :func:`apg_solve_batched` at B = 1.
    """
    one = CostOracle(
        value=lambda u: oracle.value(u[0])[None],
        value_batch=lambda U: oracle.value_batch(U[0])[None],
        value_and_grad=lambda u: tuple(v[None] for v in oracle.value_and_grad(u[0])))
    st = apg_solve_batched(one, u_init[None], lb, ub, cfg,
                           None if t_init is None else torch.as_tensor(t_init).reshape(1),
                           precond, iter_budget)
    return APGState(*(f[0] for f in st))


def apg_solve_batched(oracle: CostOracle, u_init: torch.Tensor, lb: torch.Tensor,
                      ub: torch.Tensor, cfg: APGConfig,
                      t_init: Optional[torch.Tensor] = None,
                      precond: Optional[torch.Tensor] = None,
                      iter_budget: Optional[int] = None) -> APGState:
    """:func:`apg_solve` of B scenarios over a batched oracle
    (``value_and_grad`` (B, H, n) -> ((B,), (B, H, n)), ``value_batch``
    (B, K, H, n) -> (B, K), ``value`` (B, H, n) -> (B,)); ``t_init`` (B,)
    or None, every field of the result with a leading B. Each iteration
    evaluates every scenario (one launch per evaluation on the card) and
    updates only those still running; a scenario's numbers are its solo
    solve's.

    On the card the loop is host-bound (small tensor ops between the
    oracle's launches), so it keeps their count low: the momentum weights
    are a table indexed by the counter (one select, no host copy), the
    stagnation count is kept only
    where it can stop the loop before ``max_iter``, and at B = 1, where the
    loop runs only while its one scenario does, no carry is masked and the
    iteration count is the host's."""
    dev, f32 = u_init.device, torch.float32
    B = int(u_init.shape[0])
    if precond is None:
        dscale = lambda g: g
        dquad = lambda d: d * d
    else:
        D = precond.to(f32)
        dscale = lambda g: D * g
        dquad = lambda d: d * d / D
    proj = lambda u: box_project(u, lb, ub)
    col = lambda m: m.view(-1, 1, 1)          # a per-scenario value over the plan
    kmax = cfg.max_iter if iter_budget is None else min(
        cfg.max_iter, max(int(iter_budget), 1))
    solo = B == 1
    # a finished scenario's carry is frozen (needless at B = 1)
    keep = (lambda m, new, old: new) if solo else (
        lambda m, new, old: torch.where(m, new, old))
    # beta[k] = max(k / (k + 3), beta_init) in float32, or moment_scale
    if cfg.moment_scale is not None:
        beta_tab = torch.full((kmax + 1,), cfg.moment_scale, dtype=f32, device=dev)
    else:
        kf = torch.arange(kmax + 1, dtype=f32, device=dev)
        beta_tab = torch.clamp(kf / (kf + 3.0), min=cfg.beta_init)
    # the stagnation count can stop nothing unless it ends before kmax
    stall = cfg.max_no_improvement_iter < kmax

    u0 = proj(u_init)
    f0, g0 = oracle.value_and_grad(u0)
    zi = torch.zeros(B, dtype=torch.long, device=dev)
    k, k_m, no_imp = zi, zi, zi
    u = y = best_u = y_prev = u0
    g_prev = g0
    f_u = best_f = f0
    if cfg.use_linesearch:
        dfp = df_powers(cfg)
        df_k = torch.tensor(dfp[:cfg.maxls], dtype=f32, device=dev)
        t = resolve_t_init(cfg, t_init, dev).expand(B)
        sum_ls = torch.zeros(B, dtype=f32, device=dev)
    else:
        t = torch.full((B,), cfg.stepsize, dtype=f32, device=dev)
        tD = col(t) if precond is None else col(t) * D      # the fixed step's scale
    sum_t = torch.zeros(B, dtype=f32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for it in range(kmax):
        kk = it if solo else k                   # the iterations done so far
        f_y, g = oracle.value_and_grad(y)
        if cfg.use_linesearch:
            t_acc, n_ls, ok, u_trial, f_trial = _vector_linesearch(
                cfg, oracle.value_batch, y, f_y, g, t, kk, y_prev, g_prev, proj,
                dscale, dquad, df_k, dfp[cfg.maxls])
        else:
            # fixed step (original :346-351)
            t_acc = t
            u_trial = proj(torch.addcmul(y, tD, g, value=-1.0))
            f_trial = oracle.value(u_trial)
            ok = f_trial <= f_y
        u_new = torch.where(col(ok), u_trial, u)
        f_new = torch.where(ok, f_trial, f_u)
        if cfg.momentum_restart:
            beta = beta_tab.index_select(0, k_m)
        else:
            beta = beta_tab[it:it + 1] if solo else beta_tab.index_select(0, k)
        # no restart (an accepted step that did not raise the cost): momentum
        down = ok & (f_new <= f_u)
        y_new = u_new + col(beta * down) * (u_new - u)
        improved = f_new < best_f - 1e-12
        stop = ok & (torch.abs(f_u - f_new) <= cfg.atol + cfg.rtol * torch.abs(f_u))
        run = active
        if stall:
            no_imp_new = torch.where(improved, 0, no_imp + 1)
            stop = stop | (no_imp_new >= cfg.max_no_improvement_iter)
            no_imp = keep(run, no_imp_new, no_imp)
        run3 = None if solo else col(run)
        best_u = torch.where(col(improved if solo else improved & run), u_new, best_u)
        best_f = keep(run, torch.minimum(f_new, best_f), best_f)
        if cfg.momentum_restart:
            k_m = keep(run, (k_m + 1) * down, k_m)
        y_prev, g_prev = y, g
        u = keep(run3, u_new, u)
        y = keep(run3, y_new, y)
        f_u = keep(run, f_new, f_u)
        sum_t = keep(run, sum_t + t_acc, sum_t)
        if cfg.use_linesearch:
            t = keep(run, t_acc, t)
            sum_ls = keep(run, sum_ls + n_ls, sum_ls)
        if not solo:
            k = torch.where(run, k + 1, k)
        if it + 1 == kmax:
            break
        if solo:
            if bool(stop):
                break
        else:
            active = run & ~stop
            if not bool(active.any()):
                break
    if solo:
        k = torch.full((1,), it + 1 if kmax else 0, dtype=torch.long, device=dev)

    _, g_fin = oracle.value_and_grad(best_u)
    n_steps = torch.clamp(k, min=1).to(f32)
    return APGState(
        yk=best_u, num_steps=k.to(f32), stepsize=t, avg_stepsize=sum_t / n_steps,
        avg_linesearch=(sum_ls if cfg.use_linesearch else k.to(f32)) / n_steps,
        grad_sqr=torch.sum(g_fin * g_fin, dim=(1, 2)), init_cost=f0, opt_cost=best_f)


def _vector_linesearch(cfg: APGConfig, value_batch: Callable, y, f_y, g, t, k,
                       y_prev, g_prev, proj, dscale, dquad, df_k, df_K: float):
    """Per scenario: the trial stepsize by ``reset_option``, then all
    ``maxls`` Armijo candidates in one batched evaluation; the first
    (largest) accepted step wins. Returns ``(t_acc, n_ls, ok, u_trial,
    f_trial)``, each with a leading B."""
    K = cfg.maxls
    tmax = cfg.max_stepsize
    if cfg.reset_option == "bb":
        s = y - y_prev
        r = g - g_prev
        sr = torch.sum(s * r, dim=(1, 2))
        rr = torch.sum(r * dscale(r), dim=(1, 2))
        t_bb = sr / torch.clamp(rr, min=1e-12)
        t_inc = torch.clamp(t * cfg.increase_factor, max=tmax)
        t0 = torch.where((k > 0) & (sr > 1e-12), torch.clamp(t_bb, 1e-6, tmax), t_inc)
    elif cfg.reset_option == "increase":
        t0 = torch.clamp(t * cfg.increase_factor, max=tmax)
    else:
        t0 = t

    ts = t0[:, None] * df_k                                   # (B, K)
    u_ts = proj(y[:, None] - ts[..., None, None] * dscale(g)[:, None])   # (B, K, H, n)
    f_ts = value_batch(u_ts)
    d = u_ts - y[:, None]
    lin = torch.sum(g[:, None] * d, dim=(2, 3))
    quad = torch.sum(dquad(d), dim=(2, 3)) / (2.0 * torch.clamp(ts, min=1e-12))
    ok_k = f_ts <= f_y[:, None] + (1.0 - cfg.coef) * lin + quad
    idx = torch.argmax(ok_k.to(torch.int32), dim=1)          # the first accepted
    ok = torch.any(ok_k, dim=1)
    b = torch.arange(int(y.shape[0]), device=y.device)
    t_acc = torch.where(ok, ts[b, idx], t0 * df_K)
    n_ls = torch.where(ok, (idx + 1).to(torch.float32), float(K))
    return t_acc, n_ls, ok, u_ts[b, idx], f_ts[b, idx]
