"""MPPI (Model Predictive Path Integral) solver, plain PyTorch (L4).

PyTorch counterpart of ``sde4mbrl_px4_tpu/solver/mppi.py`` (``:92-184``),
line for line: ``iters`` rounds of K box-projected perturbed control
sequences around the running mean, candidate 0 the incumbent (zero
perturbation), AR(1)-smoothed exploration noise seeded at its stationary
variance, softmax weights at the scale-free temperature
``temperature * max(mean - min, 1e-9)`` of the round's costs, the fp32
weighted mean of the candidates, and a result never worse than the warm
start. Every cost evaluation goes through a
:class:`~sde4mbrl_px4_tpu_torch.solver.apg.CostOracle`: ``value_batch``
over the K candidates of a round, ``value`` for the warm start and the
result.

**Noise is an input.** JAX's threefry stream has no torch twin, so
:func:`mppi_solve` takes the standard-normal draws of a whole solve:
``eps`` (iters, K, H, n) and ``c0`` (iters, K, n) (None when
``noise_beta == 0``). :func:`draw_mppi_noise` draws them from a
``torch.Generator``; tests hand in JAX's own draws instead.

Observability mapping (:class:`APGState`): ``num_steps`` = iters,
``avg_linesearch`` = samples, ``stepsize``/``avg_stepsize`` = sigma,
``grad_sqr`` = the last round's weight not on the incumbent,
``init_cost``/``opt_cost`` = the costs of the warm start and the result.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from sde4mbrl_px4_tpu_torch.solver.apg import APGState, CostOracle, box_project

__all__ = ["MPPIConfig", "draw_mppi_noise", "mppi_solve"]


class MPPIConfig(NamedTuple):
    """The ``mppi`` YAML block. ``sigma`` is relative to the input-box
    width, ``temperature`` to the round's cost spread above its minimum;
    ``noise_beta`` > 0 time-correlates the noise along the horizon."""

    samples: int = 64
    sigma: float = 0.02
    temperature: float = 0.1
    iters: int = 8
    noise_beta: float = 0.7

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "MPPIConfig":
        m = cfg.get("mppi") or {}
        unknown = sorted(set(m) - {"samples", "sigma", "temperature",
                                   "iters", "noise_beta"})
        if unknown:
            warnings.warn(f"mppi block: unknown key(s) {unknown} will be "
                          "ignored (typo?)", stacklevel=2)
        return MPPIConfig(
            samples=int(m.get("samples", 64)),
            sigma=float(m.get("sigma", 0.02)),
            temperature=float(m.get("temperature", 0.1)),
            iters=int(m.get("iters", 8)),
            noise_beta=float(m.get("noise_beta", 0.7)),
        )


def draw_mppi_noise(gen: torch.Generator, cfg: MPPIConfig, H: int, n: int,
                    device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One solve's draws from ``gen`` in one call, moved to ``device`` in
    one copy. Order: all of ``eps`` (iters, K, H, n) in C order, then all
    of ``c0`` (iters, K, n); ``c0`` is not drawn when ``noise_beta == 0``."""
    n_eps = cfg.iters * cfg.samples * H * n
    n_c0 = cfg.iters * cfg.samples * n if cfg.noise_beta > 0.0 else 0
    z = torch.randn(n_eps + n_c0, generator=gen, dtype=torch.float32,
                    device=gen.device).to(device)
    eps = z[:n_eps].view(cfg.iters, cfg.samples, H, n)
    c0 = z[n_eps:].view(cfg.iters, cfg.samples, n) if n_c0 else None
    return eps, c0


def mppi_solve(oracle: CostOracle, u_init: torch.Tensor, lb: torch.Tensor,
               ub: torch.Tensor, cfg: MPPIConfig, eps: torch.Tensor,
               c0: Optional[torch.Tensor]) -> APGState:
    """Minimize the oracle's cost over box-constrained control sequences by
    iterated importance-weighted sampling. ``eps`` and ``c0`` are the
    standard-normal draws of the whole solve (see the module docstring).
    The solve makes ``iters + 2`` ``value_batch`` evaluations and never
    reads a device value back on the host."""
    K, H, n = int(cfg.samples), int(u_init.shape[0]), int(u_init.shape[1])
    if tuple(eps.shape) != (cfg.iters, K, H, n):
        raise ValueError(f"eps must be {(cfg.iters, K, H, n)}, got {tuple(eps.shape)}")
    if cfg.noise_beta > 0.0 and (c0 is None or tuple(c0.shape) != (cfg.iters, K, n)):
        raise ValueError(f"c0 must be {(cfg.iters, K, n)} when noise_beta > 0")
    f32 = torch.float32
    dev = u_init.device
    lam = torch.tensor(cfg.temperature, dtype=f32, device=dev)
    sigma = torch.tensor(cfg.sigma, dtype=f32, device=dev) * (ub - lb)
    beta = torch.tensor(cfg.noise_beta, dtype=f32, device=dev)
    gain = torch.sqrt(1.0 - beta * beta)

    u0 = box_project(u_init, lb, ub)
    f0 = oracle.value(u0)
    u_mean = u0
    moved = torch.zeros((), dtype=f32, device=dev)
    for it in range(cfg.iters):
        e = eps[it]
        if cfg.noise_beta > 0.0:
            # AR(1) along the horizon, started at its unit stationary
            # variance by c0 (original :118-127)
            c = c0[it]
            rows = []
            for t in range(H):
                c = beta * c + gain * e[:, t]
                rows.append(c)
            e = torch.stack(rows, dim=1)
        e = sigma * e
        e = torch.cat([torch.zeros_like(e[:1]), e[1:]])   # candidate 0: incumbent
        cands = box_project(u_mean[None] + e, lb, ub)
        costs = oracle.value_batch(cands)                  # (K,)
        cmin = torch.min(costs)
        spread = torch.clamp(torch.mean(costs) - cmin, min=1e-9)
        w = torch.softmax(-(costs - cmin) / (lam * spread), dim=0)
        u_mean = torch.einsum("k,khn->hn", w, cands)       # fp32, TF32 off
        moved = 1.0 - w[0]
    u_mean = box_project(u_mean, lb, ub)
    f_final = oracle.value(u_mean)
    # never return a sequence worse than the warm start (original :167-173)
    worse = f_final > f0
    u_mean = torch.where(worse, u0, u_mean)
    f_final = torch.where(worse, f0, f_final)

    def const(v):
        return torch.tensor(float(v), dtype=f32, device=dev)

    return APGState(yk=u_mean, num_steps=const(cfg.iters), stepsize=const(cfg.sigma),
                    avg_stepsize=const(cfg.sigma), avg_linesearch=const(K),
                    grad_sqr=moved, init_cost=f0, opt_cost=f_final)
