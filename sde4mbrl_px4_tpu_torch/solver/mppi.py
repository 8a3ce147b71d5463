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

**Batches.** Every tensor may carry a leading batch shape (``u_init``
(..., H, n), ``eps`` (..., iters, K, H, n), ``c0`` (..., iters, K, n)):
each scenario is its own solve, with its own softmax at its own
temperature, the incumbent as its candidate 0 and a result never worse
than its own warm start, and one round is ONE ``value_batch`` over all
scenarios' candidates (the oracle of ``ops/cuda/cost_oracle.py::
cost_oracle_batched``, the JAX package's ``vmap`` of the solve). On a
CUDA device the sums over the K candidates (the mean cost, then the
softmax's normaliser and the weighted plan, stacked into one sum) run as a
fixed pairwise tree of elementwise adds (:func:`ksum`), so a scenario's
numbers do not depend on how many others share the call: a batched solve
gives each scenario the bits of its solo solve (torch's reductions and
matrix products pick their order by shape). On the CPU they stay torch's
``mean``, ``softmax`` and ``einsum``, the plain version held to the JAX
package at rtol 1e-5 (the tree moves the last round's weight by ~3e-5: a
round's weights are sensitive to the last bits of the spread of its
costs). The exploration noise of every round is made before the first,
in one pass over the horizon. The solve reads no device value back on the
host and moves no host value to the device (a ``torch.tensor(...,
device="cuda")`` would wait for the work in flight): its scalars enter the
arithmetic as Python floats, computed in float32.

**Per-scenario knobs.** The continuous knobs ``sigma``, ``temperature``
and ``noise_beta`` may be (*batch) float32 tensors, one value per scenario
(the tuner's candidates, ``tuning/tuner.py``; the original takes them as
traced values, ``:133-138``); ``samples`` and ``iters`` stay ints. A
tensor ``noise_beta`` always takes the AR(1) chain and its ``c0`` draw, as
the original's traced beta does: at beta = 0 the chain gives the raw noise
exactly (``c = 0 * c + 1 * eps``). Each knob enters the arithmetic as the
same float32 product or quotient a Python float does, so a scenario's
numbers are those of its solo solve with its knobs as Python floats.

Observability mapping (:class:`APGState`): ``num_steps`` = iters,
``avg_linesearch`` = samples, ``stepsize``/``avg_stepsize`` = sigma,
``grad_sqr`` = the last round's weight not on the incumbent,
``init_cost``/``opt_cost`` = the costs of the warm start and the result
(``stepsize`` per scenario where ``sigma`` is).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.solver.apg import APGState, CostOracle, box_project

__all__ = ["MPPIConfig", "ar_chain", "draw_mppi_noise", "ksum", "mppi_solve"]


class MPPIConfig(NamedTuple):
    """The ``mppi`` YAML block. ``sigma`` is relative to the input-box
    width, ``temperature`` to the round's cost spread above its minimum;
    ``noise_beta`` > 0 time-correlates the noise along the horizon."""

    samples: int = 64
    sigma: Union[float, torch.Tensor] = 0.02
    temperature: Union[float, torch.Tensor] = 0.1
    iters: int = 8
    noise_beta: Union[float, torch.Tensor] = 0.7

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
                    device, batch: Tuple[int, ...] = ()
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One solve's draws from ``gen`` in one call, moved to ``device`` in
    one copy (from pinned memory on a CUDA device, so it does not wait for
    the work in flight). Order: all of ``eps`` (*batch, iters, K, H, n) in
    C order, then all of ``c0`` (*batch, iters, K, n); ``c0`` is not drawn
    when the chain does not run (:func:`ar_chain`)."""
    lead = tuple(int(b) for b in batch)
    n_eps = cfg.iters * cfg.samples * H * n
    n_c0 = cfg.iters * cfg.samples * n if ar_chain(cfg) else 0
    nb = int(np.prod(lead)) if lead else 1
    z = torch.randn(nb * (n_eps + n_c0), generator=gen, dtype=torch.float32,
                    device=gen.device)
    if torch.device(device).type == "cuda" and z.device.type == "cpu":
        z = z.pin_memory().to(device, non_blocking=True)
    else:
        z = z.to(device)
    eps = z[:nb * n_eps].view(*lead, cfg.iters, cfg.samples, H, n)
    c0 = z[nb * n_eps:].view(*lead, cfg.iters, cfg.samples, n) if n_c0 else None
    return eps, c0


def ar_chain(cfg: MPPIConfig) -> bool:
    """Whether a solve runs the AR(1) chain (and draws its ``c0``):
    ``noise_beta > 0``, or ``noise_beta`` per scenario (module docstring)."""
    return isinstance(cfg.noise_beta, torch.Tensor) or cfg.noise_beta > 0.0


def _knob(v, lead: Tuple[int, ...], dev: torch.device, trail: int):
    """A knob as the arithmetic takes it: a Python float holding its float32
    rounding, or its (*lead) float32 tensor with ``trail`` unit axes
    appended to broadcast against a (*lead, ...) operand."""
    if not isinstance(v, torch.Tensor):
        return _f32(v)
    v = v.to(dev, torch.float32)
    if tuple(v.shape) != lead:
        raise ValueError(f"per-scenario MPPI knobs must be {lead}, got {tuple(v.shape)}")
    return v.reshape(lead + (1,) * trail)


def ksum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a fixed pairwise tree of elementwise adds (zeros
    padded to a power of two once, then the first half plus the second), so
    every entry of the other axes sums in the same order whatever their
    sizes."""
    n = int(x.shape[dim])
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        pad = list(x.shape)
        pad[dim] = p - n
        x = torch.cat([x, x.new_zeros(pad)], dim)
    while p > 1:
        p //= 2
        x = x.narrow(dim, 0, p) + x.narrow(dim, p, p)
    return x.squeeze(dim)


def _tree_sums(dev: torch.device) -> bool:
    """Whether the sums over the candidates run as :func:`ksum`'s tree (on a
    CUDA device) or as torch's reductions (the module docstring says why)."""
    return dev.type == "cuda"


def _f32(v: float) -> float:
    """A Python float holding the float32 rounding of ``v``."""
    return float(np.float32(v))


def mppi_solve(oracle: CostOracle, u_init: torch.Tensor, lb: torch.Tensor,
               ub: torch.Tensor, cfg: MPPIConfig, eps: torch.Tensor,
               c0: Optional[torch.Tensor]) -> APGState:
    """Minimize the oracle's cost over box-constrained control sequences by
    iterated importance-weighted sampling. ``eps`` and ``c0`` are the
    standard-normal draws of the whole solve (see the module docstring);
    ``u_init`` (..., H, n) with a leading batch shape solves each scenario
    on its own over a batched oracle. On a CUDA device the sums over the
    candidates are :func:`ksum`'s, on the CPU torch's ``mean``, ``softmax``
    and ``einsum`` (:func:`_tree_sums`; the module docstring says why). The solve makes
    ``iters + 2`` ``value_batch`` evaluations and never reads a device value
    back on the host."""
    K, H, n = int(cfg.samples), int(u_init.shape[-2]), int(u_init.shape[-1])
    lead = tuple(u_init.shape[:-2])
    if tuple(eps.shape) != lead + (cfg.iters, K, H, n):
        raise ValueError(f"eps must be {lead + (cfg.iters, K, H, n)}, got {tuple(eps.shape)}")
    chain = ar_chain(cfg)
    if chain and (c0 is None or tuple(c0.shape) != lead + (cfg.iters, K, n)):
        raise ValueError(f"c0 must be {lead + (cfg.iters, K, n)} when noise_beta > 0 "
                         f"or per scenario")
    f32 = torch.float32
    dev = u_init.device
    # float32 scalars, as the original's jnp.float32 constants, or per
    # scenario float32 tensors shaped to broadcast where each is used
    lam = _knob(cfg.temperature, lead, dev, 1)              # against (..., 1)
    beta = _knob(cfg.noise_beta, lead, dev, 3)              # against (..., iters, K, n)
    if isinstance(beta, torch.Tensor):
        gain = torch.sqrt(1.0 - beta * beta)
    else:
        gain = float(np.sqrt(np.float32(1.0) - np.float32(beta) * np.float32(beta)))
    sig = _knob(cfg.sigma, lead, dev, 1)
    sigma = sig * (ub - lb)                                 # (n,) or (..., n)
    if isinstance(sig, torch.Tensor):
        sigma = sigma.unsqueeze(-2).unsqueeze(-2).unsqueeze(-2)   # (..., 1, 1, 1, n)

    u0 = box_project(u_init, lb, ub)
    f0 = oracle.value(u0)
    # every round's exploration noise at once (elementwise: the bits of
    # round by round)
    e = eps                                                   # (..., iters, K, H, n)
    if chain:
        # AR(1) along the horizon, started at its unit stationary
        # variance by c0 (original :118-127)
        c, rows = c0, []
        for t in range(H):
            c = beta * c + gain * eps[..., t, :]
            rows.append(c)
        e = torch.stack(rows, dim=-2)
    e = sigma * e
    e.select(-3, 0).zero_()                                   # candidate 0: the incumbent
    tree = _tree_sums(dev)
    u_mean, w0 = u0, torch.zeros(lead, dtype=f32, device=dev)
    for it in range(cfg.iters):
        cands = box_project(u_mean[..., None, :, :] + e[..., it, :, :, :], lb, ub)
        costs = oracle.value_batch(cands)                     # (..., K)
        cmin = torch.amin(costs, dim=-1, keepdim=True)
        if tree:
            # the softmax at the scale-free temperature; its exponent is
            # <= 0, 0 at the cheapest candidate, so no shift by the maximum
            spread = torch.clamp(ksum(costs, -1)[..., None] / K - cmin, min=1e-9)
            ez = torch.exp(-(costs - cmin) / (lam * spread))
            # the normaliser and the weighted plan in one tree
            s = ksum(torch.cat([ez[..., None], (ez[..., None, None] * cands).flatten(-2)],
                               dim=-1), -2)
            u_mean = (s[..., 1:] / s[..., :1]).unflatten(-1, (H, n))
            w0 = ez[..., 0] / s[..., 0]
        else:
            spread = torch.clamp(torch.mean(costs, -1, keepdim=True) - cmin, min=1e-9)
            w = torch.softmax(-(costs - cmin) / (lam * spread), dim=-1)
            u_mean = torch.einsum("...k,...khn->...hn", w, cands)   # fp32, TF32 off
            w0 = w[..., 0]
    moved = 1.0 - w0
    u_mean = box_project(u_mean, lb, ub)
    f_final = oracle.value(u_mean)
    # never return a sequence worse than the warm start (original :167-173)
    worse = f_final > f0
    u_mean = torch.where(worse[..., None, None], u0, u_mean)
    f_final = torch.where(worse, f0, f_final)

    def const(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev, f32).expand(lead).clone()
        return torch.full(lead, float(v), dtype=f32, device=dev)

    return APGState(yk=u_mean, num_steps=const(cfg.iters), stepsize=const(cfg.sigma),
                    avg_stepsize=const(cfg.sigma), avg_linesearch=const(K),
                    grad_sqr=moved, init_cost=f0, opt_cost=f_final)
