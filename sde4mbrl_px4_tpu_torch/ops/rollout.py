"""Euler-Maruyama SDE rollout on torch tensors (L2).

PyTorch counterpart of ``sde4mbrl_px4_tpu/ops/rollout.py``. The horizon is
a Python loop (the plain version of the whole-solve kernel, which runs it
on the card). Brownian increments are an INPUT: JAX's threefry stream has
no torch twin, so parity tests draw them with numpy (or with JAX) and hand
the same block to both packages; the port's own draws come from a
``torch.Generator`` (:func:`draw_brownian`). So are the per-particle
start draws of ``initial_state_std`` (:func:`draw_start_spread`; the
original's ``:163-169``): particle p starts from
``renorm_quat(x0 + std * z0[p])`` (:func:`particle_starts`).
``make_time_steps`` is copied from the original.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.models.sde_model import (
    NeuralSDE, drift_and_sigma, drift_fn)

__all__ = ["make_time_steps", "draw_brownian", "draw_start_spread", "em_step",
           "particle_starts", "rollout_mean", "rollout_sde"]


def make_time_steps(horizon: int, num_short_dt: int, short_step_dt: float,
                    long_step_dt: float) -> np.ndarray:
    """Per-step dt vector: ``num_short_dt`` fine steps then coarse steps."""
    n_short = min(int(num_short_dt), int(horizon))
    return np.asarray(
        [short_step_dt] * n_short + [long_step_dt] * (int(horizon) - n_short),
        dtype=np.float32,
    )


def draw_brownian(gen: torch.Generator, H: int, P: int, antithetic: bool = False,
                  device=None) -> torch.Tensor:
    """Brownian increments (H, P, 13) from ``gen`` (counterpart of the
    original ``ops/rollout.py:33-51``), drawn in one call on the generator's
    device and moved to ``device`` in one copy. ``antithetic`` draws
    z (H, P/2, 13) and returns ``cat([z, -z], dim=1)``: mirrored path pairs,
    an unbiased particle mean at lower variance; it needs an even P."""
    if antithetic and P % 2:
        raise ValueError(f"antithetic sampling needs an even particle count, got {P}")
    n = P // 2 if antithetic else P
    z = torch.randn((H, n, 13), generator=gen, dtype=torch.float32,
                    device=gen.device)
    if device is not None:
        z = z.to(device)
    return torch.cat([z, -z], dim=1) if antithetic else z


def draw_start_spread(gen: torch.Generator, P: int, antithetic: bool = False,
                      device=None, batch: Tuple[int, ...] = ()) -> torch.Tensor:
    """Standard normals ``z0`` (*batch, P, 13) of the per-particle starts,
    drawn in one call on the generator's device and moved to ``device`` in
    one copy. ``antithetic`` pairs particle p with p + P/2 as ``(z, -z)``,
    as :func:`draw_brownian` pairs the paths (the original draws ``z0`` with
    its ``draw_brownian`` at H = 1, ``ops/rollout.py:165-167``)."""
    if antithetic and P % 2:
        raise ValueError(f"antithetic sampling needs an even particle count, got {P}")
    n = P // 2 if antithetic else P
    z = torch.randn(tuple(batch) + (n, 13), generator=gen, dtype=torch.float32,
                    device=gen.device)
    if device is not None:
        z = z.to(device)
    return torch.cat([z, -z], dim=-2) if antithetic else z


def particle_starts(x0: torch.Tensor, x0_spread: torch.Tensor,
                    z0: torch.Tensor) -> torch.Tensor:
    """The particles' initial states ``renorm_quat(x0 + x0_spread * z0)``:
    ``x0`` (..., 13), ``z0`` (..., P, 13), ``x0_spread`` (13,) -> (..., P,
    13), the original's ``:168-169``; one elementwise pass on the inputs'
    device."""
    return _renorm_quat(x0.unsqueeze(-2) + x0_spread * z0)


def _renorm_quat(x: torch.Tensor) -> torch.Tensor:
    pv, q, om = x.split((6, 4, 3), dim=-1)
    return torch.cat([pv, quat.qnormalize(q), om], dim=-1)


def em_step(model: NeuralSDE, params: Dict[str, Any], x: torch.Tensor,
            u: torch.Tensor, dt: torch.Tensor,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Euler(-Maruyama) step; ``noise`` ~ N(0,1) or None for the mean
    dynamics. Quaternion re-projected to S³."""
    if noise is not None:
        f, sig = drift_and_sigma(model, params, x, u)
        x1 = x + dt * f + torch.sqrt(dt) * sig * noise
    else:
        x1 = x + dt * drift_fn(model, params, x, u)
    return _renorm_quat(x1)


def rollout_mean(model: NeuralSDE, params: Dict[str, Any], x0: torch.Tensor,
                 u_seq: torch.Tensor, time_steps: torch.Tensor) -> torch.Tensor:
    """Deterministic rollout: ``x0`` (13,), ``u_seq`` (H, n_u) -> (H+1, 13)."""
    xs = [x0]
    for t in range(u_seq.shape[-2]):
        xs.append(em_step(model, params, xs[-1], u_seq[..., t, :], time_steps[t]))
    return torch.stack(xs, dim=-2)


def rollout_sde(model: NeuralSDE, params: Dict[str, Any], x0: torch.Tensor,
                u_seq: torch.Tensor, time_steps: torch.Tensor,
                noise: torch.Tensor, x0_spread: Optional[torch.Tensor] = None,
                z0: Optional[torch.Tensor] = None, bf16: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo EM rollout with the Brownian block given.

    ``x0`` (13,) is broadcast to the P particles of ``noise`` (H, P, 13)
    (or ``x0`` (P, 13) gives each particle its start); all-zero noise is the
    mean-dynamics (``num_particles: 1``) flight configuration, which still
    reports sigma along the path for the uncertainty cost. With
    ``x0_spread`` (13,) and ``z0`` (P, 13) particle p starts from
    :func:`particle_starts` (``initial_state_std``). ``bf16``: the trunk's
    products on bf16-rounded operands (``models/sde_model.py::trunk_apply``;
    the original's ``precision=DEFAULT`` on its TPU). Returns ``(x_paths
    (P, H+1, 13), sigma_paths (P, H, 13))``.
    """
    P = noise.shape[1]
    if x0_spread is not None and z0 is not None:
        x0 = particle_starts(x0, x0_spread, z0)
    x = torch.broadcast_to(x0, (P, 13))
    xs, sigs = [x], []
    for t in range(u_seq.shape[0]):
        dt = time_steps[t]
        f, sig = drift_and_sigma(model, params, x, u_seq[t], bf16)
        x = _renorm_quat(x + dt * f + torch.sqrt(dt) * sig * noise[t])
        xs.append(x)
        sigs.append(sig)
    return torch.stack(xs, dim=1), torch.stack(sigs, dim=1)
