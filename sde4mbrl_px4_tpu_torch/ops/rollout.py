"""Euler-Maruyama SDE rollout on torch tensors (L2).

PyTorch counterpart of ``sde4mbrl_px4_tpu/ops/rollout.py``. The horizon is
a Python loop (the plain version of the whole-solve kernel, which runs it
on the card). Brownian increments are an INPUT: JAX's threefry stream has
no torch twin, so parity tests draw them with numpy and hand the same
block to both packages. ``make_time_steps`` is copied from the original.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.models.sde_model import (
    NeuralSDE, drift_and_sigma, drift_fn)

__all__ = ["make_time_steps", "em_step", "rollout_mean", "rollout_sde"]


def make_time_steps(horizon: int, num_short_dt: int, short_step_dt: float,
                    long_step_dt: float) -> np.ndarray:
    """Per-step dt vector: ``num_short_dt`` fine steps then coarse steps."""
    n_short = min(int(num_short_dt), int(horizon))
    return np.asarray(
        [short_step_dt] * n_short + [long_step_dt] * (int(horizon) - n_short),
        dtype=np.float32,
    )


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
                noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo EM rollout with the Brownian block given.

    ``x0`` (13,) is broadcast to the P particles of ``noise`` (H, P, 13);
    all-zero noise is the mean-dynamics (``num_particles: 1``) flight
    configuration, which still reports sigma along the path for the
    uncertainty cost. Returns ``(x_paths (P, H+1, 13), sigma_paths (P, H, 13))``.
    """
    P = noise.shape[1]
    x = torch.broadcast_to(x0, (P, 13))
    xs, sigs = [x], []
    for t in range(u_seq.shape[0]):
        dt = time_steps[t]
        f, sig = drift_and_sigma(model, params, x, u_seq[t])
        x = _renorm_quat(x + dt * f + torch.sqrt(dt) * sig * noise[t])
        xs.append(x)
        sigs.append(sig)
    return torch.stack(xs, dim=1), torch.stack(sigs, dim=1)
