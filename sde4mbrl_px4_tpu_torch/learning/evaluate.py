"""Model evaluation: k-step prediction error and uncertainty calibration.

PyTorch counterpart of ``sde4mbrl_px4_tpu/learning/evaluate.py``
(``:35-174``), the offline counterpart of ``learning/trainer.py``:

- :func:`kstep_errors` — open-loop k-step-ahead prediction RMSE of the
  mean dynamics against a recorded state/control sequence, per state group
  (position, velocity, attitude angle, body rate). Deterministic, so it is
  held to the original's numbers.
- :func:`calibration` — empirical coverage of the Monte-Carlo particle
  ensemble at k steps against the nominal central-interval probability,
  plus the spread ratio (ensemble std / realized error). The Brownian
  block (W, P, k, 13) of the W windows is an input ("noise is an input"):
  drawn from a ``torch.Generator``, or the next item of an iterator, which
  is how the tests hand in the original's draws.

Every window is one batched rollout (the original vmaps them); no kernel
is involved (the JAX package runs these on XLA).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.device import resolve_device
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, drift_and_sigma
from sde4mbrl_px4_tpu_torch.models.params_io import params_from_numpy, params_to_numpy
from sde4mbrl_px4_tpu_torch.ops.rollout import _renorm_quat, rollout_mean

__all__ = ["kstep_errors", "calibration", "evaluate_model"]

_EU = [0, 1, 2, 3, 4, 5, 10, 11, 12]   # the Euclidean state dims


def _windows(n: int, k: int, max_windows: int) -> np.ndarray:
    """Evenly-spaced window start indices: every window fits k steps."""
    last = n - k - 1
    if last < 0:
        raise ValueError(f"sequence of {n} samples is too short for k={k}")
    count = min(last + 1, max_windows)
    return np.unique(np.linspace(0, last, count).astype(np.int64))


def _quat_angle(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Geodesic attitude angle [rad] between unit quaternions (sign-free)."""
    d = torch.clamp(torch.abs(torch.sum(qa * qb, dim=-1)), 0.0, 1.0)
    return 2.0 * torch.arccos(d)


def _on(model: NeuralSDE, params: Dict[str, Any], dev: torch.device):
    model = NeuralSDE(model.vehicle, model.mixing.to(dev), model.inertia.to(dev))
    return model, params_from_numpy(params_to_numpy(params), dev)


def _rms(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.sum(a * a, -1)))


def kstep_errors(
    model: NeuralSDE,
    params: Dict[str, Any],
    t: np.ndarray,
    x: np.ndarray,
    u: np.ndarray,
    ks: Sequence[int] = (1, 5, 10, 20),
    max_windows: int = 256,
    device: Optional[torch.device | str] = None,
) -> Dict[str, Dict[str, float]]:
    """Open-loop k-step mean-dynamics prediction errors; ``t`` (N,) uniform
    sample times, ``x`` (N, 13) measured states, ``u`` (N, n_u) applied
    controls (u[i] acts over [t[i], t[i+1]]). Returns ``{f"k{k}":
    {"horizon_s", "pos_rmse_m", "vel_rmse_mps", "att_err_rad",
    "rate_rmse_radps", "windows"}}``. ``device`` None is the card."""
    dev = resolve_device(device)
    model, params = _on(model, params, dev)
    dt = float(np.median(np.diff(np.asarray(t, np.float64))))
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    u = torch.as_tensor(np.asarray(u, np.float32), device=dev)
    out: Dict[str, Dict[str, float]] = {}
    for k in ks:
        k = int(k)
        idx = torch.as_tensor(_windows(x.shape[0], k, max_windows), device=dev)
        useq = u[idx[:, None] + torch.arange(k, device=dev)]          # (W, k, n_u)
        ts = torch.full((k,), dt, dtype=torch.float32, device=dev)
        with torch.no_grad():
            xp = rollout_mean(model, params, x[idx], useq, ts)[:, -1]
        xt = x[idx + k]
        out[f"k{k}"] = {
            "horizon_s": round(k * dt, 4),
            "pos_rmse_m": float(_rms(xp[:, 0:3] - xt[:, 0:3])),
            "vel_rmse_mps": float(_rms(xp[:, 3:6] - xt[:, 3:6])),
            "att_err_rad": float(torch.mean(_quat_angle(xp[:, 6:10], xt[:, 6:10]))),
            "rate_rmse_radps": float(_rms(xp[:, 10:13] - xt[:, 10:13])),
            "windows": int(idx.shape[0]),
        }
    return out


def calibration(
    model: NeuralSDE,
    params: Dict[str, Any],
    t: np.ndarray,
    x: np.ndarray,
    u: np.ndarray,
    k: int = 10,
    num_particles: int = 128,
    levels: Sequence[float] = (0.5, 0.9),
    max_windows: int = 64,
    seed: int = 0,
    rng=None,
    device: Optional[torch.device | str] = None,
) -> Dict[str, Any]:
    """Ensemble calibration at k steps ahead (the original's ``:95-156``):
    P stochastic EM paths per window, the k-th step's truth scored against
    the per-dimension ensemble over the 9 Euclidean dims (``coverage[q]``:
    the fraction of (window, dim) pairs inside the central q-interval;
    ``spread_ratio``: the median over dims of ensemble std / RMS realized
    error). ``rng``: a ``torch.Generator`` (None: one seeded with
    ``seed``) that draws the (W, P, k, 13) block in one call, or an
    iterator whose next item is that block."""
    dev = resolve_device(device)
    model, params = _on(model, params, dev)
    k, P = int(k), int(num_particles)
    dt = float(np.median(np.diff(np.asarray(t, np.float64))))
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    u = torch.as_tensor(np.asarray(u, np.float32), device=dev)
    idx = torch.as_tensor(_windows(x.shape[0], k, max_windows), device=dev)
    W = int(idx.shape[0])
    if rng is None:
        rng = torch.Generator().manual_seed(int(seed))
    if isinstance(rng, torch.Generator):
        z = torch.randn((W, P, k, 13), generator=rng, dtype=torch.float32, device=rng.device)
    else:
        z = torch.as_tensor(next(rng), dtype=torch.float32)
    if tuple(z.shape) != (W, P, k, 13):
        raise ValueError(f"calibration: the Brownian block must be {(W, P, k, 13)}, "
                         f"got {tuple(z.shape)}")
    z = z.to(dev)
    ts = torch.full((k,), dt, dtype=torch.float32, device=dev)
    xs = x[idx][:, None, :].expand(W, P, 13)
    useq = u[idx[:, None] + torch.arange(k, device=dev)]               # (W, k, n_u)
    with torch.no_grad():
        for j in range(k):
            f, sig = drift_and_sigma(model, params, xs, useq[:, None, j])
            xs = _renorm_quat(xs + ts[j] * f + torch.sqrt(ts[j]) * sig * z[:, :, j])
    samples = xs[..., _EU]                                              # (W, P, 9)
    truth = x[idx + k][:, _EU]                                          # (W, 9)
    report: Dict[str, Any] = {"k": k, "horizon_s": round(k * dt, 4), "num_particles": P,
                              "windows": W, "coverage": {}}
    for q in levels:
        lo = torch.quantile(samples, 0.5 - q / 2, dim=1)
        hi = torch.quantile(samples, 0.5 + q / 2, dim=1)
        inside = (truth >= lo) & (truth <= hi)
        report["coverage"][f"{q:.2f}"] = float(torch.mean(inside.to(torch.float32)))
    spread = torch.std(samples, dim=1, correction=0)                    # (W, 9)
    err = torch.abs(truth - torch.mean(samples, dim=1))
    rms_err = torch.sqrt(torch.mean(err ** 2, dim=0))                   # (9,)
    rms_spread = torch.sqrt(torch.mean(spread ** 2, dim=0))
    report["spread_ratio"] = float(torch.median(rms_spread / (rms_err + 1e-9)))
    return report


def evaluate_model(
    model: NeuralSDE,
    params: Dict[str, Any],
    t: np.ndarray,
    x: np.ndarray,
    u: np.ndarray,
    ks: Sequence[int] = (1, 5, 10, 20),
    calib_k: int = 10,
    num_particles: int = 128,
    rng=None,
    device: Optional[torch.device | str] = None,
) -> Dict[str, Any]:
    """Full report: k-step errors + calibration (module docstring)."""
    return {
        "kstep": kstep_errors(model, params, t, x, u, ks=ks, device=device),
        "calibration": calibration(model, params, t, x, u, k=calib_k,
                                   num_particles=num_particles, rng=rng, device=device),
    }
