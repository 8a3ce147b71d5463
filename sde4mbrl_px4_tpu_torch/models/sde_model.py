"""Neural-SDE vehicle dynamics on torch tensors (L1).

PyTorch counterpart of ``sde4mbrl_px4_tpu/models/sde_model.py``:

    dx = f(x, u) dt + Σ(x, u) dW

with drift ``f`` = rigid-body multirotor prior + a residual wrench from a
swish MLP trunk ((9+n_u) -> 64 -> 64 -> 12), and a diagonal diffusion on
the six velocity states from the same trunk's softplus head. Parameters
are the checkpoint's nested dict (``models/params_io.py``) with tensors in
place of numpy arrays. State: NED/FRD 13-vector; control: per-motor thrust.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.models.vehicles import VehicleConfig

__all__ = ["NeuralSDE", "init_params", "softplus", "trunk_apply", "sigma13",
           "drift_terms", "drift_and_sigma", "drift_fn", "diffusion_fn"]

_G = 9.81
_SPLIT = (3, 3, 4, 3)   # p, v, q, omega


class NeuralSDE(NamedTuple):
    """Static model description plus the vehicle constants as fp32 tensors
    on the model's device (built once, not per call)."""

    vehicle: VehicleConfig
    mixing: torch.Tensor      # (4, n_u)
    inertia: torch.Tensor     # (3,)

    @staticmethod
    def for_vehicle(vehicle: VehicleConfig,
                    device: torch.device | str = "cpu") -> "NeuralSDE":
        return NeuralSDE(
            vehicle=vehicle,
            mixing=torch.tensor(np.asarray(vehicle.mixing, np.float32), device=device),
            inertia=torch.tensor(np.asarray(vehicle.inertia, np.float32), device=device),
        )

    @property
    def n_u(self) -> int:
        return self.vehicle.n_motors

    @property
    def mass(self) -> float:
        return float(self.vehicle.mass)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) + log1p(exp(-|x|))`` — the form ``jax.nn.softplus`` takes
    (``torch.nn.functional.softplus`` switches to ``x`` above a threshold)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _e_z(like: torch.Tensor) -> torch.Tensor:
    """Unit z (NED down) shaped like the 3-vector ``like``."""
    return torch.cat([torch.zeros_like(like[..., :2]),
                      torch.ones_like(like[..., :1])], dim=-1)


def _feat(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Network input: body-frame velocity, rates, gravity direction in the
    body frame, motor commands."""
    _, v, q, om = x.split(_SPLIT, dim=-1)
    # rotate velocity and gravity direction in one call: (..., 2, 3)
    vg = torch.stack([v, _e_z(v)], dim=-2)
    v_body, g_body = quat.qrotate(quat.qconj(q)[..., None, :], vg).unbind(-2)
    u_b = torch.broadcast_to(u, x.shape[:-1] + (u.shape[-1],))
    return torch.cat([v_body, om, g_body, u_b], dim=-1)


def trunk_apply(params: Dict[str, Any], x: torch.Tensor, u: torch.Tensor):
    """Shared two-head network -> (residual wrench (...,6), sigma (...,6))."""
    h = _feat(x, u)
    net = params["net"]
    n_layers = sum(1 for k in net if k.startswith("w"))
    for i in range(n_layers):
        h = h @ net[f"w{i}"] + net[f"b{i}"]
        if i < n_layers - 1:
            h = h * torch.sigmoid(h)
    res, raw = h.split((6, 6), dim=-1)
    return res, softplus(raw) * torch.exp(params["diffusion_log_scale"])


def sigma13(x: torch.Tensor, sig6: torch.Tensor) -> torch.Tensor:
    """Expand the 6-dim velocity-state sigma to the full 13-dim diagonal."""
    s_v, s_w = sig6.split((3, 3), dim=-1)
    z = torch.zeros_like(s_w)
    return torch.cat([z, s_v, z, z[..., 0:1], s_w], dim=-1)


def drift_terms(model: NeuralSDE, params: Dict[str, Any], x: torch.Tensor,
                u: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """Physics-prior drift given the residual head output."""
    _, v, q, omega = x.split(_SPLIT, dim=-1)
    f_res, tau_res = res.split((3, 3), dim=-1)

    mix = model.mixing * torch.exp(params["motor"]["log_gain"])[:, None]
    u_b = torch.broadcast_to(u, x.shape[:-1] + (model.n_u,))
    wrench = u_b @ mix.T                      # fp32 (TF32 off: device policy)
    thrust, tau = wrench.split((1, 3), dim=-1)

    e_z = _e_z(v)
    f_body = f_res - thrust * e_z
    acc = _G * e_z + quat.qrotate(q, f_body) / model.mass

    J = model.inertia
    domega = (tau + tau_res - quat.cross(omega, J * omega)) / J

    return torch.cat([v, acc, quat.qmul_omega(q, omega), domega], dim=-1)


def drift_and_sigma(model: NeuralSDE, params: Dict[str, Any], x: torch.Tensor,
                    u: torch.Tensor):
    """Fused (drift, sigma13) evaluation — one trunk pass for both."""
    res, sig6 = trunk_apply(params, x, u)
    return drift_terms(model, params, x, u, res), sigma13(x, sig6)


def drift_fn(model: NeuralSDE, params: Dict[str, Any], x: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    res, _ = trunk_apply(params, x, u)
    return drift_terms(model, params, x, u, res)


def diffusion_fn(model: NeuralSDE, params: Dict[str, Any], x: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    _, sig6 = trunk_apply(params, x, u)
    return sigma13(x, sig6)


def init_params(generator: torch.Generator, model: NeuralSDE, hidden: int = 64,
                device: torch.device | str = "cpu") -> Dict[str, Any]:
    """Fresh parameters in the checkpoint layout (He init, near-zero last
    layer so the physics prior dominates). Drawn from ``generator`` on the
    CPU, so a seed gives the same weights on every device; the numbers
    differ from the JAX package's ``init_params`` (another generator)."""
    sizes = (9 + model.n_u, hidden, hidden, 12)
    net = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        s = 1e-3 if i == len(sizes) - 2 else float(np.sqrt(2.0 / fan_in))
        net[f"w{i}"] = (torch.randn(fan_in, fan_out, generator=generator) * s).to(device)
        net[f"b{i}"] = torch.zeros(fan_out, device=device)
    return {
        "motor": {"log_gain": torch.zeros(4, device=device)},
        "net": net,
        "diffusion_log_scale": torch.tensor(float(np.log(np.float32(0.1))),
                                            device=device),
    }
