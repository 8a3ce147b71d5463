"""Neural-SDE vehicle dynamics on torch tensors (L1).

PyTorch counterpart of ``sde4mbrl_px4_tpu/models/sde_model.py``:

    dx = f(x, u) dt + Σ(x, u) dW

with drift ``f`` = rigid-body multirotor prior + a residual wrench from a
swish MLP trunk ((9+n_u) -> 64 -> 64 -> 12), and a diagonal diffusion on
the six velocity states from the same trunk's softplus head. Parameters
are the checkpoint's nested dict (``models/params_io.py``) with tensors in
place of numpy arrays. State: NED/FRD 13-vector; control: per-motor thrust.

``matmul_precision`` (:func:`resolve_precision`): at the JAX package's
``default`` the TPU runs the trunk's three products on bf16 inputs with
fp32 accumulation. ``trunk_apply(..., bf16=True)`` computes that function
(:class:`Bf16Matmul`); everything else stays fp32.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.models.vehicles import VehicleConfig

__all__ = ["NeuralSDE", "Bf16Matmul", "init_params", "resolve_precision", "round_bf16",
           "softplus", "trunk_apply", "sigma13", "drift_terms", "drift_and_sigma",
           "drift_fn", "diffusion_fn"]

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


# copied from sde4mbrl_px4_tpu/models/sde_model.py:53-67 (resolve_precision's
# table and error text); True is the TPU's DEFAULT (bf16 inputs), False HIGHEST
_PRECISION = {None: False, "highest": False, "float32": False,
              "default": True, "bf16": True, "bfloat16": True}


def resolve_precision(name) -> bool:
    """Whether a ``matmul_precision`` name is the JAX package's DEFAULT (on
    its TPU, the trunk's products on bf16 inputs with fp32 accumulation)
    rather than HIGHEST; the original's names, and its ``ValueError`` for
    any other."""
    key = name if name is None else str(name).lower()
    if key not in _PRECISION:
        raise ValueError(
            f"matmul_precision {name!r} not recognized; use one of "
            "highest/float32 (f32 multi-pass) or default/bf16/bfloat16 "
            "(bf16-input MXU path)"
        )
    return _PRECISION[key]


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest, ties to even) and back to fp32."""
    return t.to(torch.bfloat16).to(torch.float32)


class Bf16Matmul(torch.autograd.Function):
    """``h @ w`` on bf16-rounded operands with fp32 sums, the TPU's DEFAULT
    dot, and its transpose rule: the backward's two products round their
    operands too (``rnd(g) @ rnd(w).T``, ``rnd(h).T @ rnd(g)``), as JAX's
    transposed dots keep the forward's precision. Autograd through the
    rounding itself would round the backward's results instead."""

    generate_vmap_rule = True

    @staticmethod
    def forward(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return round_bf16(h) @ round_bf16(w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, w = ctx.saved_tensors
        g = round_bf16(g)
        gh = g @ round_bf16(w).T if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = round_bf16(h).reshape(-1, h.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gh, gw


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


def trunk_apply(params: Dict[str, Any], x: torch.Tensor, u: torch.Tensor,
                bf16: bool = False):
    """Shared two-head network -> (residual wrench (...,6), sigma (...,6));
    ``bf16``: the products on bf16-rounded operands (:class:`Bf16Matmul`)."""
    h = _feat(x, u)
    net = params["net"]
    n_layers = sum(1 for k in net if k.startswith("w"))
    for i in range(n_layers):
        w = net[f"w{i}"]
        h = (Bf16Matmul.apply(h, w) if bf16 else h @ w) + net[f"b{i}"]
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
                    u: torch.Tensor, bf16: bool = False):
    """Fused (drift, sigma13) evaluation — one trunk pass for both
    (``bf16``: :func:`trunk_apply`'s)."""
    res, sig6 = trunk_apply(params, x, u, bf16)
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
