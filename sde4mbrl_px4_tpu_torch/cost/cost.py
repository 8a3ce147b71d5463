"""MPC cost assembly on torch tensors (L3).

PyTorch counterpart of ``sde4mbrl_px4_tpu/cost/cost.py``
(``CostParams.from_config`` ``:85``, ``make_cost_fn`` ``:168-254``), for the
terms the iris flight configs use: quadratic tracking of position,
velocity, attitude error and body rate; control effort about ``uref``;
slew; the one-sided slew-rate box; the ``res_mult`` uncertainty penalty;
the geometric ``discount``. State constraints, proximal slack and the
``risk_lambda`` reduction are not ported yet: the loader refuses configs
that use them (``engine/mpc_loader.py``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat

__all__ = ["CostParams", "make_cost_fn"]


class CostParams(NamedTuple):
    uref: torch.Tensor            # (n_u,)
    uerr: float
    perr: torch.Tensor            # (3,)
    verr: torch.Tensor            # (3,)
    qerr: torch.Tensor            # (3,)
    werr: torch.Tensor            # (3,)
    res_mult: float
    u_slew_coeff: float
    u_slew_constr: Optional[torch.Tensor]   # (n_u, 2) [lo, hi] du/dt box, or None
    u_slew_constr_coeff: float
    discount: float

    @staticmethod
    def from_config(cfg: Dict[str, Any], n_u: int,
                    device: torch.device | str = "cpu") -> "CostParams":
        cp = cfg["cost_params"]

        def vec(v, n):
            a = np.broadcast_to(np.asarray(v, np.float32), (n,))
            return torch.tensor(a, device=device)

        def f32(v) -> float:
            return float(np.float32(v))

        slew_constr = cp.get("u_slew_constr")
        return CostParams(
            uref=vec(cp["uref"], n_u),
            uerr=f32(cp.get("uerr", 0.0)),
            perr=vec(cp.get("perr", 0.0), 3),
            verr=vec(cp.get("verr", 0.0), 3),
            qerr=vec(cp.get("qerr", 0.0), 3),
            werr=vec(cp.get("werr", 0.0), 3),
            res_mult=f32(cp.get("res_mult", 0.0)),
            u_slew_coeff=f32(cp.get("u_slew_coeff", 0.0)),
            u_slew_constr=(None if slew_constr is None else torch.tensor(
                np.asarray(slew_constr, np.float32), device=device)),
            u_slew_constr_coeff=f32(cp.get("u_slew_constr_coeff", 0.0)),
            discount=f32(cfg.get("discount", 1.0)),
        )


def discount_vector(cp: CostParams, H: int, device) -> torch.Tensor:
    """``discount ** [1..H]`` in fp32 (the original's ``disc``)."""
    return torch.tensor(cp.discount, dtype=torch.float32, device=device) ** \
        torch.arange(1, H + 1, dtype=torch.float32, device=device)


def _stage_tracking(cp: CostParams, x: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
    p, v, q, w = x.split((3, 3, 4, 3), dim=-1)
    pr, vr, qr, wr = x_ref.split((3, 3, 4, 3), dim=-1)
    dp, dv, dw = p - pr, v - vr, w - wr
    dq = quat.qerr_vec(q, qr)
    return (torch.sum(cp.perr * dp * dp, -1) + torch.sum(cp.verr * dv * dv, -1)
            + torch.sum(cp.qerr * dq * dq, -1) + torch.sum(cp.werr * dw * dw, -1))


def make_cost_fn(cp: CostParams, time_steps: torch.Tensor):
    """``cost(x_paths, sigma_paths, u_seq, x_ref, u_prev) -> scalar``.

    ``x_paths`` (P, H+1, 13) or (H+1, 13); ``sigma_paths`` (P, H, 13) or
    None; ``u_seq`` (H, n_u); ``x_ref`` (H+1, 13); ``u_prev`` (n_u,) or None
    (then ``uref``). Particles reduce by mean.
    """
    H = int(time_steps.shape[0])
    disc = discount_vector(cp, H, time_steps.device)

    def cost_fn(x_paths, sigma_paths, u_seq, x_ref, u_prev=None):
        if x_paths.dim() == 2:
            x_paths = x_paths[None]
        track = _stage_tracking(cp, x_paths[:, 1:, :], x_ref[None, 1:, :])   # (P, H)
        j_track = torch.mean(torch.sum(disc * track, dim=-1))

        du = u_seq - cp.uref
        j_u = cp.uerr * torch.sum(disc[:, None] * du * du)

        up = cp.uref if u_prev is None else u_prev
        slew = torch.diff(torch.cat([up[None, :], u_seq], dim=0), dim=0)    # (H, n_u)
        j = j_track + j_u + cp.u_slew_coeff * torch.sum(slew * slew)

        if cp.u_slew_constr is not None:
            rate = slew / time_steps[:, None]
            lo, hi = cp.u_slew_constr[:, 0], cp.u_slew_constr[:, 1]
            viol = (torch.clamp(rate - hi, min=0.0) ** 2
                    + torch.clamp(lo - rate, min=0.0) ** 2)
            j = j + cp.u_slew_constr_coeff * torch.sum(viol)

        if sigma_paths is not None:
            if sigma_paths.dim() == 2:
                sigma_paths = sigma_paths[None]
            res_p = cp.res_mult * torch.sum(
                disc * torch.sum(sigma_paths * sigma_paths, -1), dim=-1)     # (P,)
            j = j + torch.mean(res_p)
        return j

    return cost_fn
