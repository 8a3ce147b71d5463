"""The whole-solve kernel's ABI: one flat fp32 consts buffer plus an
argument struct of dimensions, options, offsets and config scalars.

Port of ``sde4mbrl_px4_tpu/ops/pallas/solve_kernels.py::build_consts``
(``:71-184``, K7): the constants every sweep of the solve reads (initial
state, the horizon of reference states, the previous control, the trunk
weights, the effective mixer, inertia, per-step dt and discount, cost
weights and scalars, the input box). :class:`ApgArgs` mirrors
``csrc/apg_solve.cuh::ApgArgs`` field for field; the library's
``apg_args_size()`` is checked against it when it is loaded.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from sde4mbrl_px4_tpu_torch.cost.cost import CostParams, discount_vector
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
from sde4mbrl_px4_tpu_torch.solver.apg import APGConfig, df_powers

__all__ = ["APG_MAXK", "ApgArgs", "build_consts"]

APG_MAXK = 8  # csrc/apg_solve.cuh

_INT_FIELDS = (
    "H", "n_u", "nZ", "K", "F", "HID", "OUT",
    "max_iter", "max_no_imp", "budget", "has_budget", "has_pre", "has_slew",
    "reset_opt", "mom_restart", "has_moment_scale",
    "o_x0", "o_xref", "o_uprev", "o_w0", "o_b0", "o_w1", "o_b1", "o_w2",
    "o_b2", "o_mix", "o_inertia", "o_ts", "o_disc", "o_wstate", "o_uref",
    "o_slo", "o_shi", "o_scal", "o_lb", "o_ub", "n_consts",
)
_FLOAT_FIELDS = ("inc", "one_m_coef", "tmax", "beta_init", "moment_scale",
                 "atol", "rtol")
_RESET = {"increase": 0, "conservative": 1, "bb": 2}


class ApgArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in _INT_FIELDS]
                + [(n, ctypes.c_float) for n in _FLOAT_FIELDS]
                + [("dfp", ctypes.c_float * (APG_MAXK + 1))])


def build_consts(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                 apg: APGConfig, time_steps: torch.Tensor, x0: torch.Tensor,
                 x_ref: torch.Tensor, u_prev: torch.Tensor, lb: torch.Tensor,
                 ub: torch.Tensor, has_pre: bool = False,
                 iter_budget: Optional[int] = None) -> Tuple[torch.Tensor, ApgArgs]:
    """Pack the consts buffer on the tensors' device (one ``torch.cat``, no
    host sync) and fill the argument struct."""
    if apg.maxls > APG_MAXK:
        raise ValueError(f"maxls={apg.maxls} exceeds the kernel's {APG_MAXK}")
    f32 = torch.float32
    H = int(time_steps.shape[0])
    n = model.n_u
    net = params["net"]
    HID, OUT = int(net["w1"].shape[0]), int(net["w2"].shape[1])
    mix_eff = model.mixing * torch.exp(params["motor"]["log_gain"])[:, None]
    wstate = torch.cat([cp.perr, cp.verr, cp.qerr, cp.werr])
    if cp.u_slew_constr is not None:
        slo, shi = cp.u_slew_constr[:, 0], cp.u_slew_constr[:, 1]
    else:
        slo = shi = torch.zeros(n, dtype=f32, device=x0.device)
    host = torch.tensor([model.mass, cp.uerr, cp.u_slew_coeff,
                         cp.u_slew_constr_coeff, cp.res_mult],
                        dtype=f32, device=x0.device)
    scal = torch.cat([host[:1], torch.exp(params["diffusion_log_scale"]).reshape(1),
                      host[1:]])
    pieces = (
        ("x0", x0), ("xref", x_ref), ("uprev", u_prev[:n]),
        ("w0", net["w0"]), ("b0", net["b0"]), ("w1", net["w1"]),
        ("b1", net["b1"]), ("w2", net["w2"]), ("b2", net["b2"]),
        ("mix", mix_eff), ("inertia", model.inertia), ("ts", time_steps),
        ("disc", discount_vector(cp, H, x0.device)), ("wstate", wstate),
        ("uref", cp.uref), ("slo", slo), ("shi", shi), ("scal", scal),
        ("lb", lb), ("ub", ub),
    )
    a = ApgArgs()
    off = 0
    flat = []
    for name, t in pieces:
        setattr(a, f"o_{name}", off)
        t = t.reshape(-1).to(f32)
        flat.append(t)
        off += t.numel()
    a.n_consts = off
    buf = torch.cat(flat)

    a.H, a.n_u, a.nZ, a.K = H, n, n, int(apg.maxls)
    a.F, a.HID, a.OUT = int(net["w0"].shape[0]), HID, OUT
    a.max_iter = int(apg.max_iter)
    a.max_no_imp = int(apg.max_no_improvement_iter)
    a.has_budget = int(iter_budget is not None)
    a.budget = 0 if iter_budget is None else int(iter_budget)
    a.has_pre = int(has_pre)
    a.has_slew = int(cp.u_slew_constr is not None)
    a.reset_opt = _RESET.get(apg.reset_option, 1)   # unknown -> conservative
    a.mom_restart = int(apg.momentum_restart)
    a.has_moment_scale = int(apg.moment_scale is not None)
    a.inc = apg.increase_factor
    a.one_m_coef = 1.0 - apg.coef
    a.tmax = apg.max_stepsize
    a.beta_init = apg.beta_init
    a.moment_scale = 0.0 if apg.moment_scale is None else apg.moment_scale
    a.atol, a.rtol = apg.atol, apg.rtol
    for k, v in enumerate(df_powers(apg)):
        a.dfp[k] = v
    return buf, a
