"""MPC cost assembly on torch tensors (L3).

PyTorch counterpart of ``sde4mbrl_px4_tpu/cost/cost.py``
(``CostParams.from_config`` ``:85``, ``make_cost_fn`` ``:168-254``), for the
terms the iris flight configs use: quadratic tracking of position,
velocity, attitude error and body rate; control effort about ``uref``;
slew; the one-sided slew-rate box; the ``res_mult`` uncertainty penalty;
the geometric ``discount``; and the ``state_constr`` block in both forms
(``:59-82``, ``:187-207``): the penalty form (one-sided quadratic box
penalties over the 13 states, relaxed by ``constr_pen``) and the
proximal-slack form (``slack_proximal: True``: one slack-target column per
constrained state in the decision sequence, coupled to the state at full
``state_penalty`` weight). ``cost_params.risk_lambda`` (``:53``,
``:213-229``) is the risk-sensitive particle reduction: at P > 1 the
particles' discounted totals ``tot_p`` (tracking, constraint terms and the
uncertainty penalty) enter as ``mean + risk_lambda * sqrt(var + 1e-12)``,
the population variance taken about the mean (centred first).

Over a sharded particle axis (``parallel/batched.py::
make_particle_sharded_mpc``) each process holds an equal block of the P
particles. :func:`make_risk_moments_fn` gives a block's
``(f, m, v)``: its cost without the risk term, the mean of its totals and
their centred second moment; :func:`combine_risk_moments` combines the
blocks' triples in block order into the cost over all P (Chan's formula
for equal blocks, algebraically the one-process centred variance; no
one-pass sum of squares, which cancels when the spread is small against the
mean), and into the mean and std the gradient needs;
:func:`make_risk_surrogate_fn` takes them back and gives a surrogate whose
gradient over the block is the block's share of the risk cost's.

The tracking weights ``perr``/``verr``/``qerr``/``werr`` may carry a
leading (B,) axis, one row per scenario of a batched solve (the tuner's
candidates, ``tuning/tuner.py``): :func:`scenario_cost` is scenario b's
cost, which the plain batched solvers take one scenario at a time, and
:func:`tracking_weights` the (B, 12) rows the kernels read from their
scenario's consts (``ops/cuda/consts.py::batch_consts``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat

__all__ = ["TRACKING_FIELDS", "CostParams", "combine_risk_moments", "make_cost_fn",
           "make_risk_moments_fn", "make_risk_surrogate_fn", "scenario_cost",
           "tracking_weights"]

# the stage-tracking weights, in the order the kernels' wstate block holds them
TRACKING_FIELDS = ("perr", "verr", "qerr", "werr")


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
    # penalty form of ``state_constr`` (``slack_proximal`` false): densified
    # over the 13 states, weight 0 off
    state_pen13: Optional[torch.Tensor] = None       # (13,)
    state_lo13: Optional[torch.Tensor] = None        # (13,) -1e9 pad
    state_hi13: Optional[torch.Tensor] = None        # (13,) +1e9 pad
    state_inv_scale13: Optional[torch.Tensor] = None  # (13,) 1/slack_scaling
    constr_pen: float = 0.0
    # mean + risk_lambda * std of the particles' discounted totals (None: the
    # mean; original :49-54, coerced as at :139-140)
    risk_lambda: Optional[float] = None
    # proximal-slack form: m slack-target columns past n_u in the decision
    # sequence, box-projected to [slack_lo, slack_hi] by the solver
    slack_pen: Optional[torch.Tensor] = None         # (m,) state_penalty
    slack_inv_scale: Optional[torch.Tensor] = None   # (m,) 1/slack_scaling
    slack_sel: Optional[torch.Tensor] = None         # (m, 13) one-hot selector
    slack_lo: Optional[torch.Tensor] = None          # (m,)
    slack_hi: Optional[torch.Tensor] = None          # (m,)

    @property
    def n_slack(self) -> int:
        """m, the slack columns of the proximal form (0 otherwise)."""
        return 0 if self.slack_sel is None else int(self.slack_sel.shape[0])

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
        sc = {}
        blk = cfg.get("state_constr")
        if blk is not None:
            ids = list(blk["state_id"])
            m = len(ids)
            pen_m = np.asarray(blk["state_penalty"], np.float32)
            b = np.asarray(blk["state_bound"], np.float32)
            inv_m = 1.0 / np.asarray(blk.get("slack_scaling", np.ones(m)), np.float32)
            t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
            if blk.get("slack_proximal"):
                sel = np.zeros((m, 13), np.float32)
                sel[np.arange(m), ids] = 1.0
                sc = dict(slack_pen=t(pen_m), slack_inv_scale=t(inv_m), slack_sel=t(sel),
                          slack_lo=t(b[:, 0]), slack_hi=t(b[:, 1]))
            else:
                pen = np.zeros(13, np.float32)
                lo = np.full(13, -1e9, np.float32)
                hi = np.full(13, 1e9, np.float32)
                inv = np.ones(13, np.float32)
                pen[ids], lo[ids], hi[ids], inv[ids] = pen_m, b[:, 0], b[:, 1], inv_m
                sc = dict(state_pen13=t(pen), state_lo13=t(lo), state_hi13=t(hi),
                          state_inv_scale13=t(inv),
                          constr_pen=f32(blk.get("constr_pen", 1.0)))
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
            risk_lambda=f32(cp["risk_lambda"]) if cp.get("risk_lambda") else None,
            **sc,
        )


def tracking_weights(cp: CostParams) -> torch.Tensor:
    """The tracking weights as the kernels' wstate block: (12,), or (B, 12)
    where they carry a scenario axis."""
    return torch.cat([getattr(cp, k) for k in TRACKING_FIELDS], dim=-1)


def scenario_cost(cp: CostParams, b: int) -> CostParams:
    """Scenario ``b``'s cost: ``cp`` with its tracking weights' row b where
    they carry a scenario axis, else ``cp`` itself."""
    if cp.perr.dim() == 1:
        return cp
    return cp._replace(**{k: getattr(cp, k)[b] for k in TRACKING_FIELDS})


def discount_vector(cp: CostParams, H: int, device) -> torch.Tensor:
    """``discount ** [1..H]`` in fp32 (the original's ``disc``)."""
    return torch.full((), cp.discount, dtype=torch.float32, device=device) ** \
        torch.arange(1, H + 1, dtype=torch.float32, device=device)


def _stage_tracking(cp: CostParams, x: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
    p, v, q, w = x.split((3, 3, 4, 3), dim=-1)
    pr, vr, qr, wr = x_ref.split((3, 3, 4, 3), dim=-1)
    dp, dv, dw = p - pr, v - vr, w - wr
    dq = quat.qerr_vec(q, qr)
    return (torch.sum(cp.perr * dp * dp, -1) + torch.sum(cp.verr * dv * dv, -1)
            + torch.sum(cp.qerr * dq * dq, -1) + torch.sum(cp.werr * dw * dw, -1))


def make_cost_fn(cp: CostParams, time_steps: torch.Tensor):
    """``cost(x_paths, sigma_paths, u_seq, x_ref, u_prev, s_seq) -> scalar``.

    ``x_paths`` (P, H+1, 13) or (H+1, 13); ``sigma_paths`` (P, H, 13) or
    None; ``u_seq`` (H, n_u); ``x_ref`` (H+1, 13); ``u_prev`` (n_u,) or None
    (then ``uref``); ``s_seq`` (H, m) the proximal slack targets (the
    caller splits the decision sequence). Particles reduce by mean, plus
    ``risk_lambda`` times the std of their totals where it is set and P > 1
    (original ``:213-229``). The state-constraint terms join the stage cost
    in the original's order (prox coupling, then the penalty form's
    ``constr_pen * viol``).
    """
    body = _cost_body(cp, time_steps, with_risk=True)
    return lambda *a, **kw: body(*a, **kw)[0]


def make_risk_moments_fn(cp: CostParams, time_steps: torch.Tensor):
    """A block of particles' ``(f, m, v)`` (3,) for a cost with
    ``risk_lambda`` (module docstring): :func:`make_cost_fn`'s arguments
    (P > 1), the cost without the risk term and the mean and centred second
    moment of the particles' totals."""
    body = _risk_body(cp, time_steps)

    def moments_fn(*a, **kw):
        j, tot_p = body(*a, **kw)
        m = torch.mean(tot_p)
        return torch.stack([j, m, torch.mean((tot_p - m) ** 2)])

    return moments_fn


def make_risk_surrogate_fn(cp: CostParams, time_steps: torch.Tensor):
    """``surrogate(x_paths, sigma_paths, u_seq, x_ref, u_prev, s_seq,
    moments) -> (f, f + risk_lambda * mean((tot - m)**2) / (2 sd))`` (2,),
    ``moments`` (2,) the mean m and std sd of the totals over all particles
    (module docstring). With m and sd held, the second entry's gradient is
    ``mean_p((1 + risk_lambda (tot_p - m) / sd) dtot_p)`` plus the control
    terms' (the ``dm`` term vanishes: the deviations sum to 0 over all
    particles)."""
    body = _risk_body(cp, time_steps)

    def surrogate_fn(x_paths, sigma_paths, u_seq, x_ref, u_prev, s_seq, moments):
        j, tot_p = body(x_paths, sigma_paths, u_seq, x_ref, u_prev, s_seq)
        m, sd = moments[0], moments[1]
        return torch.stack([j, j + cp.risk_lambda * torch.mean((tot_p - m) ** 2) / (2 * sd)])

    return surrogate_fn


def _risk_body(cp: CostParams, time_steps: torch.Tensor):
    """:func:`_cost_body` without the risk term, for a cost with
    ``risk_lambda``; its totals must have P > 1 particles."""
    if cp.risk_lambda is None:
        raise ValueError("the risk moments need a cost with risk_lambda")
    body = _cost_body(cp, time_steps, with_risk=False)

    def risk_body(*a, **kw):
        j, tot_p = body(*a, **kw)
        if tot_p is None:
            raise ValueError("the risk moments need the particles of a Monte-Carlo cost "
                             "(P > 1)")
        return j, tot_p

    return risk_body


def _cost_body(cp: CostParams, time_steps: torch.Tensor, with_risk: bool):
    """``(j, tot_p)``: :func:`make_cost_fn`'s cost, its risk term only
    ``with_risk``, and the particles' totals where ``risk_lambda`` is set
    and P > 1 (else None)."""
    H = int(time_steps.shape[0])
    disc = discount_vector(cp, H, time_steps.device)

    def cost_fn(x_paths, sigma_paths, u_seq, x_ref, u_prev=None, s_seq=None):
        if x_paths.dim() == 2:
            x_paths = x_paths[None]
        xs = x_paths[:, 1:, :]
        track = _stage_tracking(cp, xs, x_ref[None, 1:, :])                 # (P, H)
        if cp.slack_sel is not None and s_seq is not None:
            x_sel = xs @ cp.slack_sel.t()                                    # (P, H, m)
            dsl = (x_sel - s_seq[None]) * cp.slack_inv_scale
            track = track + torch.sum(cp.slack_pen * dsl * dsl, -1)
        if cp.state_pen13 is not None:
            over = torch.clamp(xs - cp.state_hi13, min=0.0) * cp.state_inv_scale13
            under = torch.clamp(cp.state_lo13 - xs, min=0.0) * cp.state_inv_scale13
            viol = torch.sum(cp.state_pen13 * (over * over + under * under), -1)
            track = track + cp.constr_pen * viol
        res_p = None
        if sigma_paths is not None:
            if sigma_paths.dim() == 2:
                sigma_paths = sigma_paths[None]
            res_p = cp.res_mult * torch.sum(
                disc * torch.sum(sigma_paths * sigma_paths, -1), dim=-1)     # (P,)
        tr_p = torch.sum(disc * track, dim=-1)                               # (P,)
        j_track = torch.mean(tr_p)
        tot_p = None
        if cp.risk_lambda is not None and tr_p.shape[0] > 1:
            tot_p = tr_p if res_p is None else tr_p + res_p
            if with_risk:
                var = torch.mean((tot_p - torch.mean(tot_p)) ** 2)
                j_track = j_track + cp.risk_lambda * torch.sqrt(var + 1e-12)

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

        if res_p is not None:
            j = j + torch.mean(res_p)
        return j, tot_p

    return cost_fn


def combine_risk_moments(parts: torch.Tensor, risk_lambda: float):
    """The risk cost over all particles from equal blocks of them: ``parts``
    (R, ..., 3), block r's ``(f_r, m_r, v_r)`` (:func:`make_risk_moments_fn`)
    in block order. Returns ``(value, m, sd)`` (...):
    ``m = mean_r m_r``, ``var = mean_r (v_r + (m_r - m)**2)`` (Chan's
    formula for blocks of equal size), ``sd = sqrt(var + 1e-12)`` and
    ``value = mean_r f_r + risk_lambda * sd``; every mean sums in block
    order, so every process that holds the same ``parts`` gets the same
    bits."""
    def mean(x):
        acc = x[0]
        for r in range(1, int(x.shape[0])):
            acc = acc + x[r]
        return acc / int(x.shape[0])

    f, m_r, v_r = parts.unbind(-1)
    m = mean(m_r)
    sd = torch.sqrt(mean(v_r + (m_r - m) ** 2) + 1e-12)
    return mean(f) + risk_lambda * sd, m, sd
