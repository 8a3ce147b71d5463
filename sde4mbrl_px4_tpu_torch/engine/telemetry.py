"""Solver observability record (L5).

Copied from ``sde4mbrl_px4_tpu/engine/telemetry.py`` (pure Python): the
port may not import the JAX package, whose ``__init__`` imports JAX.

Field-for-field equivalent of the reference's telemetry message
``msg/OptMPCState.msg`` (published at 5 Hz, ``sde_control.py:564-585``):
per-solve APG statistics (linesearch/stepsize averages, gradient norm,
initial vs optimal cost, iteration count), wall-clock timings of the solve
and the ingress callback, the automata state, and the plan index served.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict

from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATE_NAMES

__all__ = ["OptMPCStateRecord"]


@dataclasses.dataclass
class OptMPCStateRecord:
    stamp: float = 0.0            # seconds (reference: ROS time)
    avg_linesearch: float = 0.0
    avg_stepsize: float = 0.0
    stepsize: float = 0.0
    grad_norm: float = 0.0
    cost_init: float = 0.0
    opt_cost: float = 0.0
    num_steps: int = 0
    solve_time: float = 0.0
    callback_dt: float = 0.0
    state_dt: float = 0.0
    ctrl_state: str = "none"
    mpc_indx: int = 0

    @staticmethod
    def from_opt_state(opt_state, solve_time: float, callback_dt: float,
                       state_dt: float, ctrl_state: int, mpc_indx: int) -> "OptMPCStateRecord":
        return OptMPCStateRecord(
            stamp=time.time(),
            avg_linesearch=float(opt_state.avg_linesearch),
            avg_stepsize=float(opt_state.avg_stepsize),
            stepsize=float(opt_state.stepsize),
            grad_norm=float(opt_state.grad_sqr),
            cost_init=float(opt_state.init_cost),
            opt_cost=float(opt_state.opt_cost),
            num_steps=int(opt_state.num_steps),
            solve_time=solve_time,
            callback_dt=callback_dt,
            state_dt=state_dt,
            ctrl_state=CONTROL_STATE_NAMES.get(int(ctrl_state), "none"),
            mpc_indx=mpc_indx,
        )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
