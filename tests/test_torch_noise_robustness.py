"""Port parity, what the SDE in neural-SDE MPC buys: the twin of
``tests/test_noise_robustness.py:69`` on the port's plain path (CPU). On
``iris_posctrl_mpc.yaml`` with the altitude floor as a penalty
``state_constr`` (NED z <= -1.2) and the model's diffusion scaled to 0.6,
one solve held 5 cm above the floor: the particle planner (P=32
antithetic) and the risk-averse one (``risk_lambda: 2``) plan their
terminal altitude at least 0.01 m above the mean planner's, which parks at
the reference. Draws from a torch generator (the property, not the bits,
is held)."""
import copy
import os
import tempfile

import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config


@pytest.fixture(scope="module")
def floor_cfg(repo_root):
    """``tests/test_noise_robustness.py``'s problem: posctrl with the altitude
    floor as a penalty ``state_constr`` and the model's diffusion at 0.6."""
    from sde4mbrl_px4_tpu.models.params_io import load_params, save_params

    cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg["apg_mpc"].update(max_iter=60, max_no_improvement_iter=60)
    cfg["state_constr"] = {"state_id": [2], "state_bound": [[-5.0, -1.2]],
                           "state_penalty": [300.0], "slack_scaling": [1.0]}
    params, meta = load_params(cfg["learned_model_params"])
    params = dict(params)
    params["diffusion_log_scale"] = np.float32(np.log(0.6))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "iris_sde_noisy.pkl")
        save_params(path, params, meta)
        cfg["learned_model_params"] = path
        yield cfg


def _terminal_z(cfg):
    """The steady tail of the planned mean trajectory of one solve held 5 cm
    above the floor (NED z of the last 5 rows of ``x_evol``)."""
    from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import hover_state

    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    tgt = hover_state()
    tgt[2] = -1.25
    tgt_enu = ned2enu(tgt)
    gen = torch.Generator().manual_seed(0)
    sol = mpc_fn(tgt, gen, reset_fn(tgt, gen, tgt_enu), 0.0, tgt_enu)
    return float(sol.x_evol[-5:, 2].mean())


def test_risk_backs_off_the_floor(floor_cfg):
    """The particle planner and the risk-averse one plan their terminal
    altitude at least 0.01 m above (more negative NED z than) the mean
    planner."""
    z_mean = _terminal_z(floor_cfg)
    cfg_p = dict(floor_cfg, num_particles=32, antithetic=True)
    z_part = _terminal_z(cfg_p)
    assert z_part < z_mean - 0.01, (z_part, z_mean)
    cfg_r = dict(cfg_p, cost_params=dict(cfg_p["cost_params"], risk_lambda=2.0))
    z_risk = _terminal_z(cfg_r)
    assert z_risk < z_mean - 0.01, (z_risk, z_mean)
