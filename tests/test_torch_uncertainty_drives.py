"""The two uncertainty drives of the port on the CPU, at a tiny size:
``sim/uncertainty.py`` (the five variants of ``examples/uncertainty_mpc.py``
at P=8, 3 iterations) and ``sim/noise_robustness.py`` (its three
controllers flown for 3 ticks on the noisy plant at P=8, 3 iterations).
Both run the plain versions here; on the card they are ``chip_smoke.py``'s
phase 23. Their numbers are not held to the examples' (those are the
card's, at full size): the tests hold what the drives compute."""
import copy
import math
import os

import numpy as np
import pytest


def test_uncertainty_drive_runs_every_variant():
    from sde4mbrl_px4_tpu_torch.sim import uncertainty as U

    res = U.run(particles=8, device="cpu", max_iter=3)
    assert list(res) == [label for label, _, _ in U.VARIANTS]
    for r in res.values():
        assert r["steps"] == 3 and np.isfinite([r["ms"], r["opt_cost"], r["mean_du"]]).all()
    # the high-noise model pays more uncertainty penalty than the low-noise one
    assert res["high-noise"]["opt_cost"] > res["low-noise"]["opt_cost"]
    assert U.parser().parse_args([]).particles == 1024


def test_noise_robustness_fly_and_options(repo_root):
    """``fly`` for the three controllers (3 ticks, P=8, max_iter 3) on the
    same plant noise: finite readings; the mean controller's first tick
    matches a re-run (common random numbers); the CLI's defaults are the
    example's."""
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.sim import noise_robustness as NR

    args = NR.parser().parse_args([])
    assert (args.seconds, args.particles, args.noise_scale, args.seeds) == (12.0, 128, 0.6, 3)
    base = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    base["apg_mpc"].update(max_iter=3, max_no_improvement_iter=3)
    base["state_constr"] = {"state_id": [2], "state_bound": [[-5.0, NR.FLOOR_Z]],
                            "state_penalty": [300.0], "slack_scaling": [1.0]}
    params, _ = load_params(base["learned_model_params"])
    plant = dict(params, diffusion_log_scale=np.float32(math.log(0.6)))
    rows = []
    for mut in ({}, {"num_particles": 8, "antithetic": True},
                {"num_particles": 8, "antithetic": True,
                 "cost_params": dict(base["cost_params"], risk_lambda=2.0)}):
        cfg = dict(copy.deepcopy(base), **mut)
        rows.append(NR.fly(cfg, plant, 0.6, 0.15, 0, "tiny", device="cpu"))
    assert np.isfinite(rows).all() and all(0.0 <= r[1] <= 1.0 for r in rows)
    again = NR.fly(dict(copy.deepcopy(base)), plant, 0.6, 0.15, 0, "tiny", device="cpu")
    assert again[:3] == pytest.approx(rows[0][:3], rel=0, abs=0)
