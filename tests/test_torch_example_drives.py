"""Port, the drives of ``examples/constrained_mpc.py`` and
``examples/closed_loop_two_process.py`` on the CPU.

- ``sim/constrained_mpc.py --cpu``: the 3 m step with and without the
  velocity box (2 ticks at a 10-iteration budget), its ``RESULT: PASS``
  under the original's gate (v_c < v_u and v_c < 0.75 m/s);
- the step's first plans, both forms, in lockstep with JAX's
  ``make_mpc_from_config`` over the same 2 chained ticks (rtol 2e-4, atol
  2e-5; ``tests/test_sharding.py:87-88``);
- ``sim/closed_loop_two_process.py --cpu`` in pos mode: the engine node as
  its own launcher process, the FCU simulator here, a 1 m recovery and
  station keeping on an 8-step horizon of 0.15 s steps at a 4-iteration
  budget, in slow motion (``--time-scale 4``: the plain solves take ~0.1 s
  on the CPU), ``RESULT: PASS`` under the original's gate (mean error
  under 0.2 m from 3 s on, the FCU at ``MPC_ON``).
"""
import copy
import os

import jax
import numpy as np
import pytest
import yaml

from sde4mbrl_px4_tpu.core.frames import ned2enu as j_ned2enu
from sde4mbrl_px4_tpu.core.types import hover_state as j_hover
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu_torch.sim import closed_loop_two_process, constrained_mpc

RTOL, ATOL = 2e-4, 2e-5


def test_constrained_drive_passes_on_the_cpu(capsys):
    assert constrained_mpc.main(["--cpu", "--steps", "2", "--max-iter", "10"]) == 0
    out = capsys.readouterr().out
    assert "unconstrained: |v|max=" in out and "constrained:   |v|max=" in out
    assert out.strip().endswith("RESULT: PASS"), out


@pytest.mark.parametrize("constrained", [True, False])
def test_constrained_step_first_plans_match_jax(repo_root, constrained):
    cfg = j_load_yaml(constrained_mpc.CONFIG)
    if not constrained:
        cfg.pop("state_constr")
    cfg["apg_mpc"].update(max_iter=10, max_no_improvement_iter=10)
    port = constrained_mpc.fly(copy.deepcopy(cfg), 2, device="cpu")
    _, (reset_fn, mpc_fn), _, _ = j_make(copy.deepcopy(cfg))
    x = j_hover()
    xdes = j_ned2enu(j_hover().at[0].set(3.0))
    rng = jax.random.PRNGKey(0)
    st = reset_fn(x, rng, x)
    jm = jax.jit(mpc_fn)
    for plan in port["plans"]:
        u, st, rng, x_evol = jm(x, rng, st, 0.0, xdes)
        np.testing.assert_allclose(plan, np.asarray(u), rtol=RTOL, atol=ATOL)
        x = x_evol[1]


def test_two_process_drive_passes_on_the_cpu(repo_root, tmp_path, capsys):
    import socket

    def free_port():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    paths = []
    for traj in (True, False):
        cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
        cfg.update(horizon=8, num_short_dt=8, short_step_dt=0.15, long_step_dt=0.15,
                   learned_model_params=os.path.join(repo_root, "configs/models/iris_sde.pkl"))
        cfg["apg_mpc"].update(max_iter=4, max_no_improvement_iter=4)
        if traj:
            cfg["trajectory_path"] = os.path.join(repo_root, "configs/trajs/lemniscate.csv")
        p = tmp_path / f"{'traj' if traj else 'pos'}.yaml"
        p.write_text(yaml.safe_dump(cfg))
        paths.append(str(p))
    rc = closed_loop_two_process.main([
        "--cpu", "--seconds", "4", "--time-scale", "4", "--ready-timeout", "120",
        "--mav-port", str(free_port()), "--svc-port", str(free_port()),
        "--traj-config", paths[0], "--pos-config", paths[1]])
    out = capsys.readouterr().out
    assert rc == 0 and "RESULT: PASS" in out, out
    assert "pose mode: True" in out and "[launch] READY" in out, out
