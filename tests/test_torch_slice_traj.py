"""Port slice, end to end on the CPU: the iris trajectory-tracking golden
replay. ``RecedingHorizonController`` (flagship traj config: hover_diag
preconditioner, Barzilai-Borwein, 200-iteration budget) replays
``replay_traj`` against the committed
``tests/goldens/iris_traj_flagship_trace.npz`` at the cross-backend gates
of ``bench.py:250``."""
import os

import numpy as np

from sde4mbrl_px4_tpu_torch.engine import goldens as G
from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController


def test_traj_replay_matches_golden(repo_root):
    c = RecedingHorizonController(
        os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
        os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0)
    tr, costs = G.replay_traj(c)
    assert np.all(np.isfinite(tr))
    assert np.all(tr[:, :4] >= 1e-4 - 1e-7) and np.all(tr[:, :4] <= 1.0 + 1e-7)
    res = G.compare_to_golden(tr, costs, os.path.join(
        G.golden_dir(repo_root), "iris_traj_flagship_trace.npz"))
    assert res["ok"], res
    assert c.traj.solves == 6 and c.pos.solves == 0
    # steady receding-horizon ticks pick index 0 of a fresh plan
    assert np.all(tr[:, 10] == 0)
