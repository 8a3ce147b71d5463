"""Port slice on the hexacopter, end to end on the CPU: the trajectory-tracking
golden replay. ``RecedingHorizonController`` on the shipped
``hexa_{traj,posctrl}_mpc.yaml`` replays ``replay_traj`` against the
committed ``tests/goldens/hexa_traj_flagship_trace.npz`` at the
cross-backend gates of ``bench.py:250`` (|du| <= 0.03, |dw| <= 0.08,
relative cost <= 0.02, pickup index exact)."""
import os

import numpy as np

from sde4mbrl_px4_tpu_torch.engine import goldens as G
from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController


def test_hexa_traj_replay_matches_golden(repo_root):
    c = RecedingHorizonController(
        os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"),
        os.path.join(repo_root, "configs/hexa_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0, device="cpu")
    tr, costs = G.replay_traj(c)
    assert np.all(np.isfinite(tr))
    assert np.all(tr[:, :6] >= 1e-4 - 1e-7) and np.all(tr[:, :6] <= 1.0 + 1e-7)
    res = G.compare_to_golden(tr, costs, os.path.join(
        G.golden_dir(repo_root), "hexa_traj_flagship_trace.npz"))
    assert res["ok"], res
    assert c.traj.solves == 6 and c.pos.solves == 0
    assert np.all(tr[:, 10] == 0)           # a fresh plan, picked at index 0
