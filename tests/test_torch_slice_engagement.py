"""Port slice, end to end on the CPU: the 42-tick iris engagement replay
(none -> idle with trajectory pre-warm -> traj engaged -> injected horizon
overrun) against the committed ``tests/goldens/iris_engagement_trace.npz``
at the cross-backend gates of ``bench.py:250``.

Marked ``slow``: its 47 full-budget solves run through the plain PyTorch
solver on the CPU and took 283-343 s on an 8-core CPU, above the
60 s a tier-1 file may take."""
import os

import numpy as np
import pytest

from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES as CS
from sde4mbrl_px4_tpu_torch.engine import goldens as G
from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController


@pytest.mark.slow
def test_engagement_replay_matches_golden(repo_root):
    c = RecedingHorizonController(
        os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
        os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0, device="cpu")
    modes, tr, costs = G.replay_engagement(c)
    assert list(modes[:4]) == [CS["none"]] * 4
    assert list(modes[4:14]) == [CS["idle"]] * 10
    assert list(modes[14:]) == [CS["traj"]] * 28
    assert tr[14 + 20, -1] == c.traj.horizon - 1      # the injected overrun
    assert tr[-1, -1] == 0
    path = os.path.join(G.golden_dir(repo_root), "iris_engagement_trace.npz")
    np.testing.assert_array_equal(modes.astype(np.float32), np.load(path)["modes"])
    res = G.compare_to_golden(tr, costs, path)
    assert res["ok"], res
