"""Port slice on the hexacopter, end to end on the CPU: the 42-tick
engagement replay (none -> idle with trajectory pre-warm -> traj engaged
-> injected horizon overrun) against the committed
``tests/goldens/hexa_engagement_trace.npz``: modes and pickup indices
exact on every tick, commands and costs at the cross-backend gates of
``bench.py:250`` from ``goldens.ENGAGEMENT_GATED_FROM["hexa"]`` on.

The hexa replay's idle ticks publish unconverged 100-iteration pos plans,
and its first engaged ticks start from the idle pre-warms: there the
commands are fp-chaotic beyond the gates for any second implementation.
``test_jax_hexa_engagement_is_fp_chaotic`` shows it on the JAX package
itself: perturbing its states by 1e-6 relative moves its own commands past
the gates on the idle ticks, and not from the gated window on.

Marked ``slow``, as the iris one is: the port's full-budget solves run
through the plain PyTorch solver on the CPU (~7 min), the JAX replay ~4 min.
"""
import os

import numpy as np
import pytest

from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES as CS
from sde4mbrl_px4_tpu_torch.engine import goldens as G
from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController

FIRST = G.ENGAGEMENT_GATED_FROM["hexa"]


@pytest.mark.slow
def test_hexa_engagement_replay_matches_golden(repo_root):
    c = RecedingHorizonController(
        os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"),
        os.path.join(repo_root, "configs/hexa_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0, device="cpu")
    modes, tr, costs = G.replay_engagement(c)
    assert list(modes[:4]) == [CS["none"]] * 4
    assert list(modes[4:14]) == [CS["idle"]] * 10
    assert list(modes[14:]) == [CS["traj"]] * 28
    assert tr[14 + 20, -1] == c.traj.horizon - 1      # the injected overrun
    assert np.all(np.isfinite(tr))
    assert np.all(tr[:, :6] >= 1e-4 - 1e-7) and np.all(tr[:, :6] <= 1.0 + 1e-7)
    path = os.path.join(G.golden_dir(repo_root), "hexa_engagement_trace.npz")
    np.testing.assert_array_equal(modes.astype(np.float32), np.load(path)["modes"])
    res = G.compare_to_golden(tr, costs, path, first=FIRST)
    assert res["ok"], res


@pytest.mark.slow
def test_jax_hexa_engagement_is_fp_chaotic(repo_root):
    """The JAX package's own hexa engagement replay, its states perturbed by
    1e-6 relative (numpy seed 1): commands move past the 0.03 gate on the
    idle ticks, and hold every gate from the gated window on."""
    from sde4mbrl_px4_tpu.engine import goldens as JG
    from sde4mbrl_px4_tpu.engine.controller import RecedingHorizonController as JC

    c = JC(os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"),
           os.path.join(repo_root, "configs/hexa_posctrl_mpc.yaml"),
           seed=0, now_fn=lambda: 0.0)
    solve_once, rs = c.solve_once, np.random.RandomState(1)

    def perturbed(x, *args):
        x = np.asarray(x, np.float32)
        return solve_once(x * (1 + 1e-6 * rs.randn(13).astype(np.float32)), *args)

    c.solve_once = perturbed
    modes, tr, costs = JG.replay_engagement(c)
    path = os.path.join(G.golden_dir(repo_root), "hexa_engagement_trace.npz")
    du = np.abs(tr[:, :6] - np.load(path)["trace"][:, :6]).max(axis=1)
    idle = modes == CS["idle"]
    assert du[idle].max() > G.GATES["u"], du
    assert G.compare_to_golden(tr, costs, path, first=FIRST)["ok"]
