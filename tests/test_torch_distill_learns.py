"""Port, policy distillation end to end on the CPU (the port alone):

- the twin of ``tests/test_distill.py::test_distillation_learns_expert``:
  sample -> converged-APG labels -> train; the trained policy cuts the
  supervised loss and beats the untrained hover policy at the expert's
  first command on held-out states. The JAX test's labels (40 iterations,
  ``expert_max_iter``) and network (64-64, 400 steps); 64 states, 48 of
  them to train (the JAX test: 96 and 80). The labels take ~45 s on the
  CPU's plain solve (one scenario at a time, ~18 ms an iteration at
  H = 6); at 25 iterations the labels are not converged and the policy
  only ties hover, so the budget is not cut further;
- ``distill_policy`` with a DAgger round.
"""
import os

import torch

from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.learning import distill as TD
from sde4mbrl_px4_tpu_torch.models.policy import PolicyNet, policy_apply


def _cfg(repo_root):
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=6, num_short_dt=6)
    cfg["apg_mpc"].update(max_iter=15, max_no_improvement_iter=15)
    return cfg


def test_distillation_learns_expert(repo_root):
    """End to end on the port: sample -> converged-APG labels -> train. The
    trained policy cuts the supervised loss and beats the untrained hover
    policy at the expert's first command on held-out states."""
    cfg = _cfg(repo_root)
    dcfg = TD.DistillConfig(n_states=64, expert_max_iter=40, hidden=(64, 64), batch_size=64,
                            steps=400, pos_std=0.4, vel_std=0.3, tilt_std=0.1, yaw_std=0.2,
                            rate_std=0.3, seed=3)
    _, _, _, b = make_mpc_from_config(dict(cfg), device="cpu")
    xs, ts, xdes, ups = TD.sample_states(b, 64, torch.Generator().manual_seed(1), dcfg)
    labels = TD.label_states(cfg, xs, ts, xdes, None, dcfg, u_prevs=ups, device="cpu")
    assert labels.shape == (64, 6, 4)
    feats = TD.build_features(b, xs, ts, xdes, ups)
    n_tr = 48
    params, stats = TD.train_policy(feats[:n_tr], labels[:n_tr], b.lb, b.ub,
                                    b.cost_params.uref, dcfg)
    assert stats["losses"][-1] < 0.5 * stats["losses"][0]
    with torch.no_grad():
        pred = policy_apply(params, feats[n_tr:], b.lb, b.ub)
    err = float(torch.mean(torch.abs(pred[:, 0] - labels[n_tr:, 0])))
    err_hover = float(torch.mean(torch.abs(b.cost_params.uref - labels[n_tr:, 0])))
    assert err < err_hover, (err, err_hover)


def test_distill_policy_runs_with_a_dagger_round(repo_root):
    """``distill_policy`` on the port: sample, label, train, one DAgger
    round of 2 x 3 states; each label call is timed."""
    cfg = _cfg(repo_root)
    dcfg = TD.DistillConfig(n_states=6, expert_max_iter=5, hidden=(16,), batch_size=6,
                            steps=12, dagger_rounds=1, dagger_rollouts=2, dagger_steps=3)
    params, stats = TD.distill_policy(cfg, dcfg, device="cpu")
    assert isinstance(params, PolicyNet) and params.H == 6
    assert [n for n, _ in stats["label_calls"]] == [6, 6]
    assert len(stats["dagger0_losses"]) == 2 and stats["label_s"] > 0
