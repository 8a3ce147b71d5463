"""Port, risk over a sharded particle axis (L3): the moments the blocks of
particles of a particle-sharded solve share (``cost/cost.py::
combine_risk_moments``, the risk oracle's moment evaluations), on the
CPU at the particle pair's size (``tests/test_torch_distributed.py::
particle_cfg``: iris posctrl, H = 6, P = 8 split in two halves of 4), on
numpy-seeded plans and draws:

- the halves' ``(f, m, v)`` combined equal the one-process plain oracle's
  risk cost (rtol 2e-5, the rollout cost's tolerance,
  ``tests/test_pallas_kernels.py:76``), and the mean of the halves'
  moments-in gradients its gradient (rtol 5e-4, atol 5e-5 of the largest
  entry, ``:86``); at the draws' own spread and with the totals' spread
  cut to ~1e-4 of their mean, where the combined std stays within 2e-3 of
  the std of the per-particle costs taken in float64 and the one-pass
  formula (the halves' second moments about 0, less m squared) misses it
  by more than 10x that;
- the halves' risk costs, each over its own moments and then averaged,
  miss the one-process cost by more than the tolerance (so the combine is
  needed);
- the risk modes of the kernels' ABI agree with the header;
- ``cuda``: the kernels' moments-out ``value_batch`` (K = 1, 4) and
  moments-in ``value_and_grad`` against their plain twins on the card, at
  P = 256 (a rank's share of 512), fp32 and bf16; skips without one.
"""
import copy
import os
import re

import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.cost.cost import (combine_risk_moments, make_cost_fn,
                                               make_risk_moments_fn, make_risk_surrogate_fn)
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.ops.cuda import consts
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_sde

H, P, LAM = 6, 8, 2.0
VAL_RTOL, G_RTOL, G_ATOL = 2e-5, 5e-4, 5e-5
SD_RTOL = 2e-3          # the combined std against the float64 std of the per-particle costs
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sde4mbrl_px4_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def bundle(repo_root):
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=H, num_short_dt=H, num_particles=P)
    cfg["cost_params"]["risk_lambda"] = LAM
    return make_mpc_from_config(cfg, device="cpu")[3]


def problem(b, scale):
    """x0 0.4 m and 0.2 m/s off hover, three plans about uref, the (P, H, 13)
    draws times ``scale`` (which sets the spread of the totals)."""
    rs = np.random.RandomState(0)
    x0 = hover_state()
    x0[0], x0[3] = 0.4, 0.2
    x_ref = hover_state().expand(H + 1, 13).contiguous()
    U = torch.from_numpy((b.cost_params.uref.numpy() + 0.05 * rs.randn(3, H, 4))
                         .astype(np.float32))
    noise = torch.from_numpy((scale * rs.randn(P, H, 13)).astype(np.float32))
    return x0, x_ref, b.cost_params.uref.clone(), U, noise


def oracle(b, x0, x_ref, u_prev, noise, n, **kw):
    return CO.cost_oracle_plain(b.model, b.params, b.cost_params, b.time_steps, x0, x_ref,
                                u_prev, noise, n, 4, **kw)


def per_particle_std(b, x0, x_ref, u_prev, U, noise):
    """Each plan's std of its particles' totals, in float64 over each
    particle's fp32 total (its cost without the risk and control terms)."""
    cost = make_cost_fn(b.cost_params._replace(risk_lambda=None, uerr=0.0, u_slew_coeff=0.0,
                                               u_slew_constr=None), b.time_steps)
    out = []
    for u in U:
        xp, sg = rollout_sde(b.model, b.params, x0, u, b.time_steps, noise.transpose(0, 1))
        j = torch.stack([cost(xp[p:p + 1], sg[p:p + 1], u, x_ref, u_prev) for p in range(P)])
        out.append(float(j.double().std(unbiased=False)))
    return np.array(out)


@pytest.mark.parametrize("scale", [1.0, 0.004], ids=["spread", "tight"])
def test_combined_halves_equal_one_process(bundle, scale):
    b = bundle
    x0, x_ref, u_prev, U, noise = problem(b, scale)
    one = oracle(b, x0, x_ref, u_prev, noise, P)
    halves = [oracle(b, x0, x_ref, u_prev, noise[r * 4:(r + 1) * 4], 4)
              for r in range(2)]
    parts = torch.stack([h.value_batch_moments(U) for h in halves])          # (2, K, 3)
    value, m, sd = combine_risk_moments(parts, LAM)
    np.testing.assert_allclose(value.numpy(), one.value_batch(U).numpy(), rtol=VAL_RTOL)

    _, g_one = one.value_and_grad(U[0])
    g = sum(h.value_and_grad_moments(U[0], torch.stack([m[0], sd[0]]))[1] for h in halves) / 2
    np.testing.assert_allclose(g.numpy(), g_one.numpy(), rtol=G_RTOL,
                               atol=G_ATOL * float(g_one.abs().max()))

    truth = per_particle_std(b, x0, x_ref, u_prev, U, noise)
    np.testing.assert_allclose(sd.numpy(), truth, rtol=SD_RTOL)
    if scale < 1.0:
        mean = float(m.mean())
        assert 5e-5 < truth.max() / mean < 2e-4          # the totals' spread ~1e-4 of the mean
        second = (parts[..., 2] + parts[..., 1] ** 2).mean(0)     # the one-pass formula
        one_pass = torch.sqrt(torch.clamp(second - m * m, min=0.0) + 1e-12).numpy()
        assert np.abs(one_pass / truth - 1.0).max() > 10 * SD_RTOL
    else:
        own = (parts[..., 0] + LAM * torch.sqrt(parts[..., 2] + 1e-12)).mean(0)
        gap = ((own - value).abs() / value.abs()).max()
        assert float(gap) > 10 * VAL_RTOL                  # per-block moments miss


def test_risk_modes_match_the_header():
    text = open(os.path.join(CSRC, "apg_solve.cuh")).read()
    modes = re.search(r"enum \{ (RISK_IN_CLUSTER.*?) \};", text).group(1)
    got = dict(re.findall(r"(RISK_\w+) = (\d+)", modes))
    assert {k: int(v) for k, v in got.items()} == {
        "RISK_IN_CLUSTER": consts.RISK_IN_CLUSTER, "RISK_MOMENTS_OUT": consts.RISK_MOMENTS_OUT,
        "RISK_MOMENTS_IN": consts.RISK_MOMENTS_IN}


def test_moment_modes_need_a_risk_cost(bundle):
    """The moment evaluations exist exactly on a particle oracle with risk;
    the plain functions behind them refuse a cost without risk and a
    single path."""
    b = bundle
    x0, x_ref, u_prev, U, noise = problem(b, 1.0)
    free = b.cost_params._replace(risk_lambda=None)
    for make in (make_risk_moments_fn, make_risk_surrogate_fn):
        with pytest.raises(ValueError, match="risk_lambda"):
            make(free, b.time_steps)
    xp, sg = rollout_sde(b.model, b.params, x0, U[0], b.time_steps, noise.transpose(0, 1))
    with pytest.raises(ValueError, match="P > 1"):
        make_risk_moments_fn(b.cost_params, b.time_steps)(xp[:1], sg[:1], U[0], x_ref, u_prev)
    assert oracle(b, x0, x_ref, u_prev, None, 1).value_batch_moments is None
    no_risk = CO.cost_oracle_plain(b.model, b.params, free, b.time_steps, x0, x_ref, u_prev,
                                   noise, P, 4)
    assert no_risk.value_batch_moments is None and no_risk.value_and_grad_moments is None
    assert oracle(b, x0, x_ref, u_prev, noise, P).value_batch_moments(U).shape == (3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_moment_kernels_match_plain_on_cuda(repo_root, bf16):
    """The moments-out ``value_batch`` (K = 1, 4) and the moments-in
    ``value_and_grad`` against their plain twins on the card's tensors at
    P = 256 antithetic with risk 2 and the example's starts: the triples
    and the value at rtol 5e-4, the gradient at rtol 5e-4 / atol 5e-5 of
    its largest entry (phase 23's tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.ops.rollout import (
        draw_brownian, draw_start_spread, particle_starts)

    dev, Pk = torch.device("cuda"), 256
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg["cost_params"]["risk_lambda"] = LAM
    cfg["apg_mpc"].pop("precond", None)
    cfg.update(num_particles=Pk, antithetic=True)
    b = make_mpc_from_config(cfg, device=dev)[3]
    x0 = hover_state(dev)
    x0[0], x0[3] = 0.3, 0.2
    x_ref = hover_state(dev).expand(21, 13).contiguous()
    u_prev = b.cost_params.uref.clone()
    gen = torch.Generator().manual_seed(0)
    z = draw_brownian(gen, 20, Pk, True, dev).transpose(0, 1).contiguous()
    std = torch.tensor([0.15] * 3 + [0.1] * 3 + [0.0] * 4 + [0.05] * 3, device=dev)
    starts = particle_starts(x0, std, draw_start_spread(gen, Pk, True, dev)).contiguous()
    U = (u_prev + 0.05 * torch.rand((4, 20, 4), generator=gen).to(dev)).contiguous()
    args = (b.model, b.params, b.cost_params, b.time_steps, x0[None], x_ref[None],
            u_prev[None], z[None], Pk, 4)
    kern = CO.cost_oracle_batched(*args, starts=starts[None], bf16=bf16)
    plain = CO.cost_oracle_plain_batched(*args, starts=starts[None], bf16=bf16)
    for K in (1, 4):
        np.testing.assert_allclose(kern.value_batch_moments(U[None, :K]).cpu().numpy(),
                                   plain.value_batch_moments(U[None, :K]).cpu().numpy(),
                                   rtol=5e-4)
    mom = plain.value_batch_moments(U[None, :1])[:, 0, 1:].contiguous()
    mom[:, 1] = torch.sqrt(mom[:, 1] + 1e-12)
    v_k, g_k = kern.value_and_grad_moments(U[None, 0], mom)
    v_p, g_p = plain.value_and_grad_moments(U[None, 0], mom)
    np.testing.assert_allclose(v_k.cpu().numpy(), v_p.cpu().numpy(), rtol=5e-4)
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), rtol=5e-4,
                               atol=5e-5 * float(g_p.abs().max()))
