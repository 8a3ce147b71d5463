"""Port parity, the risk-sensitive particle reduction (``cost_params.
risk_lambda``): the port's plain path against the JAX package's XLA path on
the CPU, on numpy-seeded inputs with JAX's own draws injected.

- ``CostParams.from_config`` reads ``risk_lambda`` as the original
  (``cost/cost.py:139-140``): a float32 where it is set and non-zero, else
  None;
- the twin of ``tests/test_cost.py:190-240``: a spread is priced, identical
  particles move the cost by less than 1e-3, the gradient stays finite; the
  cost of random paths at rtol 2e-5 and its gradient with respect to the
  paths at rtol 5e-4 / atol 5e-5 against ``jax.grad``;
- the cost of a plan through the P=16 rollout (value rtol 2e-5, gradient
  rtol 5e-4 / atol 5e-5) on both iris configs;
- the first ``mpc_fn`` solve with risk, linesearch and fixed-step (posctrl
  with and without its linesearch block), against the JAX ``mpc_fn`` on its
  own draws: equal ``num_steps``, rtol 2e-4 / atol 2e-5;
- (the twin of ``tests/test_noise_robustness.py:69``, risk backing off
  the altitude floor, is ``tests/test_torch_noise_robustness.py``);
- ``cuda``: the risk branch of each particle kernel (the whole solve,
  ``value_and_grad``, ``value_batch``) against its plain version on the
  card; skips without one.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.cost.cost import CostParams as JCostParams
from sde4mbrl_px4_tpu.cost.cost import make_cost_fn as j_make_cost_fn
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.rollout import draw_brownian as j_draw_brownian
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde as j_rollout_sde
from _torch_parity import assert_solve_lockstep, first_solve_pair, jax_solve_draws
from sde4mbrl_px4_tpu_torch.cost.cost import CostParams, make_cost_fn
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_sde

H = 20
VAL_RTOL, G_RTOL, G_ATOL = 2e-5, 5e-4, 5e-5
T = torch.from_numpy


def risk_config(repo_root, name, lam=2.0, **top):
    cfg = j_load_yaml(os.path.join(repo_root, f"configs/{name}.yaml"))
    cfg["cost_params"]["risk_lambda"] = lam
    cfg.update(top)
    return cfg


@pytest.mark.parametrize("lam, want", [(2.0, np.float32(2.0)), (0.3, np.float32(0.3)),
                                       (0.0, None), (None, None)])
def test_risk_lambda_from_config(repo_root, lam, want):
    cfg = risk_config(repo_root, "iris_posctrl_mpc", lam)
    if lam is None:
        del cfg["cost_params"]["risk_lambda"]
    t, j = CostParams.from_config(cfg, 4), JCostParams.from_config(cfg, 4)
    if want is None:
        assert t.risk_lambda is None and j.risk_lambda is None
    else:
        assert t.risk_lambda == float(j.risk_lambda) == float(want)


def _paths(seed, P=16, h=6):
    rs = np.random.RandomState(seed)
    hover = np.zeros(13, np.float32)
    hover[6] = 1.0
    xp = (hover + 0.1 * rs.randn(P, h + 1, 13)).astype(np.float32)
    sg = (0.05 + 0.02 * rs.rand(P, h, 13)).astype(np.float32)
    x_ref = np.tile(hover, (h + 1, 1))
    u = np.full((h, 4), 0.71, np.float32)
    return xp, sg, x_ref, u


@pytest.mark.parametrize("name", ["iris_traj_mpc", "iris_posctrl_mpc"])
def test_risk_prices_outcome_spread_like_jax(repo_root, name):
    """``tests/test_cost.py:190-221`` on the port (no sigma paths: a spread
    is priced, identical particles move the cost by less than 1e-3, the
    gradient is finite), each value against the JAX cost of the same paths
    (rtol 2e-5) and the gradient with respect to the paths, with and
    without sigma paths, against ``jax.grad`` (rtol 5e-4 / atol 5e-5)."""
    h = 6
    ts_np = np.full((h,), 0.05, np.float32)
    cfg0 = j_load_yaml(os.path.join(repo_root, f"configs/{name}.yaml"))
    cfg_r = risk_config(repo_root, name)
    xp, sg, x_ref, u = _paths(1, h=h)
    same = np.broadcast_to(xp[0], xp.shape).copy()
    cost = {}
    for tag, cfg in (("mean", cfg0), ("risk", cfg_r)):
        tf = make_cost_fn(CostParams.from_config(cfg, 4), T(ts_np))
        jf = j_make_cost_fn(JCostParams.from_config(cfg, 4), jnp.asarray(ts_np))
        for paths, sig in ((xp, None), (same, None), (xp, sg)):
            key = (tag, paths is xp, sig is not None)
            t_sig = None if sig is None else T(sig)
            j_sig = None if sig is None else jnp.asarray(sig)
            v_t = float(tf(T(paths), t_sig, T(u), T(x_ref)))
            v_j = float(jf(jnp.asarray(paths), j_sig, jnp.asarray(u), jnp.asarray(x_ref)))
            assert v_t == pytest.approx(v_j, rel=VAL_RTOL), key
            cost[key] = v_t
            if paths is same:
                continue
            xt = T(paths.copy()).requires_grad_(True)
            (g_t,) = torch.autograd.grad(tf(xt, t_sig, T(u), T(x_ref)), xt)
            g_j = jax.grad(lambda p: jf(p, j_sig, jnp.asarray(u), jnp.asarray(x_ref)))(
                jnp.asarray(paths))
            assert np.isfinite(g_t.numpy()).all()
            np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=G_RTOL, atol=G_ATOL)
    assert cost[("risk", True, False)] > cost[("mean", True, False)]     # spread priced
    assert abs(cost[("risk", False, False)] - cost[("mean", False, False)]) < 1e-3
    assert cost[("risk", True, True)] > cost[("mean", True, True)]


@pytest.mark.parametrize("name", ["iris_traj_mpc", "iris_posctrl_mpc"])
def test_risk_cost_through_rollout_matches_jax(repo_root, name):
    """A plan's cost through the P=16 rollout on JAX's draws, with
    ``risk_lambda: 2``: value rtol 2e-5, ``autograd`` gradient against
    ``jax.grad`` rtol 5e-4 / atol 5e-5."""
    cfg = risk_config(repo_root, name, num_particles=16)
    # the cost needs no preconditioner (a hover_diag cache for this cost
    # would have to be probed first)
    cfg["apg_mpc"].pop("precond", None)
    jb = j_make(copy.deepcopy(cfg))[3]
    tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")[3]
    rs = np.random.RandomState(7)
    x0 = np.zeros(13, np.float32)
    x0[6] = 1.0
    x0[:6] += (0.3 * rs.randn(6)).astype(np.float32)
    x_ref = np.tile(x0, (H + 1, 1))
    x_ref[:, :3] += (0.5 * rs.randn(H + 1, 3)).astype(np.float32)
    u = rs.uniform(0.3, 0.95, (H, 4)).astype(np.float32)
    u_prev = rs.uniform(0.6, 0.8, 4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(j_draw_brownian(key, H, 16))
    jf = j_make_cost_fn(jb.cost_params, jb.time_steps)
    tf = make_cost_fn(tb.cost_params, tb.time_steps)

    def j_cost(uu):
        xp, sg = j_rollout_sde(jb.model, jb.params, jnp.asarray(x0), uu, jb.time_steps, key, 16)
        return jf(xp, sg, uu, jnp.asarray(x_ref), jnp.asarray(u_prev))

    def t_cost(uu):
        xp, sg = rollout_sde(tb.model, tb.params, T(x0), uu, tb.time_steps, T(noise))
        return tf(xp, sg, uu, T(x_ref), T(u_prev))

    ut = T(u.copy()).requires_grad_(True)
    v_t = t_cost(ut)
    (g_t,) = torch.autograd.grad(v_t, ut)
    v_t = v_t.detach()
    v_j, g_j = jax.jit(jax.value_and_grad(j_cost))(jnp.asarray(u))
    assert float(v_t) == pytest.approx(float(v_j), rel=VAL_RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("route", ["linesearch", "fixed_step"])
def test_mpc_fn_risk_first_solve_matches_jax(repo_root, route):
    """The first risk solve (P=8, ``risk_lambda: 2``) through both
    ``mpc_fn``s on JAX's draws: the linesearch posctrl config and its
    fixed-step form (stepsize 1e-5), 8 iterations. (The traj config's
    hover_diag metric is keyed on the cost, so a risk cost has no committed
    cache; the port refuses a cache miss, ROADMAP item 12.)"""
    cfg = risk_config(repo_root, "iris_posctrl_mpc", num_particles=8)
    if route == "fixed_step":
        del cfg["apg_mpc"]["linesearch"]
        cfg["apg_mpc"]["stepsize"] = 1e-5
    cfg["apg_mpc"].update(max_iter=8, max_no_improvement_iter=8)
    sol_j, sol_t, tb = first_solve_pair(cfg, jax_solve_draws(8, 1, False))
    assert tb.cost_params.risk_lambda == 2.0
    assert_solve_lockstep(sol_j, sol_t)


@pytest.mark.cuda
@pytest.mark.parametrize("name, P, chunk", [("iris_traj_mpc", 512, 0),
                                            ("iris_posctrl_mpc", 1024, 0),
                                            ("iris_posctrl_mpc", 64, 16)])
def test_risk_kernels_match_plain_on_cuda(repo_root, name, P, chunk):
    """The risk branch of the particle kernels against their plain versions
    on the card, the same torch draws (antithetic), ``risk_lambda: 2``: the
    whole solve at max_iter 5 (equal steps, yk rtol 5e-4 / atol 5e-5), the
    oracle's ``value_batch`` at K = 1, 4 (rtol 5e-4) and ``value_and_grad``
    (value 5e-4, gradient 5e-4 / 5e-5); the whole solve on its cluster
    against one block, within 1e-6 (equal bits expected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian

    dev = torch.device("cuda")
    cfg = load_yaml_config(os.path.join(repo_root, f"configs/{name}.yaml"))
    cfg["cost_params"]["risk_lambda"] = 2.0
    cfg["apg_mpc"].pop("precond", None)       # no hover_diag cache for a risk cost
    cfg.update(num_particles=P, antithetic=True)
    b = make_mpc_from_config(cfg, device=dev)[3]
    assert b.cost_params.risk_lambda == 2.0
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    x0 = torch.zeros(13, device=dev)
    x0[6], x0[0], x0[3] = 1.0, 0.3, 0.2
    x_ref = x0.clone().expand(H + 1, 13).contiguous()
    x_ref[:, 0] = 0.0
    u_prev = b.cost_params.uref.clone()
    u_init = (u_prev.expand(H, 4) + 0.02).contiguous()
    z = draw_brownian(torch.Generator().manual_seed(P), H, P, True, dev).transpose(0, 1)
    args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev, z, P,
            b.lb, b.ub, u_init)
    st_k, _ = AK.apg_solve_kernel(*args, precond=b.precond, chunk=chunk)
    st_1, _ = AK.apg_solve_kernel(*args, precond=b.precond, chunk=chunk, cluster=1)
    torch.cuda.synchronize()
    st_p, _ = AK.apg_solve_plain(*args, precond=b.precond, chunk=chunk)
    assert int(st_k.num_steps) == int(st_p.num_steps) == int(st_1.num_steps)
    np.testing.assert_allclose(st_k.yk.cpu().numpy(), st_p.yk.cpu().numpy(), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(st_1.yk.cpu().numpy(), st_k.yk.cpu().numpy(), rtol=1e-6, atol=0)
    orc = CO.cost_oracle(b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev,
                         z, P, 4, chunk=chunk)
    plain = CO.cost_oracle_plain(b.model, b.params, b.cost_params, b.time_steps, x0, x_ref,
                                 u_prev, z, P, 4, chunk=chunk)
    U = (u_init + 0.05 * torch.rand((4, H, 4), generator=torch.Generator().manual_seed(1))
         .to(dev)).contiguous()
    for K in (1, 4):
        np.testing.assert_allclose(orc.value_batch(U[:K]).cpu().numpy(),
                                   plain.value_batch(U[:K]).cpu().numpy(), rtol=5e-4)
    v_k, g_k = orc.value_and_grad(u_init)
    v_p, g_p = plain.value_and_grad(u_init)
    assert float(v_k) == pytest.approx(float(v_p), rel=5e-4)
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), rtol=5e-4, atol=5e-5)
