"""Port parity, cost layer: ``CostParams.from_config`` and ``make_cost_fn``
of ``sde4mbrl_px4_tpu_torch`` against ``sde4mbrl_px4_tpu`` for both iris
flight configs. The cost of a plan is the rollout (mean dynamics, P=1)
plus the cost function, as the solver sees it; its value is held at rtol
2e-5 and its autograd gradient against ``jax.grad`` at rtol 5e-4, atol
5e-5 (the reference's own kernel tolerances,
``tests/test_pallas_kernels.py:76,86``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.cost.cost import make_cost_fn as j_make_cost_fn
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde as j_rollout_sde
from sde4mbrl_px4_tpu_torch.cost.cost import make_cost_fn
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_sde

H = 20


@pytest.fixture(scope="module", params=["traj", "pos"])
def pair(request, repo_root, iris_traj_bundle, iris_pos_bundle):
    jb = iris_traj_bundle if request.param == "traj" else iris_pos_bundle
    name = "iris_traj_mpc" if request.param == "traj" else "iris_posctrl_mpc"
    tb = load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{name}.yaml"))
    return jb, tb


def test_cost_params_from_config(pair):
    (_, _, _, jb), (_, _, _, tb) = pair
    jcp, tcp = jb.cost_params, tb.cost_params
    for f in ("uref", "perr", "verr", "qerr", "werr"):
        np.testing.assert_array_equal(getattr(tcp, f).numpy(), np.asarray(getattr(jcp, f)))
    for f in ("uerr", "res_mult", "u_slew_coeff", "u_slew_constr_coeff", "discount"):
        assert getattr(tcp, f) == float(getattr(jcp, f)), f
    if jcp.u_slew_constr is None:
        assert tcp.u_slew_constr is None
    else:
        np.testing.assert_array_equal(tcp.u_slew_constr.numpy(), np.asarray(jcp.u_slew_constr))


def _inputs(seed):
    rs = np.random.RandomState(seed)
    x0 = np.zeros(13, np.float32)
    x0[6] = 1.0
    x0[:6] += (0.3 * rs.randn(6)).astype(np.float32)
    x_ref = np.tile(x0, (H + 1, 1))
    x_ref[:, :3] += (0.5 * rs.randn(H + 1, 3)).astype(np.float32)
    q = rs.randn(H + 1, 4).astype(np.float32) * 0.05 + [1.0, 0.0, 0.0, 0.0]
    x_ref[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    u = rs.uniform(0.3, 0.95, (H, 4)).astype(np.float32)
    u_prev = rs.uniform(0.6, 0.8, 4).astype(np.float32)
    return x0, x_ref, u, u_prev


def _costs(pair, seed):
    (_, _, _, jb), (_, _, _, tb) = pair
    x0, x_ref, u, u_prev = _inputs(seed)
    jcost = j_make_cost_fn(jb.cost_params, jb.time_steps)

    def j_seq(u_):
        xp, sg = j_rollout_sde(jb.model, jb.params, jnp.asarray(x0), u_, jb.time_steps,
                               jax.random.PRNGKey(0), 1, deterministic=True)
        return jcost(xp, sg, u_, jnp.asarray(x_ref), jnp.asarray(u_prev))

    tcost = make_cost_fn(tb.cost_params, tb.time_steps)
    zeros = torch.zeros(H, 1, 13)

    def t_seq(u_):
        xp, sg = rollout_sde(tb.model, tb.params, torch.from_numpy(x0), u_,
                             tb.time_steps, zeros)
        return tcost(xp, sg, u_, torch.from_numpy(x_ref), torch.from_numpy(u_prev))

    return j_seq, t_seq, u


@pytest.mark.parametrize("seed", [3, 5])
def test_cost_value(pair, seed):
    j_seq, t_seq, u = _costs(pair, seed)
    v_j = float(jax.jit(j_seq)(jnp.asarray(u)))
    v_t = float(t_seq(torch.from_numpy(u)))
    assert v_t == pytest.approx(v_j, rel=2e-5)


@pytest.mark.parametrize("seed", [3, 7])
def test_cost_gradient(pair, seed):
    j_seq, t_seq, u = _costs(pair, seed)
    g_j = np.asarray(jax.jit(jax.grad(j_seq))(jnp.asarray(u)))
    u_t = torch.from_numpy(u).requires_grad_(True)
    (g_t,) = torch.autograd.grad(t_seq(u_t), u_t)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=5e-4, atol=5e-5)


def test_batched_cost_matches_single(pair):
    """The vectorized-linesearch evaluation (``torch.func.vmap`` over K
    plans) equals K single evaluations."""
    _, t_seq, u = _costs(pair, 11)
    U = torch.stack([torch.from_numpy(u) + 0.01 * k for k in range(4)])
    batched = torch.func.vmap(t_seq)(U)
    single = torch.stack([t_seq(U[k]) for k in range(4)])
    np.testing.assert_allclose(batched.numpy(), single.numpy(), rtol=1e-6)
