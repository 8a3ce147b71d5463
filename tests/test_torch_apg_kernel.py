"""Port parity, solver layer: ``apg_solve_kernel`` (on CPU tensors: its
plain PyTorch version) against the JAX package's XLA ``apg_solve`` on the
problems of ``tests/test_apg_kernel.py::_solve_both``, and against the
Pallas kernel in interpret mode for the posctrl case. Fixed iteration
budgets with equal ``num_steps``; tolerances are the reference's own
(``tests/test_apg_kernel.py:60-80``).

``test_kernel_matches_plain_on_cuda`` compares the hand-written CUDA
kernel with the plain version on the card and skips without one."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import H, assert_lockstep, load_port_bundles, problem, solve_pair
from sde4mbrl_px4_tpu.ops.pallas.apg_kernel import pallas_apg_solve
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK


@pytest.fixture(scope="module")
def port_bundles(repo_root):
    return load_port_bundles(repo_root)


def test_plain_matches_xla_traj(iris_traj_bundle, port_bundles):
    """Flagship traj config (Barzilai-Borwein trial step), max_iter=10, plus
    the exported x_evol against the JAX mean rollout of the same plan."""
    st_x, st_t, x_evol, (x0, *_) = solve_pair(
        iris_traj_bundle, port_bundles["iris_traj_mpc"], max_iter=10)
    assert_lockstep(st_x, st_t, rtol=2e-4, atol=2e-5)
    b = iris_traj_bundle[3]
    ref = rollout_mean(b.model, b.params, jnp.asarray(x0), jnp.asarray(st_t.yk.numpy()),
                       b.time_steps)
    assert x_evol.shape == (H + 1, 13)
    np.testing.assert_allclose(x_evol.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_plain_matches_xla_and_pallas_posctrl(iris_pos_bundle, port_bundles):
    """posctrl: slew-rate box in cost and gradient, reset_option increase,
    max_iter=8; also against the Pallas kernel in interpret mode."""
    st_x, st_t, _, (x0, x_ref, u_prev, u_init, apg) = solve_pair(
        iris_pos_bundle, port_bundles["iris_posctrl_mpc"], max_iter=8)
    assert_lockstep(st_x, st_t, rtol=5e-4, atol=5e-5, stats=False)
    b = iris_pos_bundle[3]
    st_p = pallas_apg_solve(
        b.model, b.params, b.cost_params, apg, b.time_steps, jnp.asarray(x0),
        jnp.asarray(x_ref), jnp.asarray(u_prev), jnp.zeros((1, H, 13), jnp.float32),
        1, b.lb, b.ub, jnp.asarray(u_init), interpret=True, deterministic=True)
    assert_lockstep(st_p, st_t, rtol=5e-4, atol=5e-5, stats=False)


def test_scope_is_enforced(port_bundles):
    tb = port_bundles["iris_posctrl_mpc"]
    x0, x_ref, u_prev, u_init = (torch.from_numpy(a) for a in
                                 problem(tb.cost_params.uref.numpy()))
    args = (tb.model, tb.params, tb.cost_params, tb.apg_config, tb.time_steps, x0,
            x_ref, u_prev, None)
    with pytest.raises(NotImplementedError, match="P=1"):
        AK.apg_solve_kernel(*args, 4, tb.lb, tb.ub, u_init)
    with pytest.raises(NotImplementedError, match="noise given"):
        AK.apg_solve_kernel(*args[:-1], torch.zeros(H, 1, 13), 1, tb.lb, tb.ub, u_init)
    with pytest.raises(NotImplementedError, match="chunk"):
        AK.apg_solve_kernel(*args, 1, tb.lb, tb.ub, u_init, chunk=4)
    lb6 = torch.cat([tb.lb, torch.zeros(2)])
    with pytest.raises(NotImplementedError, match="slack"):
        AK.apg_solve_kernel(*args, 1, lb6, lb6 + 1, u_init)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(repo_root):
    """The CUDA kernel against its plain version on the card, both iris
    configs, fixed budgets, at the CPU tests' tolerances; x_evol against
    the mean rollout of the kernel's own plan at rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU mode")
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean as t_rollout_mean

    dev = torch.device("cuda")
    for name, max_iter, tol in (("iris_traj_mpc", 10, (2e-4, 2e-5)),
                                ("iris_posctrl_mpc", 8, (5e-4, 5e-5))):
        b = load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{name}.yaml"),
                                  device=dev)[3]
        apg = b.apg_config._replace(max_iter=max_iter, max_no_improvement_iter=max_iter)
        x0, x_ref, u_prev, u_init = (torch.from_numpy(a).to(dev) for a in
                                     problem(b.cost_params.uref.cpu().numpy()))
        args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref,
                u_prev, None, 1, b.lb, b.ub, u_init)
        n0 = AK.apg_solve_kernel.launches
        st_k, xe_k = AK.apg_solve_kernel(*args, precond=b.precond)
        torch.cuda.synchronize()
        assert AK.apg_solve_kernel.launches == n0 + 1
        st_p, _ = AK.apg_solve_plain(*args, precond=b.precond)
        assert int(st_k.num_steps) == int(st_p.num_steps)
        np.testing.assert_allclose(st_k.yk.cpu().numpy(), st_p.yk.cpu().numpy(),
                                   rtol=tol[0], atol=tol[1])
        assert float(st_k.opt_cost) == pytest.approx(float(st_p.opt_cost), rel=tol[0])
        ref = t_rollout_mean(b.model, b.params, x0, st_k.yk, b.time_steps)
        np.testing.assert_allclose(xe_k.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
