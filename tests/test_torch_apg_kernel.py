"""Port parity, solver layer: ``apg_solve_kernel`` (on CPU tensors: its
plain PyTorch version) against the JAX package's XLA ``apg_solve`` on the
problems of ``tests/test_apg_kernel.py::_solve_both``, and against the
Pallas kernel in interpret mode for the posctrl case. Fixed iteration
budgets with equal ``num_steps``; tolerances are the reference's own
(``tests/test_apg_kernel.py:60-80``).

``test_kernel_matches_plain_on_cuda``,
``test_particle_kernel_matches_plain_on_cuda`` and
``test_constraint_kernel_matches_plain_on_cuda`` compare the hand-written
CUDA kernel with the plain version on the card (P=1; P=8, P=64 in chunks of
16, P=96 in chunks of 32, P=512 and P=1024 antithetic; each
state-constraint form at P=1 and at P=8 in chunks of 4) and skip without
one;
``test_shipped_constrained_config_runs_on_the_card_by_default`` loads the
shipped constrained config with no device and solves it on the kernel."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (H, assert_lockstep, constrained_bundle, load_port_bundles, problem,
                           solve_pair)
from sde4mbrl_px4_tpu.ops.pallas.apg_kernel import pallas_apg_solve
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean
from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_problem
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import P1_BY_SHAPE, build_consts, p1_widths
from sde4mbrl_px4_tpu_torch.ops.cuda.cost_oracle import value_and_grad_kernel


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
    # particles: the Brownian block is required, in the (P, H, 13) layout,
    # and a chunk must divide P (apg_kernel.py:122-123 of the original)
    with pytest.raises(ValueError, match="Brownian block"):
        AK.apg_solve_kernel(*args, 4, tb.lb, tb.ub, u_init)
    with pytest.raises(ValueError, match="noise"):
        AK.apg_solve_kernel(*args[:-1], torch.zeros(H, 4, 13), 4, tb.lb, tb.ub, u_init)
    with pytest.raises(ValueError, match="divide"):
        AK.apg_solve_kernel(*args[:-1], torch.zeros(4, H, 13), 4, tb.lb, tb.ub, u_init,
                            chunk=3)
    with pytest.raises(ValueError, match="divide"):
        AK.apg_solve_kernel(*args, 1, tb.lb, tb.ub, u_init, chunk=4)
    # the box is nZ wide: n_u columns without a proximal state_constr block
    lb6 = torch.cat([tb.lb, torch.zeros(2)])
    with pytest.raises(ValueError, match="nZ=4"):
        AK.apg_solve_kernel(*args, 1, lb6, lb6 + 1, u_init)
    # the P=1 form is the trunk's shape's: the register chain on 64 hidden
    # units and at most 16 inputs (9 + n_u), the shared-memory step on any
    # other, whose weights the libraries place (ApgArgs.step asks them to); no
    # width is refused, and the weights close the consts buffer
    AK._check_scope(tb.model, tb.cost_params, tb.apg_config, tb.lb)
    net = tb.params["net"]

    def trunk(hid):
        w = {"w0": torch.zeros(13, hid), "b0": torch.zeros(hid), "w1": torch.zeros(hid, hid),
             "b1": torch.zeros(hid), "w2": torch.zeros(hid, 12), "b2": net["b2"]}
        return {**tb.params, "net": w}

    for params, hid in ((tb.params, 64), (trunk(32), 32), (trunk(128), 128), (trunk(256), 256)):
        _, oargs = build_consts(tb.model, params, tb.cost_params, tb.apg_config,
                                tb.time_steps, x0, x_ref, u_prev)
        assert (oargs.HID, oargs.F, oargs.step) == (hid, 13, P1_BY_SHAPE)
        assert p1_widths(oargs.F, oargs.HID) == (hid == 64)
        assert oargs.n_consts == oargs.o_b2 + 12 and oargs.o_w0 == oargs.o_ub + 4
    with pytest.raises(ValueError, match="no bf16 trunk"):
        value_and_grad_kernel(torch.zeros(oargs.n_consts), type(oargs)(bf16=1), u_init)


@pytest.mark.cuda
@pytest.mark.parametrize("maxls", [None, 1, 8])
def test_kernel_matches_plain_on_cuda(repo_root, maxls):
    """The CUDA kernel against its plain version on the card, both iris
    configs, fixed budgets, at the CPU tests' tolerances; x_evol against
    the mean rollout of the kernel's own plan at rtol 1e-5. ``maxls`` 1 and
    8 (APG_MAXK) put one and eight candidate rows, one warp each, beside the
    config's 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU mode")
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean as t_rollout_mean

    dev = torch.device("cuda")
    for name, max_iter, tol in (("iris_traj_mpc", 10, (2e-4, 2e-5)),
                                ("iris_posctrl_mpc", 8, (5e-4, 5e-5))):
        b = load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{name}.yaml"),
                                  device=dev)[3]
        apg = b.apg_config._replace(max_iter=max_iter, max_no_improvement_iter=max_iter,
                                    maxls=maxls or b.apg_config.maxls)
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


@pytest.mark.cuda
@pytest.mark.parametrize("P, chunk, antithetic", [(8, 0, False), (64, 16, False),
                                                  (512, 0, True), (1024, 0, True),
                                                  (96, 32, False)])
def test_particle_kernel_matches_plain_on_cuda(repo_root, P, chunk, antithetic):
    """The particle form of the whole-solve kernel against its plain version
    on the card, both iris configs, max_iter=10, the same torch draws: equal
    steps, yk at rtol 5e-4 / atol 5e-5, opt_cost at rel 5e-4
    (``tests/test_apg_kernel.py:100-105``); one solve launch and one
    ``trajectory`` launch for x_evol, the mean rollout of the plan. P=1024
    puts more chunks than blocks in the cluster, P=96 in chunks of 32 a
    cluster of 3; a cluster of one block gives the same plan (rtol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU mode")
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean as t_rollout_mean

    dev = torch.device("cuda")
    for name in ("iris_traj_mpc", "iris_posctrl_mpc"):
        b = load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{name}.yaml"),
                                  device=dev)[3]
        apg = b.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
        x0, x_ref, u_prev, u_init = (torch.from_numpy(a).to(dev) for a in
                                     problem(b.cost_params.uref.cpu().numpy()))
        z = draw_brownian(torch.Generator().manual_seed(P), H, P, antithetic,
                          dev).transpose(0, 1)
        args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref,
                u_prev, z, P, b.lb, b.ub, u_init)
        n0 = (AK.apg_solve_kernel.launches, CO.trajectory_kernel.launches)
        st_k, xe_k = AK.apg_solve_kernel(*args, precond=b.precond, chunk=chunk)
        torch.cuda.synchronize()
        assert (AK.apg_solve_kernel.launches, CO.trajectory_kernel.launches) == \
            (n0[0] + 1, n0[1] + 1)
        st_p, _ = AK.apg_solve_plain(*args, precond=b.precond, chunk=chunk)
        assert int(st_k.num_steps) == int(st_p.num_steps)
        np.testing.assert_allclose(st_k.yk.cpu().numpy(), st_p.yk.cpu().numpy(),
                                   rtol=5e-4, atol=5e-5)
        assert float(st_k.opt_cost) == pytest.approx(float(st_p.opt_cost), rel=5e-4)
        ref = t_rollout_mean(b.model, b.params, x0, st_k.yk, b.time_steps)
        np.testing.assert_allclose(xe_k.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        st_1, _ = AK.apg_solve_kernel(*args, precond=b.precond, chunk=chunk, cluster=1)
        assert int(st_1.num_steps) == int(st_k.num_steps)
        np.testing.assert_allclose(st_1.yk.cpu().numpy(), st_k.yk.cpu().numpy(),
                                   rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("maxls", [None, 1, 8])
@pytest.mark.parametrize("P, chunk", [(1, 0), (8, 4)])
@pytest.mark.parametrize("form", ["penalty", "prox"])
def test_constraint_kernel_matches_plain_on_cuda(repo_root, form, P, chunk, maxls):
    """The state-constraint branches of the whole-solve kernel (the shipped
    ``iris_constr_posctrl_mpc.yaml`` and its penalty form) against the plain
    version on the card, max_iter=10 from a bound-violating start, the same
    torch draws at P=8: equal steps, ``yk`` (nZ = 10 wide in the proximal
    form) at rtol 5e-4 / atol 5e-5, ``opt_cost`` at rel 5e-4
    (``tests/test_prox_slack.py:143-146``); ``x_evol`` the mean rollout of
    the control columns. ``maxls`` 1 and 8 (APG_MAXK) beside the config's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU mode")
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean as t_rollout_mean

    dev = torch.device("cuda")
    b = constrained_bundle(repo_root, form, dev)
    apg = b.apg_config._replace(max_iter=10, max_no_improvement_iter=10,
                                maxls=maxls or b.apg_config.maxls)
    x0, x_ref, u_prev, z_init = constrained_problem(b)
    z = None if P == 1 else draw_brownian(torch.Generator().manual_seed(P), H, P, True,
                                          dev).transpose(0, 1)
    args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev, z, P,
            b.lb_z, b.ub_z, z_init)
    n0 = AK.apg_solve_kernel.launches
    st_k, xe_k = AK.apg_solve_kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert AK.apg_solve_kernel.launches == n0 + 1
    st_p, _ = AK.apg_solve_plain(*args, chunk=chunk)
    assert int(st_k.num_steps) == int(st_p.num_steps)
    assert st_k.yk.shape == (H, 10 if form == "prox" else 4)
    np.testing.assert_allclose(st_k.yk.cpu().numpy(), st_p.yk.cpu().numpy(),
                               rtol=5e-4, atol=5e-5)
    assert float(st_k.opt_cost) == pytest.approx(float(st_p.opt_cost), rel=5e-4)
    ref = t_rollout_mean(b.model, b.params, x0, st_k.yk[:, :4], b.time_steps)
    np.testing.assert_allclose(xe_k.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_shipped_constrained_config_runs_on_the_card_by_default(repo_root):
    """``load_mpc_from_cfgfile`` of the shipped constrained config with no
    device runs on the card: one solve is one launch of the whole-solve
    kernel (its proximal form), ``u_opt`` the 4 control columns and the
    warm start nZ = 10 wide."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU mode")
    from sde4mbrl_px4_tpu_torch.core.types import hover_state

    _, (reset_fn, mpc_fn), _, b = load_mpc_from_cfgfile(
        os.path.join(repo_root, "configs/iris_constr_posctrl_mpc.yaml"))
    assert b.device.type == "cuda"
    x = hover_state(b.device)
    gen = torch.Generator().manual_seed(0)
    n0 = AK.apg_solve_kernel.launches
    sol = mpc_fn(x, gen, reset_fn(x, gen, x), 0.0, x)
    torch.cuda.synchronize()
    assert AK.apg_solve_kernel.launches == n0 + 1
    assert sol.u_opt.shape == (H, 4) and sol.opt_state.yk.shape == (H, 10)
    assert sol.u_opt.device.type == "cuda" and bool(torch.isfinite(sol.u_opt).all())
