"""Port parity, cost oracle: ``ops/cuda/cost_oracle.py::cost_oracle`` (on
CPU tensors: its plain version) against the JAX package's
``pallas_cost_oracle`` in interpret mode and its XLA oracle
(``CostOracle.from_fn``), on both iris configs, for ``value``,
``value_batch`` (K = 1, 4; K = 64 against XLA only), ``value_and_grad``
and ``trajectory``. Plans are drawn from a numpy seed; the weights are the
committed checkpoint on both sides. Tolerances are the reference's own
(``tests/test_pallas_kernels.py:76,86``; ``tests/test_apg_kernel.py:199``):
values rtol 2e-5, gradients rtol 5e-4 / atol 5e-5, trajectories rtol 1e-5.

``test_kernels_match_plain_on_cuda``,
``test_particle_kernels_match_plain_on_cuda``,
``test_constraint_kernels_match_plain_on_cuda``,
``test_floor_value_batch_matches_plain_on_cuda`` and
``test_padded_trunk_runs_on_cuda`` hold the three CUDA kernels to the plain
version on the card (P=1 at K up to 256; P=8, P=64 in chunks of 16, P=96
in chunks of 32, P=512 and P=1024 antithetic; each state-constraint form
at P=1 and at P=8 in chunks of 4; the P=128 altitude floor; the trunk
padded outside the P=1 register layout with new units), the particle ``value_batch`` and
``value_and_grad`` on their clusters against one block (``cluster=1``),
and skip without one."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import H, constrained_bundle, load_port_bundles, problem
from sde4mbrl_px4_tpu.cost.cost import make_cost_fn
from sde4mbrl_px4_tpu.ops.pallas.solve_kernels import pallas_cost_oracle
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean, rollout_sde
from sde4mbrl_px4_tpu.solver.apg import CostOracle as JaxOracle
from sde4mbrl_px4_tpu_torch.engine.goldens import (constrained_plans, constrained_problem,
                                                   padded_trunk)
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

CONFIGS = {"traj": "iris_traj_mpc", "pos": "iris_posctrl_mpc"}
VAL_RTOL, G_RTOL, G_ATOL, X_RTOL = 2e-5, 5e-4, 5e-5, 1e-5


def plans(K, seed, n=4):
    return np.random.RandomState(seed).uniform(0.3, 0.95, (K, H, n)).astype(np.float32)


@pytest.fixture(scope="module")
def oracles(repo_root, iris_traj_bundle, iris_pos_bundle):
    """{config: (xla, pallas-interpret, port, jax bundle, problem)}"""
    tbs = load_port_bundles(repo_root)
    out = {}
    for key, jb in (("traj", iris_traj_bundle), ("pos", iris_pos_bundle)):
        b, tb = jb[3], tbs[CONFIGS[key]]
        x0, x_ref, u_prev, _ = problem(b.cost_params.uref)
        cost_fn = make_cost_fn(b.cost_params, b.time_steps)

        def seq_cost(u, b=b, cost_fn=cost_fn, x0=x0, x_ref=x_ref, u_prev=u_prev):
            xp, sg = rollout_sde(b.model, b.params, jnp.asarray(x0), u, b.time_steps,
                                 jax.random.PRNGKey(0), 1, deterministic=True)
            return cost_fn(xp, sg, u, jnp.asarray(x_ref), jnp.asarray(u_prev))

        pk = pallas_cost_oracle(
            b.model, b.params, b.cost_params, b.time_steps, jnp.asarray(x0),
            jnp.asarray(x_ref), jnp.asarray(u_prev), jnp.zeros((1, H, 13), jnp.float32),
            1, maxls=4, interpret=True)
        T = torch.from_numpy
        port = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps,
                              T(x0), T(x_ref), T(u_prev), None, 1, 4)
        out[key] = (JaxOracle.from_fn(seq_cost), pk, port, b, (x0, x_ref, u_prev))
    return out


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_value_matches_jax(oracles, cfg):
    xla, pk, port, _, _ = oracles[cfg]
    u = plans(1, 3)[0]
    v = float(port.value(torch.from_numpy(u)))
    assert v == pytest.approx(float(xla.value(jnp.asarray(u))), rel=VAL_RTOL)
    assert v == pytest.approx(float(pk.value(jnp.asarray(u))), rel=VAL_RTOL)


@pytest.mark.parametrize("K", [1, 4, 8, 9, 17, 64])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_value_batch_matches_jax(oracles, cfg, K):
    """K = 8, 9, 17: one P=1 kernel block of 8 candidates, two and three."""
    xla, pk, port, _, _ = oracles[cfg]
    U = plans(K, 10 + K)
    n0 = CO.value_batch_kernel.launches
    v = port.value_batch(torch.from_numpy(U)).numpy()
    assert CO.value_batch_kernel.launches == n0        # CPU: plain version
    assert v.shape == (K,)
    np.testing.assert_allclose(v, np.asarray(xla.value_batch(jnp.asarray(U))),
                               rtol=VAL_RTOL)
    if K <= 4:      # the interpret-mode kernel unrolls K: K=64 is XLA's alone
        np.testing.assert_allclose(v, np.asarray(pk.value_batch(jnp.asarray(U))),
                                   rtol=VAL_RTOL)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_value_and_grad_matches_jax(oracles, cfg):
    xla, pk, port, _, _ = oracles[cfg]
    u = plans(1, 7)[0]
    v, g = port.value_and_grad(torch.from_numpy(u))
    assert g.shape == (H, 4)
    for ref in (xla, pk):
        v_r, g_r = ref.value_and_grad(jnp.asarray(u))
        assert float(v) == pytest.approx(float(v_r), rel=VAL_RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_trajectory_matches_jax(oracles, cfg):
    _, pk, port, b, (x0, _, _) = oracles[cfg]
    u = plans(1, 9)[0]
    x = port.trajectory(torch.from_numpy(u)).numpy()
    assert x.shape == (H + 1, 13)
    np.testing.assert_allclose(x, np.asarray(pk.trajectory(jnp.asarray(u))),
                               rtol=X_RTOL, atol=1e-6)
    ref = rollout_mean(b.model, b.params, jnp.asarray(x0), jnp.asarray(u), b.time_steps)
    np.testing.assert_allclose(x, np.asarray(ref), rtol=X_RTOL, atol=1e-6)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_padded_trunk_is_the_same_function(oracles, repo_root, cfg):
    """``goldens.padded_trunk`` without a seed (the shipped trunk
    zero-padded to 72 units, a width that takes the shared-memory step of
    ``value_batch`` and ``trajectory``) computes the shipped trunk's costs
    and rollout."""
    _, _, port, _, (x0, x_ref, u_prev) = oracles[cfg]
    tb = load_port_bundles(repo_root)[CONFIGS[cfg]]
    T = torch.from_numpy
    padded = CO.cost_oracle(tb.model, padded_trunk(tb.params, 72), tb.cost_params,
                            tb.time_steps, T(x0), T(x_ref), T(u_prev), None, 1, 4)
    assert padded_trunk(tb.params, 72)["net"]["w1"].shape == (72, 72)
    U = torch.from_numpy(plans(9, 90))
    torch.testing.assert_close(padded.value_batch(U), port.value_batch(U), rtol=VAL_RTOL, atol=0)
    torch.testing.assert_close(padded.trajectory(U[0]), port.trajectory(U[0]),
                               rtol=X_RTOL, atol=1e-6)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_padded_trunk_with_new_units_matches_jax(oracles, repo_root, cfg):
    """``goldens.padded_trunk`` with a seed (72 units, the 8 new ones drawn
    like the shipped units; what the card checks of the shared-memory step
    run on): the plain oracle matches JAX's XLA oracle on the same weights,
    the costs stay in the shipped trunk's range, and the new units move
    them by far more than the tolerance, so a step that dropped them would
    fail those checks."""
    xla, _, port, b, (x0, x_ref, u_prev) = oracles[cfg]
    tb = load_port_bundles(repo_root)[CONFIGS[cfg]]
    params = padded_trunk(tb.params, 72, seed=0)
    T = torch.from_numpy
    wide = CO.cost_oracle(tb.model, params, tb.cost_params, tb.time_steps, T(x0), T(x_ref),
                          T(u_prev), None, 1, 4)
    jparams = dict(b.params, net={k: jnp.asarray(v.numpy()) for k, v in params["net"].items()})
    cost_fn = make_cost_fn(b.cost_params, b.time_steps)

    def seq_cost(u):
        xp, sg = rollout_sde(b.model, jparams, jnp.asarray(x0), u, b.time_steps,
                             jax.random.PRNGKey(0), 1, deterministic=True)
        return cost_fn(xp, sg, u, jnp.asarray(x_ref), jnp.asarray(u_prev))

    U = plans(17, 72)
    v = wide.value_batch(T(U)).numpy()
    np.testing.assert_allclose(v, np.asarray(JaxOracle.from_fn(seq_cost).value_batch(
        jnp.asarray(U))), rtol=VAL_RTOL)
    x = wide.trajectory(T(U[0])).numpy()
    ref = rollout_mean(b.model, jparams, jnp.asarray(x0), jnp.asarray(U[0]), b.time_steps)
    np.testing.assert_allclose(x, np.asarray(ref), rtol=X_RTOL, atol=1e-6)
    v0 = port.value_batch(T(U)).numpy()
    assert np.abs(v / v0 - 1).max() > 100 * VAL_RTOL
    assert np.abs(x - port.trajectory(T(U[0])).numpy()).max() > 100 * X_RTOL
    assert 0.9 * v0.min() < v.min() and v.max() < 1.1 * v0.max()


def test_scope_and_inputs_are_checked(oracles, repo_root):
    tb = load_port_bundles(repo_root)["iris_posctrl_mpc"]
    T = torch.from_numpy
    x0, x_ref, u_prev = (T(a) for a in oracles["pos"][4])
    args = (tb.model, tb.params, tb.cost_params, tb.time_steps, x0, x_ref, u_prev)
    # particles: a Monte-Carlo oracle needs its (P, H, 13) Brownian block,
    # and a chunk must divide P (solve_kernels.py:221-222; at P=1 too)
    with pytest.raises(ValueError, match="Brownian block"):
        CO.cost_oracle(*args, None, 4, 4)
    with pytest.raises(ValueError, match="noise"):
        CO.cost_oracle(*args, torch.zeros(H, 4, 13), 4, 4)
    with pytest.raises(ValueError, match="divide"):
        CO.cost_oracle(*args, torch.zeros(4, H, 13), 4, 4, chunk=3)
    with pytest.raises(ValueError, match="divide"):
        CO.cost_oracle(*args, None, 1, 4, chunk=4)
    # P=1 is the mean dynamics, whatever noise comes with it (as the original)
    u = torch.from_numpy(plans(1, 3)[0])
    assert float(CO.cost_oracle(*args, torch.ones(1, H, 13), 1, 4).value(u)) == \
        float(oracles["pos"][2].value(u))
    with pytest.raises(ValueError, match="x_ref"):
        CO.cost_oracle(*args[:5], x_ref[:-1], u_prev, None, 1, 4)
    port = oracles["pos"][2]
    with pytest.raises(ValueError, match="nZ=4 columns"):   # no slack columns here
        port.value(torch.zeros(H, 6))
    with pytest.raises(ValueError, match="float32"):
        port.value_and_grad(torch.zeros(H, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        port.trajectory(torch.zeros(4, H).t())
    with pytest.raises(ValueError, match="value_batch takes"):
        port.value_batch(torch.zeros(H, 4))


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(repo_root):
    """The three CUDA kernels against the plain oracle on the card, both
    iris configs, value_batch at K = 1, 4, 9, 17, 64, 256 (8 candidates per
    block), with one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile

    dev = torch.device("cuda")
    for name in CONFIGS.values():
        b = load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{name}.yaml"),
                                  device=dev)[3]
        x0, x_ref, u_prev, _ = (torch.from_numpy(a).to(dev) for a in
                                problem(b.cost_params.uref.cpu().numpy()))
        args = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev,
                None, 1, 4)
        kern, plain = CO.cost_oracle(*args), CO.cost_oracle_plain(*args)
        for K in (1, 4, 9, 17, 64, 256):
            U = torch.from_numpy(plans(K, K)).to(dev)
            n0 = CO.value_batch_kernel.launches
            vk = kern.value_batch(U)
            torch.cuda.synchronize()
            assert CO.value_batch_kernel.launches == n0 + 1
            torch.testing.assert_close(vk, plain.value_batch(U), rtol=VAL_RTOL, atol=0)
        u = torch.from_numpy(plans(1, 7)[0]).to(dev)
        vk, gk = kern.value_and_grad(u)
        vp, gp = plain.value_and_grad(u)
        torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0)
        torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
        torch.testing.assert_close(kern.trajectory(u), plain.trajectory(u),
                                   rtol=X_RTOL, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("P, chunk, antithetic", [(8, 0, False), (64, 16, False),
                                                  (512, 0, True), (1024, 0, True),
                                                  (96, 32, False)])
def test_particle_kernels_match_plain_on_cuda(repo_root, P, chunk, antithetic):
    """The noise and chunk branches of ``value_batch`` (K=4) and
    ``value_and_grad`` against the plain particle oracle on the card, both
    iris configs, the same torch draws; ``trajectory`` stays the mean
    rollout. Both kernels run a plan's chunks on a cluster (P=1024: more
    chunks than blocks; P=96 in chunks of 32: 3 blocks; ``value_batch`` one
    cluster per candidate): ``value_batch`` at ``cluster=1`` gives the same
    bits, ``value_and_grad`` the same numbers (rtol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian

    dev = torch.device("cuda")
    for name in CONFIGS.values():
        b = load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{name}.yaml"),
                                  device=dev)[3]
        x0, x_ref, u_prev, _ = (torch.from_numpy(a).to(dev) for a in
                                problem(b.cost_params.uref.cpu().numpy()))
        z = draw_brownian(torch.Generator().manual_seed(P), H, P, antithetic,
                          dev).transpose(0, 1)
        args = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev,
                z, P, 4)
        kern = CO.cost_oracle(*args, chunk=chunk)
        plain = CO.cost_oracle_plain(*args, chunk=chunk)
        U = torch.from_numpy(plans(4, P)).to(dev)
        n0 = CO.value_batch_kernel.launches
        vk = kern.value_batch(U)
        torch.cuda.synchronize()
        assert CO.value_batch_kernel.launches == n0 + 1
        torch.testing.assert_close(vk, plain.value_batch(U), rtol=VAL_RTOL, atol=0)
        one = CO.cost_oracle(*args, chunk=chunk, cluster=1)
        for Ub in (U, torch.from_numpy(plans(9, P + 9)).to(dev)):
            torch.testing.assert_close(kern.value_batch(Ub), one.value_batch(Ub), rtol=0, atol=0)
        u = U[1].contiguous()
        vk, gk = kern.value_and_grad(u)
        vp, gp = plain.value_and_grad(u)
        torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0)
        torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
        torch.testing.assert_close(kern.trajectory(u), plain.trajectory(u),
                                   rtol=X_RTOL, atol=1e-6)
        v1, g1 = one.value_and_grad(u)
        torch.testing.assert_close(v1, vk, rtol=1e-6, atol=0)
        torch.testing.assert_close(g1, gk, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("P, chunk", [(1, 0), (8, 4)])
@pytest.mark.parametrize("form", ["penalty", "prox"])
def test_constraint_kernels_match_plain_on_cuda(repo_root, form, P, chunk):
    """The state-constraint branches of ``value_batch`` (K = 1, 4, 64, 256) and
    ``value_and_grad`` against the plain oracle on the card, on the shipped
    constrained config and its penalty form (nZ = 10 wide plans in the
    proximal form), the same torch draws at P=8; ``trajectory`` reads the
    control columns of an nZ-wide plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian

    dev = torch.device("cuda")
    b = constrained_bundle(repo_root, form, dev)
    x0, x_ref, u_prev, _ = constrained_problem(b)
    z = None if P == 1 else draw_brownian(torch.Generator().manual_seed(P), H, P, True,
                                          dev).transpose(0, 1)
    args = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev, z, P, 4)
    kern = CO.cost_oracle(*args, chunk=chunk)
    plain = CO.cost_oracle_plain(*args, chunk=chunk)
    m = b.cost_params.n_slack
    for K in (1, 4, 64, 256):
        U = constrained_plans(b, K, K)
        n0 = CO.value_batch_kernel.launches
        vk = kern.value_batch(U)
        torch.cuda.synchronize()
        assert CO.value_batch_kernel.launches == n0 + 1
        torch.testing.assert_close(vk, plain.value_batch(U), rtol=VAL_RTOL, atol=0)
    u = U[1].contiguous()
    vk, gk = kern.value_and_grad(u)
    vp, gp = plain.value_and_grad(u)
    assert gk.shape == (H, 4 + m)
    torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0)
    torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(kern.trajectory(u), plain.trajectory(u), rtol=X_RTOL, atol=1e-6)


@pytest.mark.cuda
def test_floor_value_batch_matches_plain_on_cuda(repo_root):
    """The altitude floor of ``examples/noise_robustness.py`` (penalty form,
    P=128 antithetic, the example's diffusion scale 0.6): ``value_batch``
    (K = 1, 4) against the plain oracle, and on its clusters (4 chunks of
    32) against one block per candidate with equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    import math

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian

    dev = torch.device("cuda")
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(num_particles=128, antithetic=True)
    cfg["state_constr"] = {"state_id": [2], "state_bound": [[-5.0, -1.2]],
                           "state_penalty": [300.0], "slack_scaling": [1.0]}
    b = make_mpc_from_config(cfg, device=dev)[3]
    b.params["diffusion_log_scale"].fill_(math.log(0.6))
    x0, x_ref, u_prev, _ = constrained_problem(b)
    z = draw_brownian(torch.Generator().manual_seed(128), H, 128, True, dev).transpose(0, 1)
    args = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev, z, 128, 4)
    kern, plain = CO.cost_oracle(*args), CO.cost_oracle_plain(*args)
    one = CO.cost_oracle(*args, cluster=1)
    for K in (1, 4):
        U = torch.from_numpy(plans(K, 128 + K)).to(dev)
        vk = kern.value_batch(U)
        torch.testing.assert_close(vk, plain.value_batch(U), rtol=VAL_RTOL, atol=0)
        torch.testing.assert_close(vk, one.value_batch(U), rtol=0, atol=0)


@pytest.mark.cuda
def test_padded_trunk_runs_on_cuda(repo_root):
    """The posctrl trunk padded to 72 units (8 new units drawn like the
    shipped ones), outside the P=1 register layout: ``value_batch`` (K = 1,
    20, 64) and ``trajectory`` still run on their kernels (the shared-memory
    step) and match the plain oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile

    dev = torch.device("cuda")
    b = load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"),
                              device=dev)[3]
    x0, x_ref, u_prev, _ = (torch.from_numpy(a).to(dev) for a in
                            problem(b.cost_params.uref.cpu().numpy()))
    args = (b.model, padded_trunk(b.params, 72, seed=0), b.cost_params, b.time_steps, x0,
            x_ref, u_prev, None, 1, 4)
    kern, plain = CO.cost_oracle(*args), CO.cost_oracle_plain(*args)
    for K in (1, 20, 64):
        U = torch.from_numpy(plans(K, K)).to(dev)
        n0 = CO.value_batch_kernel.launches
        vk = kern.value_batch(U)
        torch.cuda.synchronize()
        assert CO.value_batch_kernel.launches == n0 + 1
        torch.testing.assert_close(vk, plain.value_batch(U), rtol=VAL_RTOL, atol=0)
    u = torch.from_numpy(plans(1, 7)[0]).to(dev)
    n0 = CO.trajectory_kernel.launches
    xk = kern.trajectory(u)
    assert CO.trajectory_kernel.launches == n0 + 1
    torch.testing.assert_close(xk, plain.trajectory(u), rtol=X_RTOL, atol=1e-6)
