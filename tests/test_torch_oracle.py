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
``test_particle_kernels_match_plain_on_cuda`` and
``test_constraint_kernels_match_plain_on_cuda`` hold the three CUDA kernels
to the plain version on the card (P=1; P=8, P=64 in chunks of 16 and P=512
antithetic; each state-constraint form at P=1 and at P=8 in chunks of 4)
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
from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_plans, constrained_problem
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


@pytest.mark.parametrize("K", [1, 4, 64])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_value_batch_matches_jax(oracles, cfg, K):
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
    iris configs, value_batch at K = 1, 4, 64, 256, with one launch each."""
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
        for K in (1, 4, 64, 256):
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
    rollout. ``value_and_grad`` runs its chunks on a cluster (P=1024: more
    chunks than blocks; P=96 in chunks of 32: 3 blocks), and one block
    gives the same numbers (rtol 1e-6)."""
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
        u = U[1].contiguous()
        vk, gk = kern.value_and_grad(u)
        vp, gp = plain.value_and_grad(u)
        torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0)
        torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
        torch.testing.assert_close(kern.trajectory(u), plain.trajectory(u),
                                   rtol=X_RTOL, atol=1e-6)
        v1, g1 = CO.cost_oracle(*args, chunk=chunk, cluster=1).value_and_grad(u)
        torch.testing.assert_close(v1, vk, rtol=1e-6, atol=0)
        torch.testing.assert_close(g1, gk, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("P, chunk", [(1, 0), (8, 4)])
@pytest.mark.parametrize("form", ["penalty", "prox"])
def test_constraint_kernels_match_plain_on_cuda(repo_root, form, P, chunk):
    """The state-constraint branches of ``value_batch`` (K = 1, 4, 64) and
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
    for K in (1, 4, 64):
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
