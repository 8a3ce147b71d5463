"""Port parity, scenario-robust starts (``initial_state_std``): the port's
plain path against the JAX package's XLA path on the CPU, with JAX's own
draws injected.

- ``draw_start_spread``: one generator call, antithetic halves exact
  negatives (the pairs of ``draw_brownian``), an odd antithetic P refused;
- ``rollout_sde`` with the start spread against the JAX ``rollout_sde`` on
  JAX's ``z0`` (``fold_in(rng, 0x5EED)``), rtol 1e-5, and the statistics of
  ``tests/test_rollout.py:204`` (the requested std, velocities untouched,
  unit quaternions, no spread without it);
- the loader's draw order with a generator: the Brownian block, then
  ``z0``; ``initial_state_std`` a scalar or a 13-vector;
- the first ``mpc_fn`` solve with starts, and with starts and risk, for
  linesearch and fixed-step APG against the JAX ``mpc_fn`` (equal
  ``num_steps``, rtol 2e-4 / atol 2e-5);
- one batched tick with risk and starts (B = 2) against the JAX package's
  vmapped solve on its per-scenario draws (the particle tolerance 5e-4);
- ``cuda``: the start branch of each particle kernel, alone and with risk,
  against its plain version on the card, and a batched launch against its
  solo launches bit for bit; skips without one.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_solve_lockstep, first_solve_pair, jax_solve_draws
from sde4mbrl_px4_tpu.core.types import hover_state as j_hover_state
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.rollout import draw_brownian as j_draw_brownian
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde as j_rollout_sde
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.ops.rollout import (draw_brownian, draw_start_spread,
                                                particle_starts, rollout_sde)

H = 20
T = torch.from_numpy
# uncertainty_mpc.py's state-noise stds: position, velocity, none on the
# quaternion, body rates
STATE_STD = [0.15] * 3 + [0.1] * 3 + [0.0] * 4 + [0.05] * 3


def test_draw_start_spread_structure():
    """One generator call of (P, 13) normals (P/2 antithetic, mirrored);
    a leading batch shape; odd antithetic P refused."""
    z = draw_start_spread(torch.Generator().manual_seed(3), 6)
    assert z.shape == (6, 13) and z.dtype == torch.float32
    assert torch.equal(z, torch.randn((6, 13), generator=torch.Generator().manual_seed(3)))
    za = draw_start_spread(torch.Generator().manual_seed(3), 6, antithetic=True)
    assert torch.equal(za[3:], -za[:3])
    assert torch.equal(za[:3], torch.randn((3, 13), generator=torch.Generator().manual_seed(3)))
    zb = draw_start_spread(torch.Generator().manual_seed(3), 4, True, batch=(2,))
    assert zb.shape == (2, 4, 13) and torch.equal(zb[:, 2:], -zb[:, :2])
    with pytest.raises(ValueError, match="even particle count"):
        draw_start_spread(torch.Generator(), 7, antithetic=True)


@pytest.mark.parametrize("antithetic", [False, True])
def test_rollout_sde_start_spread_matches_jax(iris_model, repo_root, antithetic):
    """The rollout of ``tests/test_rollout.py:204`` (P=256, H=4, a 0.2 m
    position spread) on JAX's own ``z0``, against the JAX rollout (rtol
    1e-5), and its statistics on the port."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile

    model, params = iris_model
    tb = load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"),
                               device="cpu")[3]
    x0 = j_hover_state()
    h, P = 4, 256
    u = jnp.full((h, 4), model.vehicle.hover_u, jnp.float32)
    ts = jnp.full((h,), 0.05, jnp.float32)
    std = np.zeros(13, np.float32)
    std[0:3] = 0.2
    rng = jax.random.PRNGKey(3)
    xp_j, sg_j = j_rollout_sde(model, params, x0, u, ts, rng, P, x0_spread=jnp.asarray(std),
                               antithetic=antithetic)
    noise = T(np.array(j_draw_brownian(rng, h, P, antithetic=antithetic)))
    z0 = T(np.array(j_draw_brownian(jax.random.fold_in(rng, 0x5EED), 1, P,
                                    antithetic=antithetic)[0]))
    x0_t, u_t, ts_t = T(np.array(x0)), T(np.array(u)), T(np.array(ts))
    xp, sg = rollout_sde(tb.model, tb.params, x0_t, u_t, ts_t, noise, x0_spread=T(std), z0=z0)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xp_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sg.numpy(), np.asarray(sg_j), rtol=1e-5, atol=1e-7)
    starts = xp[:, 0].numpy()
    assert abs(starts[:, 0].std() - 0.2) < 0.04
    np.testing.assert_allclose(starts[:, 3:6], 0.0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(starts[:, 6:10], axis=1), 1.0, atol=1e-5)
    torch.testing.assert_close(xp[:, 0], particle_starts(x0_t, T(std), z0), rtol=0, atol=0)
    xp0, _ = rollout_sde(tb.model, tb.params, x0_t, u_t, ts_t, noise)
    assert float(np.ptp(xp0[:, 0].numpy(), axis=0).max()) == 0.0


@pytest.mark.parametrize("std", [0.05, STATE_STD])
def test_loader_draws_block_then_starts(repo_root, monkeypatch, std):
    """With a generator a solve draws its Brownian block, then ``z0``
    (antithetic-paired), one call each; the wrapper gets the starts
    ``renorm_quat(x + std * z0)`` with ``std`` broadcast to 13."""
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader as tloader
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(num_particles=8, antithetic=True, initial_state_std=std)
    cfg["apg_mpc"].update(max_iter=2, max_no_improvement_iter=2)
    seen = []
    orig = tloader.apg_solve_kernel_batched

    def spy(*args, **kw):
        seen.append((args[8].clone(), kw["starts"].clone()))
        return orig(*args, **kw)

    monkeypatch.setattr(tloader, "apg_solve_kernel_batched", spy)
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg, device="cpu")
    x = torch.zeros(13)
    x[6], x[0] = 1.0, 0.4
    mpc_fn(x, torch.Generator().manual_seed(5), reset_fn(x, None, x), 0.0, x)
    ref = torch.Generator().manual_seed(5)
    noise = draw_brownian(ref, H, 8, True).reshape(1, H, 8, 13).transpose(1, 2)
    z0 = draw_start_spread(ref, 8, True, batch=(1,))
    std13 = torch.tensor(np.broadcast_to(np.asarray(std, np.float32), (13,)).copy())
    assert len(seen) == 1
    assert torch.equal(seen[0][0], noise)
    assert torch.equal(seen[0][1], particle_starts(x[None], std13, z0))


@pytest.mark.parametrize("route", ["linesearch", "fixed_step"])
@pytest.mark.parametrize("risk", [False, True])
def test_mpc_fn_starts_first_solve_matches_jax(repo_root, route, risk):
    """The first solve with ``uncertainty_mpc.py``'s state-noise stds (P=8
    antithetic), alone and with ``risk_lambda: 2``, through both
    ``mpc_fn``s on JAX's draws (its block and ``z0``): the linesearch
    posctrl config and its fixed-step form (stepsize 1e-5), 8 iterations."""
    cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(num_particles=8, antithetic=True, initial_state_std=STATE_STD)
    if risk:
        cfg["cost_params"]["risk_lambda"] = 2.0
    if route == "fixed_step":
        del cfg["apg_mpc"]["linesearch"]
        cfg["apg_mpc"]["stepsize"] = 1e-5
    cfg["apg_mpc"].update(max_iter=8, max_no_improvement_iter=8)
    sol_j, sol_t, _ = first_solve_pair(cfg, jax_solve_draws(8, 1, True, spread=True))
    assert_solve_lockstep(sol_j, sol_t)


def test_batched_tick_with_risk_and_starts_matches_jax(repo_root):
    """One batched call (B = 2, P = 8 antithetic, ``risk_lambda: 2`` and a
    start spread, horizon 6) against the JAX package's vmapped solve, each
    scenario on its own key's draws (``split(rng)``, the block, ``z0``):
    equal steps, plans and costs within 5e-4."""
    from sde4mbrl_px4_tpu.parallel import batched as jbatched
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc

    h, P, B = 6, 8, 2
    cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=h, num_short_dt=h, num_particles=P, antithetic=True,
               initial_state_std=0.05)
    cfg["cost_params"]["risk_lambda"] = 2.0
    cfg["apg_mpc"].update(max_iter=6, max_no_improvement_iter=6)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    j_reset, j_mpc, _ = jbatched.make_batched_mpc(copy.deepcopy(cfg), mesh)
    xs_j, rngs = jbatched.make_batch_inputs(mesh, B, seed=3, spread=0.3)
    t_reset, t_mpc, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    xs_np = np.array(xs_j)
    xdes = xs_np.copy()
    xdes[:, 0] += 0.5
    noise, z0 = [], []
    for b in range(B):
        key, _ = jax.random.split(rngs[b])
        noise.append(np.array(j_draw_brownian(key, h, P, antithetic=True)).transpose(1, 0, 2))
        z0.append(np.array(j_draw_brownian(jax.random.fold_in(key, 0x5EED), 1, P,
                                           antithetic=True)[0]))
    draws = iter([(T(np.ascontiguousarray(np.stack(noise))), T(np.stack(z0)))])
    sol_j = j_mpc(xs_j, rngs, j_reset(xs_j, rngs, xs_j), jnp.zeros(B), jnp.asarray(xdes))
    xs = T(xs_np)
    sol_t = t_mpc(xs, draws, t_reset(xs, None, xs), torch.zeros(B), T(xdes))
    np.testing.assert_array_equal(sol_t.opt_state.num_steps.numpy(),
                                  np.asarray(sol_j.opt_state.num_steps))
    np.testing.assert_allclose(sol_t.u_opt.numpy(), np.asarray(sol_j.u_opt), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(sol_t.opt_state.opt_cost.numpy(),
                               np.asarray(sol_j.opt_state.opt_cost), rtol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("P, chunk", [(512, 0), (1024, 0), (64, 16)])
def test_start_kernels_match_plain_on_cuda(repo_root, P, chunk):
    """The start branch of the particle kernels (``uncertainty_mpc.py``'s
    stds, antithetic), alone and with ``risk_lambda: 2``, against the plain
    versions on the card on the same draws: the whole solve at max_iter 5
    (equal steps, yk rtol 5e-4 / atol 5e-5), ``value_batch`` K = 4 (rtol
    5e-4) and ``value_and_grad`` (5e-4; gradient 5e-4 / 5e-5); then a
    batched launch of B = 3 scenarios with their own starts against their
    solo launches, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(P)
    for risk in (None, 2.0):
        cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
        cfg["cost_params"]["risk_lambda"] = risk
        cfg.update(num_particles=P, antithetic=True, initial_state_std=STATE_STD)
        b = make_mpc_from_config(cfg, device=dev)[3]
        apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
        x0 = torch.zeros(3, 13, device=dev)
        x0[:, 6] = 1.0
        x0[:, 0] = torch.tensor([0.3, -0.2, 0.1])
        x_ref = torch.zeros(3, H + 1, 13, device=dev)
        x_ref[..., 6] = 1.0
        u_prev = b.cost_params.uref.expand(3, 4).contiguous()
        u_init = (u_prev[:, None] + 0.02).expand(3, H, 4).contiguous()
        z = torch.stack([draw_brownian(gen, H, P, True, dev).transpose(0, 1) for _ in range(3)])
        std = torch.tensor(STATE_STD, device=dev)
        starts = particle_starts(x0, std, draw_start_spread(gen, P, True, dev, batch=(3,)))
        starts = starts.contiguous()
        solo = [AK.apg_solve_kernel(b.model, b.params, b.cost_params, apg, b.time_steps, x0[i],
                                    x_ref[i], u_prev[i], z[i], P, b.lb, b.ub, u_init[i],
                                    precond=b.precond, chunk=chunk, starts=starts[i])[0]
                for i in range(3)]
        st_b, _ = AK.apg_solve_kernel_batched(b.model, b.params, b.cost_params, apg,
                                              b.time_steps, x0, x_ref, u_prev, z, P, b.lb,
                                              b.ub, u_init, precond=b.precond, chunk=chunk,
                                              starts=starts)
        torch.cuda.synchronize()
        for i in range(3):
            assert torch.equal(st_b.yk[i], solo[i].yk)
        st_p, _ = AK.apg_solve_plain(b.model, b.params, b.cost_params, apg, b.time_steps,
                                     x0[0], x_ref[0], u_prev[0], z[0], P, b.lb, b.ub,
                                     u_init[0], precond=b.precond, chunk=chunk,
                                     starts=starts[0])
        assert int(solo[0].num_steps) == int(st_p.num_steps)
        np.testing.assert_allclose(solo[0].yk.cpu().numpy(), st_p.yk.cpu().numpy(),
                                   rtol=5e-4, atol=5e-5)
        args = (b.model, b.params, b.cost_params, b.time_steps, x0[0], x_ref[0], u_prev[0],
                z[0], P, 4)
        orc = CO.cost_oracle(*args, chunk=chunk, starts=starts[0])
        plain = CO.cost_oracle_plain(*args, chunk=chunk, starts=starts[0])
        U = (u_init[0] + 0.05 * torch.rand((4, H, 4), generator=gen).to(dev)).contiguous()
        np.testing.assert_allclose(orc.value_batch(U).cpu().numpy(),
                                   plain.value_batch(U).cpu().numpy(), rtol=5e-4)
        v_k, g_k = orc.value_and_grad(u_init[0])
        v_p, g_p = plain.value_and_grad(u_init[0])
        assert float(v_k) == pytest.approx(float(v_p), rel=5e-4)
        np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), rtol=5e-4, atol=5e-5)
