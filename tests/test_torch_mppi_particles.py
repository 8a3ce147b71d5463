"""Port parity, MPPI over K x P paths (``solver: mppi`` with
``num_particles`` P > 1): each round's K candidates priced on the solve's
P shared Brownian paths (the particle ``value_batch``; on the CPU its plain
version), against the JAX package's XLA path with its own draws injected.

- the first ``mpc_fn`` solve at P=8 antithetic (K=16, 4 rounds), plain and
  with ``risk_lambda: 2`` and a start spread, in lockstep with the JAX
  ``mpc_fn`` (rtol 1e-5, ``tests/test_torch_mppi.py``'s tolerance; its
  ``x_evol`` the mean rollout of its own plan at rtol 1e-5);
- the draws with a generator, in the loader's order: the Brownian block,
  then ``z0``, then MPPI's ``(eps, c0)``; every candidate of a round and
  every round share the solve's block, and the iterator's ``(eps, c0,
  noise[, z0])`` must match the config;
- a batched MPPI call (B = 2) equals its two solo ``mpc_fn`` solves;
- ``cuda``: a family-style replay at K = 64, P = 128 antithetic through the
  kernels against the plain oracle (1e-4), one particle ``value_batch``
  launch a round; skips without one.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import first_solve_pair, jax_solve_draws
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean as j_rollout_mean
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian, draw_start_spread
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig, draw_mppi_noise

H = 20
MPPI_SMALL = {"samples": 16, "iters": 4}


def mppi_config(repo_root, P=8, **top):
    cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(solver="mppi", mppi=dict(MPPI_SMALL), num_particles=P, antithetic=True, **top)
    return cfg


@pytest.mark.parametrize("options", ["paths", "risk_and_starts"])
def test_mpc_fn_mppi_particles_lockstep_with_jax(repo_root, options):
    """The first MPPI solve over K x P paths through both ``mpc_fn``s, the
    port on JAX's draws (``split(rng, 3)``: the block, its ``z0``, MPPI's
    eps and c0): plan, costs and ``x_evol`` at rtol 1e-5."""
    cfg = mppi_config(repo_root)
    spread = options == "risk_and_starts"
    if spread:
        cfg["cost_params"]["risk_lambda"] = 2.0
        cfg["initial_state_std"] = 0.05
    mcfg = MPPIConfig.from_config(cfg)
    jb = j_make(copy.deepcopy(cfg))[3]
    sol_j, sol_t, tb = first_solve_pair(
        cfg, jax_solve_draws(8, 1, True, spread=spread, mppi_cfg=mcfg))
    assert tb.num_particles == 8
    np.testing.assert_allclose(sol_t.u_opt.numpy(), np.asarray(sol_j.u_opt), rtol=1e-5,
                               atol=1e-6)
    for f in ("init_cost", "opt_cost"):
        assert float(getattr(sol_t.opt_state, f)) == pytest.approx(
            float(getattr(sol_j.opt_state, f)), rel=1e-5), f
    for f in ("num_steps", "avg_linesearch"):
        assert float(getattr(sol_t.opt_state, f)) == float(getattr(sol_j.opt_state, f)), f
    # x_evol: the mean rollout of the port's own plan, and as close to the
    # JAX one as the plans' rollouts are
    ref = j_rollout_mean(jb.model, jb.params, jnp.asarray(sol_t.x_evol[0].numpy()),
                         jnp.asarray(sol_t.u_opt.numpy()), jb.time_steps)
    np.testing.assert_allclose(sol_t.x_evol.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sol_t.x_evol.numpy(), np.asarray(sol_j.x_evol), rtol=1e-4,
                               atol=1e-5)


def test_mppi_particles_draw_order_and_shared_paths(repo_root, monkeypatch):
    """With a generator one solve draws the block, then ``z0``, then MPPI's
    (eps, c0), one call each; the oracle is built once per solve on that
    block and its starts, so every candidate of every round sees the same
    P paths."""
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader as tloader
    from sde4mbrl_px4_tpu_torch.ops.rollout import particle_starts

    cfg = mppi_config(repo_root, initial_state_std=0.05)
    seen = []
    orig = tloader.cost_oracle_batched

    def spy(*args, **kw):
        seen.append((args[7].clone(), kw["starts"].clone()))
        oracle = orig(*args, **kw)
        calls = []

        def value_batch(U):
            calls.append(U.shape)
            return oracle.value_batch(U)

        seen.append(calls)
        return oracle._replace(value_batch=value_batch,
                               value=lambda u: value_batch(u[:, None])[:, 0])

    monkeypatch.setattr(tloader, "cost_oracle_batched", spy)
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    x = torch.zeros(13)
    x[6], x[0] = 1.0, 0.4
    sol = mpc_fn(x, torch.Generator().manual_seed(2), reset_fn(x, None, x), 0.0, x)
    ref = torch.Generator().manual_seed(2)
    noise = draw_brownian(ref, H, 8, True).reshape(1, H, 8, 13).transpose(1, 2)
    z0 = draw_start_spread(ref, 8, True, batch=(1,))
    draw_mppi_noise(ref, MPPIConfig.from_config(cfg), H, 4, "cpu", batch=(1,))
    assert len(seen) == 2                     # one oracle a solve
    assert torch.equal(seen[0][0], noise)
    assert torch.equal(seen[0][1], particle_starts(x[None], torch.full((13,), 0.05), z0))
    # the warm start's value, 4 rounds of 16 candidates, the result's value
    assert seen[1] == [(1, 1, H, 4)] + [(1, 16, H, 4)] * 4 + [(1, 1, H, 4)]
    assert float(sol.opt_state.num_steps) == 4 and torch.isfinite(sol.u_opt).all()
    gen = torch.Generator().manual_seed(2)
    mpc_fn(x, gen, reset_fn(x, None, x), 0.0, x)
    assert torch.equal(gen.get_state(), ref.get_state())     # nothing else is drawn


def test_mppi_particles_iterator_items_checked(repo_root):
    """An iterator's item carries the config's draws: ``(eps, c0, noise)``
    at P > 1 without a start spread; one more item is refused."""
    cfg = mppi_config(repo_root)
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    mcfg = MPPIConfig.from_config(cfg)
    gen = torch.Generator().manual_seed(0)
    eps, c0 = draw_mppi_noise(gen, mcfg, H, 4, "cpu")
    noise = draw_brownian(gen, H, 8, True).transpose(0, 1)
    x = torch.zeros(13)
    x[6] = 1.0
    st = reset_fn(x, None, x)
    sol = mpc_fn(x, iter([(eps, c0, noise)]), st, 0.0, x)
    assert torch.isfinite(sol.u_opt).all()
    with pytest.raises(ValueError, match="item\\(s\\) more"):
        mpc_fn(x, iter([(eps, c0, noise, noise[:, 0])]), st, 0.0, x)


def test_batched_mppi_particles_equal_solo(repo_root):
    """A batched MPPI call over K x P paths (B = 2, plain) gives each
    scenario the plan of its solo ``mpc_fn`` on the same draws (the CPU
    keeps torch's reductions, whose order does not depend on B here: each
    scenario's softmax is its own row)."""
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc

    cfg = mppi_config(repo_root, initial_state_std=0.05)
    cfg["cost_params"]["risk_lambda"] = 1.0
    t_reset, t_mpc, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    mcfg = MPPIConfig.from_config(cfg)
    gen = torch.Generator().manual_seed(4)
    eps, c0 = draw_mppi_noise(gen, mcfg, H, 4, "cpu", batch=(2,))
    noise = torch.stack([draw_brownian(gen, H, 8, True).transpose(0, 1) for _ in range(2)])
    z0 = draw_start_spread(gen, 8, True, batch=(2,))
    xs = torch.zeros(2, 13)
    xs[:, 6] = 1.0
    xs[:, 0] = torch.tensor([0.4, -0.3])
    sol_b = t_mpc(xs, iter([(eps, c0, noise, z0)]), t_reset(xs, None, xs), torch.zeros(2), xs)
    for b in range(2):
        sol = mpc_fn(xs[b], iter([(eps[b], c0[b], noise[b], z0[b])]),
                     reset_fn(xs[b], None, xs[b]), 0.0, xs[b])
        torch.testing.assert_close(sol_b.u_opt[b], sol.u_opt, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(sol_b.opt_state.opt_cost[b], sol.opt_state.opt_cost,
                                   rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_mppi_particles_kernel_matches_plain_on_cuda(repo_root):
    """K = 64 candidates x P = 128 antithetic paths, 4 chained solves from
    a 1 m offset to a hover hold through ``mpc_fn`` on the card and through
    the plain oracle
    on the card with the same generator draws: |du| <= 1e-4 per row; one
    particle ``value_batch`` launch a round (plus the warm start's and the
    result's value) and one ``trajectory`` launch a solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    dev = torch.device("cuda")
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(solver="mppi", num_particles=128, antithetic=True)
    _, (reset_k, mpc_k), _, b = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    mcfg = MPPIConfig.from_config(cfg)
    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned

    x = torch.zeros(13, device=dev)
    x[6], x[0] = 1.0, 1.0
    tgt = torch.zeros(13, device=dev)
    tgt[6] = 1.0
    x_ref = enu2ned(tgt).expand(H + 1, 13)        # the hold target in the solver's frame
    gk, gp = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    st_k = reset_k(x, gk, tgt)
    st_p = st_k
    xk = xp = x
    for _ in range(4):
        n0 = (CO.value_batch_kernel.launches, CO.trajectory_kernel.launches)
        sol_k = mpc_k(xk, gk, st_k, 0.0, tgt)
        torch.cuda.synchronize()
        assert (CO.value_batch_kernel.launches - n0[0], CO.trajectory_kernel.launches
                - n0[1]) == (mcfg.iters + 2, 1)
        with torch.no_grad():
            from sde4mbrl_px4_tpu_torch.ops.cuda.cost_oracle import cost_oracle_plain
            from sde4mbrl_px4_tpu_torch.solver.mppi import mppi_solve

            noise = draw_brownian(gp, H, 128, True, dev).transpose(0, 1)
            eps, c0 = draw_mppi_noise(gp, mcfg, H, 4, dev)
            orc = cost_oracle_plain(b.model, b.params, b.cost_params, b.time_steps, xp, x_ref,
                                    st_p.yk[0], noise, 128, 4)
            st = mppi_solve(orc, st_p.yk, b.lb, b.ub, mcfg, eps, c0)
        assert float((sol_k.u_opt - st.yk).abs().max()) <= 1e-4
        st_k, xk = sol_k.opt_state, sol_k.x_evol[1]
        st_p = st._replace(yk=torch.cat([st.yk[1:], st.yk[-1:]]))
        xp = orc.trajectory(st.yk)[1]
