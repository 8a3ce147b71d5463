"""Shared set-up of the port's solver parity tests: the problems of
``tests/test_apg_kernel.py::_solve_both`` solved by the JAX package's XLA
``apg_solve`` and by the port's ``apg_solve_kernel`` (on CPU tensors, its
plain version); the draws of the JAX ``mpc_fn`` and the first solve of both
``mpc_fn``s on them (the particle options' tests)."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.core.types import hover_state
from sde4mbrl_px4_tpu.cost.cost import make_cost_fn
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde
from sde4mbrl_px4_tpu.solver.apg import apg_solve
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.ops.rollout import draw_brownian as j_draw_brownian
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile, make_mpc_from_config
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

H = 20
# the lockstep tolerances of the mpc_fn solves (tests/test_sharding.py:87-88)
SOLVE_RTOL, SOLVE_ATOL = 2e-4, 2e-5
T = torch.from_numpy


def load_port_bundles(repo_root):
    return {name: load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{name}.yaml"),
                                        device="cpu")[3]
            for name in ("iris_traj_mpc", "iris_posctrl_mpc")}


def constrained_bundle(repo_root, form, device):
    """The port's bundle of ``configs/iris_constr_posctrl_mpc.yaml`` in the
    proximal form as shipped (``form="prox"``) or its penalty form."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_constr_posctrl_mpc.yaml"))
    cfg["state_constr"]["slack_proximal"] = form == "prox"
    return make_mpc_from_config(cfg, device=device)[3]


def problem(cp_uref, x_off=(0.3, 0.2)):
    x0 = np.asarray(hover_state()).copy()
    x0[0], x0[3] = x_off
    x_ref = np.tile(np.asarray(hover_state()), (H + 1, 1))
    u_prev = np.array(cp_uref, np.float32)
    u_init = np.tile(u_prev, (H, 1)) + np.float32(0.02)
    return x0, x_ref, u_prev, u_init


def solve_pair(jbundle, tb, max_iter, t_init=None, precond=None, iter_budget=None,
               **apg_overrides):
    """(XLA APGState, port APGState, port x_evol, problem) on one problem."""
    _, _, _, b = jbundle
    apg = b.apg_config._replace(max_iter=max_iter, max_no_improvement_iter=max_iter,
                                **apg_overrides)
    x0, x_ref, u_prev, u_init = problem(b.cost_params.uref)
    cost_fn = make_cost_fn(b.cost_params, b.time_steps)

    def seq_cost(u_seq):
        xp, sg = rollout_sde(b.model, b.params, jnp.asarray(x0), u_seq, b.time_steps,
                             jax.random.PRNGKey(0), 1, deterministic=True)
        return cost_fn(xp, sg, u_seq, jnp.asarray(x_ref), jnp.asarray(u_prev))

    st_x = apg_solve(seq_cost, jnp.asarray(u_init), b.lb, b.ub, apg,
                     t_init=None if t_init is None else jnp.float32(t_init),
                     precond=None if precond is None else jnp.asarray(precond),
                     iter_budget=iter_budget)
    tapg = tb.apg_config._replace(max_iter=max_iter, max_no_improvement_iter=max_iter,
                                  **apg_overrides)
    T = torch.from_numpy
    launches = AK.apg_solve_kernel.launches
    st_t, x_evol = AK.apg_solve_kernel(
        tb.model, tb.params, tb.cost_params, tapg, tb.time_steps, T(x0), T(x_ref),
        T(u_prev), None, 1, tb.lb, tb.ub, T(u_init),
        t_init=None if t_init is None else torch.tensor(t_init),
        precond=None if precond is None else T(np.asarray(precond, np.float32)),
        iter_budget=iter_budget)
    assert AK.apg_solve_kernel.launches == launches   # CPU: plain version
    return st_x, st_t, x_evol, (x0, x_ref, u_prev, u_init, apg)


def assert_lockstep(st_x, st_t, rtol, atol, stats=True):
    assert int(st_t.num_steps) == int(st_x.num_steps)
    np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_x.yk), rtol=rtol, atol=atol)
    assert float(st_t.opt_cost) == pytest.approx(float(st_x.opt_cost), rel=rtol)
    if stats:
        assert float(st_t.init_cost) == pytest.approx(float(st_x.init_cost), rel=2e-5)
        assert float(st_t.avg_linesearch) == pytest.approx(
            float(st_x.avg_linesearch), abs=1e-5)
        assert float(st_t.stepsize) == pytest.approx(float(st_x.stepsize), rel=1e-4)
        assert float(st_t.avg_stepsize) == pytest.approx(float(st_x.avg_stepsize), rel=1e-4)


def jax_solve_draws(P, n, antithetic, spread=False, mppi_cfg=None, H=H, n_u=4):
    """Each solve's draws as the JAX ``mpc_fn`` makes them from PRNGKey(0):
    APG ``(noise, next) = split(rng)``; MPPI ``(noise, mppi, next) =
    split(rng, 3)`` (``engine/mpc_loader.py:649-664``); the block
    ``draw_brownian(noise, H, P, antithetic)``; the starts' z0
    ``draw_brownian(fold_in(noise, 0x5EED), 1, P, antithetic)[0]``
    (``ops/rollout.py:165-167``); MPPI's draws from its key
    (``tests/test_torch_mppi.py::jax_draws``). Yields them in the forms
    ``mpc_fn``'s iterator takes: a (P, H, 13) block, ``(noise, z0)``, or
    ``(eps, c0, noise[, z0])``."""
    rng = jax.random.PRNGKey(0)
    for _ in range(n):
        if mppi_cfg is None:
            rng_noise, rng = jax.random.split(rng)
        else:
            rng_noise, rng_mppi, rng = jax.random.split(rng, 3)
        z = np.array(j_draw_brownian(rng_noise, H, P, antithetic=antithetic))
        out = [T(np.ascontiguousarray(z.transpose(1, 0, 2)))]
        if spread:
            z0 = j_draw_brownian(jax.random.fold_in(rng_noise, 0x5EED), 1, P,
                                 antithetic=antithetic)[0]
            out.append(T(np.array(z0)))
        if mppi_cfg is not None:
            key, eps, c0 = rng_mppi, [], []
            for _ in range(mppi_cfg.iters):
                key, sub, sub0 = jax.random.split(key, 3)
                eps.append(np.array(jax.random.normal(sub, (mppi_cfg.samples, H, n_u))))
                c0.append(np.array(jax.random.normal(sub0, (mppi_cfg.samples, n_u))))
            out = [T(np.stack(eps)), T(np.stack(c0)) if mppi_cfg.noise_beta > 0 else None] + out
        yield out[0] if len(out) == 1 else tuple(out)


def first_solve_pair(cfg, draws, x_offset=(0.5, -0.3)):
    """The first solve of both ``mpc_fn``s from the same state: the JAX one
    on PRNGKey(0), the port's on ``draws`` (JAX's own). Hold configs start
    ``x_offset`` off the target in x and z (NED), trajectory configs on the
    trajectory at t = 3 s."""
    from sde4mbrl_px4_tpu.core.frames import enu2ned as j_enu2ned
    from sde4mbrl_px4_tpu.core.types import hover_state as j_hover

    _, (j_reset, j_mpc), j_sft, _ = j_make(copy.deepcopy(cfg))
    _, (t_reset, t_mpc), _, tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    if j_sft is not None:
        x = j_enu2ned(j_sft(jnp.float32(3.0)))
    else:
        x = j_hover().at[0].set(x_offset[0]).at[2].set(x_offset[1])
    xt = T(np.array(x))
    rng = jax.random.PRNGKey(0)
    sol_j = jax.jit(j_mpc)(x, rng, j_reset(x, rng, x), jnp.float32(3.0), x)
    sol_t = t_mpc(xt, draws, t_reset(xt, draws, xt), 3.0, xt)
    return sol_j, sol_t, tb


def assert_solve_lockstep(sol_j, sol_t, rtol=SOLVE_RTOL, atol=SOLVE_ATOL):
    assert int(sol_t.opt_state.num_steps) == int(sol_j.opt_state.num_steps)
    np.testing.assert_allclose(sol_t.u_opt.numpy(), np.asarray(sol_j.u_opt), rtol=rtol,
                               atol=atol)
    for f in ("init_cost", "opt_cost"):
        assert float(getattr(sol_t.opt_state, f)) == pytest.approx(
            float(getattr(sol_j.opt_state, f)), rel=rtol), f
    np.testing.assert_allclose(sol_t.x_evol.numpy(), np.asarray(sol_j.x_evol), rtol=rtol,
                               atol=atol)
