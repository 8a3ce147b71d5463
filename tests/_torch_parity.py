"""Shared set-up of the port's solver parity tests: the problems of
``tests/test_apg_kernel.py::_solve_both`` solved by the JAX package's XLA
``apg_solve`` and by the port's ``apg_solve_kernel`` (on CPU tensors, its
plain version)."""
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
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

H = 20


def load_port_bundles(repo_root):
    return {name: load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{name}.yaml"))[3]
            for name in ("iris_traj_mpc", "iris_posctrl_mpc")}


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
