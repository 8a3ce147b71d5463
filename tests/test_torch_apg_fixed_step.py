"""Port parity, fixed-step APG: a config without an ``apg_mpc.linesearch``
block is the fixed-step solver (``solver/apg.py:346-351`` of the JAX
package). The port's ``apg_solve`` over the plain cost oracle runs in
lockstep with the JAX ``apg_solve`` (equal ``num_steps``; rtol 2e-4,
atol 2e-5, ``tests/test_apg_kernel.py:60-69``), with and without the
``hover_diag`` metric, on steps that are accepted and on steps that are
all refused; and ``mpc_fn`` on a config whose linesearch block was deleted
solves, tick after tick, in lockstep with the JAX ``mpc_fn``."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_lockstep, load_port_bundles, problem
from sde4mbrl_px4_tpu.cost.cost import make_cost_fn
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde
from sde4mbrl_px4_tpu.solver.apg import apg_solve as j_apg_solve
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.solver.apg import apg_solve

# config, stepsize, hover_diag: accepted steps on both configs, the metric,
# and a stepsize whose every step is refused (the loaded configs' 1.0)
CASES = {
    "traj": ("iris_traj_mpc", 1e-5, False),
    "traj_hover_diag": ("iris_traj_mpc", 1e-3, True),
    "pos": ("iris_posctrl_mpc", 1e-5, False),
    "pos_refused": ("iris_posctrl_mpc", 1.0, False),
}


def no_linesearch(repo_root, name, **apg):
    cfg = j_load_yaml(os.path.join(repo_root, f"configs/{name}.yaml"))
    del cfg["apg_mpc"]["linesearch"]
    cfg["apg_mpc"].update(apg)
    return cfg


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_step_lockstep(repo_root, iris_traj_bundle, iris_pos_bundle, case):
    name, step, diag = CASES[case]
    jb = (iris_traj_bundle if name == "iris_traj_mpc" else iris_pos_bundle)[3]
    tb = load_port_bundles(repo_root)[name]
    apg = jb.apg_config._replace(use_linesearch=False, stepsize=step, max_iter=10,
                                 max_no_improvement_iter=10)
    tapg = tb.apg_config._replace(use_linesearch=False, stepsize=step, max_iter=10,
                                  max_no_improvement_iter=10)
    pre = tb.precond if diag else None
    x0, x_ref, u_prev, u_init = problem(jb.cost_params.uref)
    cost_fn = make_cost_fn(jb.cost_params, jb.time_steps)

    def seq_cost(u):
        xp, sg = rollout_sde(jb.model, jb.params, jnp.asarray(x0), u, jb.time_steps,
                             jax.random.PRNGKey(0), 1, deterministic=True)
        return cost_fn(xp, sg, u, jnp.asarray(x_ref), jnp.asarray(u_prev))

    st_x = j_apg_solve(seq_cost, jnp.asarray(u_init), jb.lb, jb.ub, apg,
                       t_init=jnp.float32(0.3),
                       precond=None if pre is None else jnp.asarray(pre.numpy()))
    T = torch.from_numpy
    oracle = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps,
                            T(x0), T(x_ref), T(u_prev), None, 1, tapg.maxls)
    with torch.no_grad():
        st_t = apg_solve(oracle, T(u_init), tb.lb, tb.ub, tapg,
                         t_init=torch.tensor(0.3), precond=pre)
    assert_lockstep(st_x, st_t, rtol=2e-4, atol=2e-5)
    assert float(st_t.stepsize) == pytest.approx(step)      # t_init is ignored
    assert float(st_t.avg_linesearch) == 1.0
    moved = float(st_t.opt_cost) < float(st_t.init_cost)
    assert moved == (case != "pos_refused")


@pytest.mark.parametrize("name", ["iris_traj_mpc", "iris_posctrl_mpc"])
def test_config_without_linesearch_solves(repo_root, name):
    """The repair: the deleted-linesearch config used to raise inside
    mpc_fn. It now solves through the oracle route, three chained ticks in
    lockstep with the JAX mpc_fn, without a kernel launch on the CPU."""
    cfg = no_linesearch(repo_root, name, max_iter=6, max_no_improvement_iter=6,
                        stepsize=1e-3 if name == "iris_traj_mpc" else 1e-5)
    jcfg, (j_reset, j_mpc), j_sft, _ = j_make(copy.deepcopy(cfg))
    tcfg, (t_reset, t_mpc), t_sft, tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    assert not tb.apg_config.use_linesearch
    assert (tb.precond is not None) == (name == "iris_traj_mpc")
    x = np.zeros(13, np.float32)
    x[6], x[0], x[2] = 1.0, 0.5, -0.3
    t0 = 3.0 if t_sft is not None else 0.0
    rng = jax.random.PRNGKey(0)
    st_j = j_reset(jnp.asarray(x), rng, jnp.asarray(x))
    st_t = t_reset(torch.from_numpy(x), None, torch.from_numpy(x))
    jm = jax.jit(j_mpc)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    counts = (CO.value_and_grad_kernel.launches, CO.value_batch_kernel.launches,
              CO.trajectory_kernel.launches, AK.apg_solve_kernel.launches)
    for k in range(3):
        t = t0 + 0.05 * k
        u_j, st_j, rng, xe_j = jm(xj, rng, st_j, jnp.float32(t), xj)
        u_t, st_t, _, xe_t = t_mpc(xt, None, st_t, t, xt)
        assert int(st_t.num_steps) == int(st_j.num_steps) == 6
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_j.yk), rtol=2e-4,
                                   atol=2e-5)
        assert float(st_t.opt_cost) == pytest.approx(float(st_j.opt_cost), rel=2e-4)
        np.testing.assert_allclose(xe_t.numpy(), np.asarray(xe_j), rtol=1e-4, atol=1e-5)
        xj, xt = xe_j[1], xe_t[1]
    assert counts == (CO.value_and_grad_kernel.launches, CO.value_batch_kernel.launches,
                      CO.trajectory_kernel.launches, AK.apg_solve_kernel.launches)


def test_whole_solve_kernel_refuses_fixed_step(repo_root):
    tb = load_port_bundles(repo_root)["iris_posctrl_mpc"]
    x0, x_ref, u_prev, u_init = (torch.from_numpy(a) for a in
                                 problem(tb.cost_params.uref.numpy()))
    with pytest.raises(ValueError, match="fixed-step"):
        AK.apg_solve_kernel(tb.model, tb.params, tb.cost_params,
                            tb.apg_config._replace(use_linesearch=False),
                            tb.time_steps, x0, x_ref, u_prev, None, 1, tb.lb, tb.ub,
                            u_init)
