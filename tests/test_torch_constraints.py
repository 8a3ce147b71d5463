"""Port parity, state constraints: the ``state_constr`` block in both forms
(the proximal slack columns and the penalty box) on the CPU (the plain
versions), against the JAX package on the same inputs.

- ``CostParams.from_config`` field by field (``tests/test_cost.py:144-190``);
- the plain oracle against ``pallas_cost_oracle`` in interpret mode and the
  XLA cost, on the ``_sc_block`` of ``tests/test_prox_slack.py:30-38`` and
  on a penalty block with a position, a velocity and a quaternion id: value
  rtol 2e-5, ``value_batch`` rtol 2e-5, gradient rtol 5e-4 / atol 5e-5
  (``:78-109``), ``trajectory`` of an nZ-wide plan rtol 1e-5;
- ``apg_solve_plain`` in lockstep with the XLA ``apg_solve`` on the
  augmented problem, ``max_iter`` 6 (``:113-146``);
- ``mpc_fn`` of the shipped ``configs/iris_constr_posctrl_mpc.yaml`` for 2
  ticks against the JAX ``mpc_fn``, and the config as the position config
  of ``RecedingHorizonController``;
- the altitude floor of ``examples/noise_robustness.py`` (penalty form) at
  P=8 antithetic in chunks of 4, with the JAX ``mpc_fn``'s draws injected;
- MPPI on the constrained config (H=5, 48 samples, 4 rounds) with JAX's
  draws, in lockstep at rtol 1e-5 (``tests/test_mppi.py:107-129``).

Weights are the committed checkpoint on both sides; plans and start states
come from numpy seeds.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import H, assert_lockstep, constrained_bundle, load_port_bundles
from sde4mbrl_px4_tpu.core.types import hover_state as j_hover_state
from sde4mbrl_px4_tpu.cost.cost import CostParams as JCostParams
from sde4mbrl_px4_tpu.cost.cost import make_cost_fn as j_make_cost_fn
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.pallas.solve_kernels import pallas_cost_oracle
from sde4mbrl_px4_tpu.ops.rollout import draw_brownian as j_draw_brownian
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean as j_rollout_mean
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde as j_rollout_sde
from sde4mbrl_px4_tpu.solver.apg import CostOracle as JaxOracle
from sde4mbrl_px4_tpu.solver.apg import apg_solve as j_apg_solve
from sde4mbrl_px4_tpu_torch.cost.cost import CostParams
from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_plans, constrained_problem
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

VAL_RTOL, G_RTOL, G_ATOL = 2e-5, 5e-4, 5e-5
SOLVE_RTOL, SOLVE_ATOL = 5e-4, 5e-5
T = torch.from_numpy
SHIPPED = "configs/iris_constr_posctrl_mpc.yaml"

# tests/test_prox_slack.py:30-38 (velocity box, proximal), and a penalty
# block on a position, a velocity and a quaternion component
SC_BLOCKS = {
    "prox": {"state_id": [3, 4, 5], "state_penalty": [10.0, 10.0, 20.0],
             "slack_scaling": [1.0, 1.0, 1.0],
             "state_bound": [[-0.3, 0.3], [-0.3, 0.3], [-0.25, 0.25]],
             "slack_proximal": True, "constr_pen": 0.1},
    "penalty": {"state_id": [2, 3, 7], "state_penalty": [30.0, 10.0, 50.0],
                "slack_scaling": [1.0, 0.5, 1.0],
                "state_bound": [[-0.2, 0.2], [-0.3, 0.3], [-0.02, 0.02]],
                "slack_proximal": False, "constr_pen": 0.5},
}
FORMS = sorted(SC_BLOCKS)
# examples/noise_robustness.py:37, :125-130: the altitude floor (NED)
FLOOR_Z = -1.2
FLOOR = {"state_id": [2], "state_bound": [[-5.0, FLOOR_Z]], "state_penalty": [300.0],
         "slack_scaling": [1.0]}


def pos_config(repo_root, block, loader=load_yaml_config):
    cfg = loader(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg["state_constr"] = copy.deepcopy(block)
    return cfg


def plans(K, seed, m):
    """(K, H, 4 + m) decision rows: controls in the box, slack targets
    (m columns) spread past the state bounds, as tests/test_prox_slack.py."""
    rs = np.random.RandomState(seed)
    u = rs.uniform(0.05, 0.95, (K, H, 4))
    s = rs.uniform(-0.2, 0.8, (K, H, m))
    return np.concatenate([u, s], axis=-1).astype(np.float32)


def problem():
    """A bound-violating start (tests/test_prox_slack.py:85), hover reference."""
    x0 = np.asarray(j_hover_state()).copy()
    x0[3] = 0.6
    x_ref = np.tile(np.asarray(j_hover_state()), (H + 1, 1))
    return x0, x_ref


@pytest.mark.parametrize("form", FORMS)
def test_cost_params_match_jax(repo_root, form):
    jcp = JCostParams.from_config(pos_config(repo_root, SC_BLOCKS[form], j_load_yaml), 4)
    tcp = CostParams.from_config(pos_config(repo_root, SC_BLOCKS[form]), 4)
    fields = ("slack_pen", "slack_inv_scale", "slack_sel", "slack_lo", "slack_hi",
              "state_pen13", "state_lo13", "state_hi13", "state_inv_scale13")
    for f in fields:
        j, t = getattr(jcp, f), getattr(tcp, f)
        assert (j is None) == (t is None), f
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f)
    assert tcp.constr_pen == float(jcp.constr_pen)
    assert tcp.n_slack == (3 if form == "prox" else 0)


@pytest.fixture(scope="module", params=FORMS)
def oracles(request, repo_root, iris_pos_bundle):
    """(form, m, xla, pallas-interpret, port, jax bundle, x0)"""
    form = request.param
    b = iris_pos_bundle[3]
    tb = load_port_bundles(repo_root)["iris_posctrl_mpc"]
    jcp = JCostParams.from_config(pos_config(repo_root, SC_BLOCKS[form], j_load_yaml), 4)
    tcp = CostParams.from_config(pos_config(repo_root, SC_BLOCKS[form]), 4)
    m = tcp.n_slack
    x0, x_ref = problem()
    u_prev = np.array(b.cost_params.uref)
    cost_fn = j_make_cost_fn(jcp, b.time_steps)

    def seq_cost(z):
        u = z[:, :4]
        xp, sg = j_rollout_sde(b.model, b.params, jnp.asarray(x0), u, b.time_steps,
                               jax.random.PRNGKey(0), 1, deterministic=True)
        return cost_fn(xp, sg, u, jnp.asarray(x_ref), jnp.asarray(u_prev),
                       s_seq=z[:, 4:] if m else None)

    pk = pallas_cost_oracle(b.model, b.params, jcp, b.time_steps, jnp.asarray(x0),
                            jnp.asarray(x_ref), jnp.asarray(u_prev),
                            jnp.zeros((1, H, 13), jnp.float32), 1, 4, interpret=True)
    port = CO.cost_oracle(tb.model, tb.params, tcp, tb.time_steps, T(x0), T(x_ref),
                          T(u_prev), None, 1, 4)
    return form, m, JaxOracle.from_fn(seq_cost), pk, port, b, x0


def test_constrained_value_matches_jax(oracles):
    _, m, xla, pk, port, _, _ = oracles
    z = plans(1, 3, m)[0]
    n0 = CO.value_batch_kernel.launches
    v = float(port.value(T(z)))
    assert CO.value_batch_kernel.launches == n0          # CPU: plain version
    assert v == pytest.approx(float(xla.value(jnp.asarray(z))), rel=VAL_RTOL)
    assert v == pytest.approx(float(pk.value(jnp.asarray(z))), rel=VAL_RTOL)


def test_constrained_value_batch_matches_jax(oracles):
    _, m, xla, pk, port, _, _ = oracles
    Z = plans(3, 21, m)
    v = port.value_batch(T(Z)).numpy()
    assert v.shape == (3,)
    np.testing.assert_allclose(v, np.asarray(xla.value_batch(jnp.asarray(Z))), rtol=VAL_RTOL)
    np.testing.assert_allclose(v, np.asarray(pk.value_batch(jnp.asarray(Z))), rtol=VAL_RTOL)


def test_constrained_value_and_grad_matches_jax(oracles):
    _, m, xla, pk, port, _, _ = oracles
    z = plans(1, 7, m)[0]
    v, g = port.value_and_grad(T(z))
    assert g.shape == (H, 4 + m)
    for ref in (xla, pk):
        v_r, g_r = ref.value_and_grad(jnp.asarray(z))
        assert float(v) == pytest.approx(float(v_r), rel=VAL_RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=G_RTOL, atol=G_ATOL)


def test_constrained_trajectory_reads_the_controls(oracles):
    """``trajectory`` of an nZ-wide plan is the mean rollout of its first
    n_u columns, as the interpret-mode kernel's."""
    _, m, _, pk, port, b, x0 = oracles
    z = plans(1, 9, m)[0]
    x = port.trajectory(T(z)).numpy()
    ref = j_rollout_mean(b.model, b.params, jnp.asarray(x0), jnp.asarray(z[:, :4]),
                         b.time_steps)
    np.testing.assert_allclose(x, np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x, np.asarray(pk.trajectory(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", FORMS)
def test_plain_solve_lockstep_with_xla(repo_root, iris_pos_bundle, form):
    """``apg_solve_plain`` (the posctrl linesearch, max_iter 6) on the
    augmented problem in lockstep with the XLA ``apg_solve``: equal steps,
    ``yk`` rtol 5e-4 / atol 5e-5; the slack columns stay in their box."""
    b = iris_pos_bundle[3]
    tb = load_port_bundles(repo_root)["iris_posctrl_mpc"]
    jcp = JCostParams.from_config(pos_config(repo_root, SC_BLOCKS[form], j_load_yaml), 4)
    tcp = CostParams.from_config(pos_config(repo_root, SC_BLOCKS[form]), 4)
    m = tcp.n_slack
    x0, x_ref = problem()
    uref = np.array(b.cost_params.uref)
    z_init = np.concatenate([np.tile(uref, (H, 1)) + np.float32(0.02),
                             np.zeros((H, m), np.float32)], axis=1)
    lb, ub = np.array(b.lb).copy(), np.array(b.ub).copy()
    if m:
        lb = np.concatenate([lb, np.asarray(jcp.slack_lo)])
        ub = np.concatenate([ub, np.asarray(jcp.slack_hi)])
    cost_fn = j_make_cost_fn(jcp, b.time_steps)

    def seq_cost(z):
        u = z[:, :4]
        xp, sg = j_rollout_sde(b.model, b.params, jnp.asarray(x0), u, b.time_steps,
                               jax.random.PRNGKey(0), 1, deterministic=True)
        return cost_fn(xp, sg, u, jnp.asarray(x_ref), jnp.asarray(uref),
                       s_seq=z[:, 4:] if m else None)

    apg = b.apg_config._replace(max_iter=6, max_no_improvement_iter=6)
    st_x = j_apg_solve(seq_cost, jnp.asarray(z_init), jnp.asarray(lb), jnp.asarray(ub), apg)
    tapg = tb.apg_config._replace(max_iter=6, max_no_improvement_iter=6)
    n0 = AK.apg_solve_kernel.launches
    st_t, x_evol = AK.apg_solve_kernel(
        tb.model, tb.params, tcp, tapg, tb.time_steps, T(x0), T(x_ref), T(uref), None, 1,
        T(lb), T(ub), T(z_init))
    assert AK.apg_solve_kernel.launches == n0
    assert st_t.yk.shape == (H, 4 + m) and x_evol.shape == (H + 1, 13)
    assert_lockstep(st_x, st_t, rtol=SOLVE_RTOL, atol=SOLVE_ATOL, stats=False)
    assert (st_t.yk.numpy() >= lb - 1e-7).all() and (st_t.yk.numpy() <= ub + 1e-7).all()


@pytest.mark.parametrize("form", FORMS)
def test_shared_problem_lockstep_with_xla(repo_root, form):
    """The problem that the card's kernel-against-plain checks solve
    (``goldens.constrained_problem`` on the shipped config in either form,
    max_iter 10): its warm start lies in the decision box, and
    ``apg_solve_plain`` on it runs in lockstep with the XLA ``apg_solve``
    on the same arrays (equal steps, ``yk`` rtol 5e-4 / atol 5e-5)."""
    tb = constrained_bundle(repo_root, form, "cpu")
    x0, x_ref, u_prev, z_init = constrained_problem(tb)
    m = tb.cost_params.n_slack
    assert z_init.shape == (H, 4 + m) and float(x0[3]) == pytest.approx(0.6)
    assert (z_init >= tb.lb_z).all() and (z_init <= tb.ub_z).all()
    assert constrained_plans(tb, 3, 0).shape == (3, H, 4 + m)
    cfg = j_load_yaml(os.path.join(repo_root, SHIPPED))
    cfg["state_constr"]["slack_proximal"] = form == "prox"
    cfg["apg_mpc"].update(max_iter=10, max_no_improvement_iter=10)
    jb = j_make(copy.deepcopy(cfg))[3]
    cost_fn = j_make_cost_fn(jb.cost_params, jb.time_steps)
    xj, xr, up = (jnp.asarray(t.numpy()) for t in (x0, x_ref, u_prev))

    def seq_cost(z):
        u = z[:, :4]
        xp, sg = j_rollout_sde(jb.model, jb.params, xj, u, jb.time_steps,
                               jax.random.PRNGKey(0), 1, deterministic=True)
        return cost_fn(xp, sg, u, xr, up, s_seq=z[:, 4:] if m else None)

    st_x = j_apg_solve(seq_cost, jnp.asarray(z_init.numpy()), jnp.asarray(tb.lb_z.numpy()),
                       jnp.asarray(tb.ub_z.numpy()), jb.apg_config)
    apg = tb.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
    st_t, _ = AK.apg_solve_plain(tb.model, tb.params, tb.cost_params, apg, tb.time_steps,
                                 x0, x_ref, u_prev, None, 1, tb.lb_z, tb.ub_z, z_init)
    assert_lockstep(st_x, st_t, rtol=SOLVE_RTOL, atol=SOLVE_ATOL, stats=False)


def test_mpc_fn_shipped_config_lockstep_with_jax(repo_root):
    """Two chained ticks of the shipped proximal config (max_iter 10) from a
    bound-violating start, through both ``mpc_fn``s: the warm start carries
    the slack columns at 0 clipped into the state box, ``u_opt`` is the 4
    control columns, the slack columns stay in their box, and the solves
    match in lockstep."""
    cfg = j_load_yaml(os.path.join(repo_root, SHIPPED))
    cfg["apg_mpc"].update(max_iter=10, max_no_improvement_iter=10)
    _, (j_reset, j_mpc), _, _ = j_make(copy.deepcopy(cfg))
    _, (t_reset, t_mpc), _, tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    bounds = np.asarray(cfg["state_constr"]["state_bound"], np.float32)
    x0, _ = problem()
    xj, xt = jnp.asarray(x0), T(x0.copy())
    tgt = np.asarray(j_hover_state()).copy()
    tgt[0] = 1.0
    rng = jax.random.PRNGKey(0)
    st_j, st_t = j_reset(xj, rng, xj), t_reset(xt, None, xt)
    assert st_t.yk.shape == (H, 10)
    np.testing.assert_array_equal(st_t.yk[:, 4:].numpy(),
                                  np.clip(0.0, bounds[:, 0], bounds[:, 1])[None].repeat(H, 0))
    np.testing.assert_array_equal(st_t.yk.numpy(), np.asarray(st_j.yk))
    jm = jax.jit(j_mpc)
    for _ in range(2):
        u_j, st_j, rng, xe_j = jm(xj, rng, st_j, 0.0, jnp.asarray(tgt))
        u_t, st_t, _, xe_t = t_mpc(xt, None, st_t, 0.0, T(tgt))
        assert u_t.shape == (H, 4) and st_t.yk.shape == (H, 10)
        s = st_t.yk[:, 4:].numpy()
        assert (s >= bounds[:, 0] - 1e-7).all() and (s <= bounds[:, 1] + 1e-7).all()
        assert int(st_t.num_steps) == int(st_j.num_steps)
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL)
        np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_j.yk), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL)
        assert float(st_t.opt_cost) == pytest.approx(float(st_j.opt_cost), rel=SOLVE_RTOL)
        xj, xt = xe_j[1], xe_t[1]


def test_controller_flies_the_shipped_config_as_pos(repo_root, tmp_path):
    """The shipped proximal config as the position config of
    ``RecedingHorizonController``: its warm start keeps the slack columns,
    and the controller receives the 4 control columns (it averages
    ``u_opt``'s columns into the thrust of the published plan)."""
    import yaml

    from sde4mbrl_px4_tpu_torch.engine import goldens as G
    from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController

    cfg = load_yaml_config(os.path.join(repo_root, SHIPPED))
    cfg["apg_mpc"].update(max_iter=3, max_no_improvement_iter=3)
    path = tmp_path / "iris_constr_pos.yaml"
    path.write_text(yaml.safe_dump({k: v for k, v in cfg.items() if not k.startswith("_")}))
    c = RecedingHorizonController(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
                                  str(path), seed=0, now_fn=lambda: 0.0, device="cpu")
    cmds, costs = G.replay_pos(c, n=2)
    assert c.opt_state_pos.yk.shape == (H, 10)
    u = cmds[:, :4]
    assert np.isfinite(cmds).all() and np.isfinite(costs).all()
    assert (u >= 1e-4 - 1e-7).all() and (u <= 1.0 + 1e-7).all()
    np.testing.assert_array_equal(c.u_plan[:, 4:], 0.0)
    np.testing.assert_allclose(c.w_plan[:H, 0], c.u_plan[:H, :4].mean(axis=1), rtol=1e-6)


def jax_brownian_draws(P, n_solves, antithetic):
    """Each solve's Brownian block as the JAX ``mpc_fn`` draws it from
    PRNGKey(0) (``engine/mpc_loader.py:664``), in the (P, H, 13) layout."""
    rng = jax.random.PRNGKey(0)
    for _ in range(n_solves):
        rng_noise, rng = jax.random.split(rng)
        z = np.asarray(j_draw_brownian(rng_noise, H, P, antithetic=antithetic), np.float32)
        yield T(np.ascontiguousarray(z.transpose(1, 0, 2)))


def test_penalty_floor_p8_antithetic_lockstep_with_jax(repo_root):
    """The noise-robustness altitude floor (penalty form) on the posctrl
    config at P=8 antithetic in chunks of 4, two chained solves from below
    the floor, the port fed the JAX ``mpc_fn``'s own draws: lockstep at
    5e-4."""
    cfg = pos_config(repo_root, FLOOR, j_load_yaml)
    cfg.update(num_particles=8, antithetic=True, pallas_chunk=4)
    cfg["apg_mpc"].update(max_iter=6, max_no_improvement_iter=6)
    _, (j_reset, j_mpc), _, _ = j_make(copy.deepcopy(cfg))
    _, (t_reset, t_mpc), _, tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    assert tb.cost_params.constr_pen == 1.0 and tb.num_particles == 8
    x0 = np.asarray(j_hover_state()).copy()
    x0[2] = -1.1                                    # 0.1 m below the floor (NED)
    tgt = np.asarray(j_hover_state()).copy()
    tgt[2] = 1.27                                   # ENU altitude of the hold point
    xj, xt = jnp.asarray(x0), T(x0.copy())
    rng = jax.random.PRNGKey(0)
    draws = jax_brownian_draws(8, 2, antithetic=True)
    st_j, st_t = j_reset(xj, rng, xj), t_reset(xt, draws, xt)
    jm = jax.jit(j_mpc)
    for _ in range(2):
        u_j, st_j, rng, xe_j = jm(xj, rng, st_j, 0.0, jnp.asarray(tgt))
        u_t, st_t, draws, xe_t = t_mpc(xt, draws, st_t, 0.0, T(tgt))
        assert int(st_t.num_steps) == int(st_j.num_steps)
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL)
        assert float(st_t.opt_cost) == pytest.approx(float(st_j.opt_cost), rel=SOLVE_RTOL)
        np.testing.assert_allclose(xe_t.numpy(), np.asarray(xe_j), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL)
        xj, xt = xe_j[1], xe_t[1]


def jax_mppi_draws(samples, iters, h, n, n_solves):
    """Each solve's MPPI draws as the JAX ``mpc_fn`` makes them from
    PRNGKey(0): ``(noise, mppi, next) = split(rng, 3)`` per solve, then the
    key splits of ``solver/mppi.py:131-138``."""
    rng = jax.random.PRNGKey(0)
    for _ in range(n_solves):
        _, key, rng = jax.random.split(rng, 3)
        eps, c0 = [], []
        for _ in range(iters):
            key, sub, sub0 = jax.random.split(key, 3)
            eps.append(np.asarray(jax.random.normal(sub, (samples, h, n), jnp.float32)))
            c0.append(np.asarray(jax.random.normal(sub0, (samples, n), jnp.float32)))
        yield T(np.stack(eps)), T(np.stack(c0))


def test_mppi_constrained_lockstep_with_jax(repo_root):
    """``solver: mppi`` on the shipped proximal config (H=5, 48 samples, 4
    rounds; ``tests/test_mppi.py:107-129``): the samples span the nZ = 10
    columns, sigma scaled by the joint box; two chained solves in lockstep
    with the JAX ``mpc_fn`` on its own draws, rtol 1e-5."""
    cfg = j_load_yaml(os.path.join(repo_root, SHIPPED))
    cfg.update(solver="mppi", mppi={"samples": 48, "iters": 4}, horizon=5, num_short_dt=5)
    _, (j_reset, j_mpc), _, _ = j_make(copy.deepcopy(cfg))
    _, (t_reset, t_mpc), _, tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    assert tb.lb_z.shape == (10,)
    x0 = np.asarray(j_hover_state()).copy()
    x0[0], x0[3] = 0.5, 0.4
    xj, xt = jnp.asarray(x0), T(x0.copy())
    rng = jax.random.PRNGKey(0)
    draws = jax_mppi_draws(48, 4, 5, 10, 2)
    st_j, st_t = j_reset(xj, rng, xj), t_reset(xt, draws, xt)
    jm = jax.jit(j_mpc)
    n0 = CO.value_batch_kernel.launches
    for _ in range(2):
        u_j, st_j, rng, xe_j = jm(xj, rng, st_j, jnp.float32(0.0), xj)
        u_t, st_t, draws, xe_t = t_mpc(xt, draws, st_t, 0.0, xt)
        assert u_t.shape == (5, 4) and st_t.yk.shape == (5, 10)
        np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_j.yk), rtol=1e-5,
                                   atol=1e-6)
        for f in ("init_cost", "opt_cost", "grad_sqr"):
            assert float(getattr(st_t, f)) == pytest.approx(float(getattr(st_j, f)),
                                                            rel=1e-5, abs=1e-7), f
        xj, xt = xe_j[1], xe_t[1]
    assert CO.value_batch_kernel.launches == n0
