"""Port parity, the batched oracle routes (L3-L6): the cost oracle over B
scenarios (``ops/cuda/cost_oracle.py::cost_oracle_batched``) and the
batched solves that run on it (``parallel/batched.py``: MPPI, fixed-step
APG, the policy family), on the CPU against the JAX package's
``parallel/batched.py::make_batched_mpc`` (its vmapped XLA solve on a
one-device CPU mesh), at the small size of ``tests/test_torch_batched.py``
(horizon 6).

- the batched plain oracle is each scenario's solo plain oracle, bit for
  bit (``value_batch``, ``value``, ``value_and_grad``, ``trajectory``);
- batched MPPI (K = 64, 8 rounds) with JAX's per-scenario draws handed in,
  first solve in lockstep (plans and costs rtol 1e-5, as
  ``tests/test_torch_mppi.py``; the last round's weight off the incumbent
  rtol 1e-4);
- batched fixed-step APG (posctrl without its ``linesearch`` block), first
  solve in lockstep (rtol 2e-4 / atol 2e-5, equal ``num_steps``) and each
  scenario its solo plain solve;
- the batched policy, pure (plans atol 1e-5, costs rtol 2e-5) and the
  ``refine_iters`` hybrid (rtol 2e-4 / atol 2e-5, equal ``num_steps``), on
  a JAX ``init_policy`` tree carried across in a checkpoint;
- on the card (``cuda`` marker): the batched ``value_batch`` and
  ``value_and_grad`` launches against the solo launches (bit for bit) and
  the plain oracle.
"""
import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.io.config import input_bounds_from_config
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.models import policy as jpol
from sde4mbrl_px4_tpu.parallel import batched as jbatched
from sde4mbrl_px4_tpu.parallel.mesh import make_mesh
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc, make_mpc_from_config
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig

T = torch.from_numpy
B, H = 3, 6
RTOL, ATOL = 2e-4, 2e-5          # tests/test_sharding.py:87-88


def small_cfg(repo_root, **top):
    cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=H, num_short_dt=H, **top)
    cfg["apg_mpc"].update(max_iter=12, max_no_improvement_iter=12)
    return cfg


def jax_side(cfg, seed=0):
    """JAX's batched program on a one-device mesh and its inputs, with
    targets 0.5 m off in x (ENU)."""
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    reset_b, mpc_b, jb = jbatched.make_batched_mpc(copy.deepcopy(cfg), mesh)
    xs, rngs = jbatched.make_batch_inputs(mesh, B, seed=seed, spread=0.3)
    xdes = np.array(xs, np.float32)
    xdes[:, 0] += 0.5
    return reset_b, mpc_b, jb, xs, rngs, xdes


def both_first_solves(cfg, rngs_t=None, seed=0):
    """The first batched solve of both packages on the same inputs."""
    j_reset, j_mpc, jb, xs, rngs, xdes = jax_side(cfg, seed)
    t_reset, t_mpc, tb = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    sol_j = j_mpc(xs, rngs, j_reset(xs, rngs, xs), jnp.zeros(B), jnp.asarray(xdes))
    xs_t = T(np.array(xs))
    sol_t = t_mpc(xs_t, rngs_t, t_reset(xs_t, rngs_t, xs_t), torch.zeros(B), T(xdes))
    return sol_t, sol_j, (xs_t, T(xdes), rngs)


def test_batched_plain_oracle_is_each_scenarios_solo_oracle(repo_root):
    cfg = small_cfg(repo_root)
    _, b, pieces = build_mpc(copy.deepcopy(cfg), device="cpu")
    rs = np.random.RandomState(0)
    xs = T(np.array(jbatched.make_batch_inputs(make_mesh((1, 1), devices=jax.devices()[:1]),
                                               B, spread=0.3)[0]))
    x_ref = pieces.build_ref(torch.zeros(B), pieces.targets(xs))
    u_prev = b.cost_params.uref.expand(B, 4).contiguous()
    U = T(rs.uniform(0.4, 0.8, (B, 5, H, 4)).astype(np.float32))
    ob = CO.cost_oracle_batched(b.model, b.params, b.cost_params, b.time_steps, xs, x_ref,
                                u_prev, None, 1, 4)
    u = U[:, 0].contiguous()
    costs, (v, g), xe, val = ob.value_batch(U), ob.value_and_grad(u), ob.trajectory(u), ob.value(u)
    assert costs.shape == (B, 5) and g.shape == (B, H, 4) and xe.shape == (B, H + 1, 13)
    for i in range(B):
        o = CO.cost_oracle_plain(b.model, b.params, b.cost_params, b.time_steps, xs[i],
                                 x_ref[i], u_prev[i], None, 1, 4)
        assert torch.equal(o.value_batch(U[i]), costs[i])
        assert torch.equal(o.value(u[i]), val[i])
        v1, g1 = o.value_and_grad(u[i])
        assert torch.equal(v1, v[i]) and torch.equal(g1, g[i])
        assert torch.equal(o.trajectory(u[i]), xe[i])
    with pytest.raises(ValueError, match="value_batch takes"):
        ob.value_batch(U[0])


def jax_scenario_mppi_draws(rngs, cfg: MPPIConfig, n: int = 4):
    """One call's (eps (B, iters, K, H, n), c0 (B, iters, K, n)) as the JAX
    package's vmapped ``mpc_fn`` draws them: per scenario
    ``(noise, mppi, next) = split(rng, 3)`` (``engine/mpc_loader.py:654``),
    then per round ``split(key, 3)`` (``solver/mppi.py:131-138``)."""
    eps, c0 = [], []
    for b in range(rngs.shape[0]):
        _, key, _ = jax.random.split(rngs[b], 3)
        e_b, c_b = [], []
        for _ in range(cfg.iters):
            key, sub, sub0 = jax.random.split(key, 3)
            e_b.append(np.asarray(jax.random.normal(sub, (cfg.samples, H, n), jnp.float32)))
            c_b.append(np.asarray(jax.random.normal(sub0, (cfg.samples, n), jnp.float32)))
        eps.append(np.stack(e_b))
        c0.append(np.stack(c_b))
    return T(np.stack(eps)), T(np.stack(c0))


def test_batched_mppi_matches_jax(repo_root):
    """B = 3 MPPI solves over the batched plain oracle, fed JAX's
    per-scenario draws: plans, costs and the last round's weight off the
    incumbent in lockstep with JAX's vmapped solve."""
    cfg = small_cfg(repo_root, solver="mppi")
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    _, rngs = jbatched.make_batch_inputs(mesh, B, seed=0, spread=0.3)
    draws = jax_scenario_mppi_draws(np.asarray(rngs), MPPIConfig())
    it = iter([draws])
    sol_t, sol_j, _ = both_first_solves(cfg, rngs_t=it)
    assert sol_t.rng is it
    np.testing.assert_allclose(sol_t.u_opt.numpy(), np.asarray(sol_j.u_opt), rtol=1e-5,
                               atol=1e-6)
    for f in ("init_cost", "opt_cost"):
        np.testing.assert_allclose(getattr(sol_t.opt_state, f).numpy(),
                                   np.asarray(getattr(sol_j.opt_state, f)), rtol=1e-5,
                                   err_msg=f)
    # the last round's weight off the incumbent: its temperature rides the
    # spread of the round's costs above their minimum, a difference of
    # nearly equal costs, so the order of the mean's sum moves it by ~1e-5
    np.testing.assert_allclose(sol_t.opt_state.grad_sqr.numpy(),
                               np.asarray(sol_j.opt_state.grad_sqr), rtol=1e-4)
    for f in ("num_steps", "avg_linesearch", "stepsize"):
        np.testing.assert_array_equal(getattr(sol_t.opt_state, f).numpy(),
                                      np.asarray(getattr(sol_j.opt_state, f)), err_msg=f)


@pytest.mark.parametrize("K", [1, 7, 64])
def test_ksum_order_does_not_depend_on_the_batch(K):
    """MPPI's sums over the K candidates on the card: a fixed pairwise tree
    of elementwise adds, so each row sums in the same order whatever the
    other axes hold (the batched solve's bits are its solo solve's), and
    the sum is torch's to float rounding."""
    from sde4mbrl_px4_tpu_torch.solver.mppi import ksum

    x = torch.randn(6, K, 3, generator=torch.Generator().manual_seed(K))
    full = ksum(x, -2)
    assert full.shape == (6, 3)
    for b in range(6):
        assert torch.equal(ksum(x[b], -2), full[b])
        assert torch.equal(ksum(x[b:b + 1], -2)[0], full[b])
    torch.testing.assert_close(full, x.sum(-2), rtol=1e-5, atol=1e-6)


def test_batched_mppi_draws_once_per_call(repo_root):
    """With a generator, a call draws its (B, ...) noise in one call: eps
    then c0, as ``draw_mppi_noise`` with ``batch=(B,)``."""
    cfg = small_cfg(repo_root, solver="mppi")
    cfg["mppi"] = {"samples": 8, "iters": 2}
    t_reset, t_mpc, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    xs = T(np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0], np.float32), (B, 1)))
    gen = torch.Generator().manual_seed(3)
    sol = t_mpc(xs, gen, t_reset(xs, gen, xs), torch.zeros(B), xs)
    ref = torch.Generator().manual_seed(3)
    torch.randn(B * (2 * 8 * H * 4 + 2 * 8 * 4), generator=ref)
    assert sol.rng is gen and torch.equal(gen.get_state(), ref.get_state())
    assert sol.u_opt.shape == (B, H, 4) and torch.isfinite(sol.u_opt).all()


def fixed_step_cfg(repo_root):
    cfg = small_cfg(repo_root)
    del cfg["apg_mpc"]["linesearch"]
    cfg["apg_mpc"]["stepsize"] = 1e-5
    return cfg


def test_batched_fixed_step_matches_jax_and_solo(repo_root):
    """Fixed-step APG over the batched oracle: each scenario stops on its
    own tests; the first solve in lockstep with JAX's vmapped
    ``while_loop``, and each scenario the port's solo ``mpc_fn`` (every
    field bit for bit but ``grad_sqr``, a sum over the plan)."""
    cfg = fixed_step_cfg(repo_root)
    sol_t, sol_j, (xs, xdes, _) = both_first_solves(cfg)
    np.testing.assert_array_equal(sol_t.opt_state.num_steps.numpy(),
                                  np.asarray(sol_j.opt_state.num_steps))
    np.testing.assert_allclose(sol_t.u_opt.numpy(), np.asarray(sol_j.u_opt), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sol_t.opt_state.opt_cost.numpy(),
                               np.asarray(sol_j.opt_state.opt_cost), rtol=RTOL)
    _, (reset_1, mpc_1), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    for i in range(B):
        one = mpc_1(xs[i], None, reset_1(xs[i], None, xs[i]), 0.0, xdes[i])
        assert torch.equal(one.u_opt, sol_t.u_opt[i]) and torch.equal(one.x_evol, sol_t.x_evol[i])
        for name, f_one, f_b in zip(one.opt_state._fields, one.opt_state, sol_t.opt_state):
            if name == "grad_sqr":
                torch.testing.assert_close(f_one, f_b[i], rtol=1e-6, atol=0)
            else:
                assert torch.equal(f_one, f_b[i]), name


def test_batched_fixed_step_scenarios_stop_on_their_own(repo_root):
    """A scenario that converges early keeps its own iteration count and
    frozen plan while the others run on (the vmapped while_loop's
    semantics)."""
    cfg = fixed_step_cfg(repo_root)
    cfg["apg_mpc"].update(max_iter=30, max_no_improvement_iter=30, rtol=1e-5, stepsize=3e-5)
    t_reset, t_mpc, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    _, (reset_1, mpc_1), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    xs = T(np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0], np.float32), (B, 1)))
    xdes = xs.clone()
    xdes[:, 0] += torch.tensor([0.0, 0.5, 2.0])
    sol = t_mpc(xs, None, t_reset(xs, None, xs), torch.zeros(B), xdes)
    steps = sol.opt_state.num_steps
    assert len(set(steps.tolist())) > 1, steps
    for i in range(B):
        one = mpc_1(xs[i], None, reset_1(xs[i], None, xs[i]), 0.0, xdes[i])
        assert float(one.opt_state.num_steps) == float(steps[i])
        assert torch.equal(one.u_opt, sol.u_opt[i])


@pytest.fixture(scope="module")
def policy_ckpt(repo_root, tmp_path_factory):
    """A JAX ``init_policy`` tree at H = 6 with its head at full scale (so
    plans depend on the state), as a checkpoint file."""
    cfg = small_cfg(repo_root)
    lb, ub = input_bounds_from_config(cfg)
    uref = np.broadcast_to(np.asarray(cfg["cost_params"]["uref"], np.float32), (4,))
    tree = jpol.init_policy(jax.random.PRNGKey(1), H, 4, lb, ub, uref, hidden=(32, 32))
    tree["net"]["w2"] = tree["net"]["w2"] * np.float32(300.0)
    path = tmp_path_factory.mktemp("policy") / "policy.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, tree),
                     "meta": {"kind": jpol.POLICY_KIND}}, f)
    return str(path)


@pytest.mark.parametrize("refine", [0, 3])
def test_batched_policy_matches_jax(repo_root, policy_ckpt, refine):
    """The pure policy (plans atol 1e-5, telemetry costs rtol 2e-5,
    ``num_steps`` 0) and the hybrid at ``refine_iters`` 3 (the batched
    whole solve from the cold plans; rtol 2e-4 / atol 2e-5, equal
    ``num_steps``) against JAX's vmapped ``mpc_fn``; a second call of the
    hybrid keeps the shifted plans (the select on ``num_steps``)."""
    cfg = small_cfg(repo_root, solver="policy")
    cfg["policy"] = {"params_path": policy_ckpt, "refine_iters": refine}
    sol_t, sol_j, (xs, xdes, _) = both_first_solves(cfg)
    u_t, u_j = sol_t.u_opt.numpy(), np.asarray(sol_j.u_opt)
    np.testing.assert_array_equal(sol_t.opt_state.num_steps.numpy(),
                                  np.asarray(sol_j.opt_state.num_steps))
    if refine:
        np.testing.assert_allclose(u_t, u_j, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(sol_t.opt_state.opt_cost.numpy(),
                                   np.asarray(sol_j.opt_state.opt_cost), rtol=RTOL)
        assert (sol_t.opt_state.num_steps == 3).all()
    else:
        np.testing.assert_allclose(u_t, u_j, atol=1e-5, rtol=0)
        assert np.ptp(u_t) > 0.05                # the plans depend on the state
        for f in ("init_cost", "opt_cost"):
            np.testing.assert_allclose(getattr(sol_t.opt_state, f).numpy(),
                                       np.asarray(getattr(sol_j.opt_state, f)), rtol=2e-5)
        assert (sol_t.opt_state.num_steps == 0).all()
    _, (reset_1, mpc_1), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    for i in range(B):
        one = mpc_1(xs[i], None, reset_1(xs[i], None, xs[i]), 0.0, xdes[i])
        torch.testing.assert_close(one.u_opt, sol_t.u_opt[i], rtol=0, atol=1e-6)
    t_reset, t_mpc, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    st = t_reset(xs, None, xs)
    sol1 = t_mpc(xs, None, st, torch.zeros(B), xdes)
    sol2 = t_mpc(xs, None, sol1.opt_state, torch.zeros(B), xdes)
    assert torch.isfinite(sol2.u_opt).all()
    if refine:
        # warm: the select keeps the shifted plans, whatever the network says
        cold_again = t_mpc(xs, None, st, torch.zeros(B), xdes)
        assert torch.equal(cold_again.u_opt, sol1.u_opt)


@pytest.mark.cuda
@pytest.mark.parametrize("name, P", [("iris_posctrl_mpc", 1), ("hexa_posctrl_mpc", 1),
                                     ("iris_constr_posctrl_mpc", 1), ("iris_posctrl_mpc", 8)])
def test_batched_oracle_kernels_equal_solo_launches_on_cuda(repo_root, name, P):
    """One ``value_batch`` launch over B x K plans and one ``value_and_grad``
    launch over B plans against the solo launches (bit for bit) and the
    plain oracle (rtol 2e-5; gradients rtol 5e-4 / atol 5e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    dev, Bc, K = torch.device("cuda"), 5, 9
    cfg = j_load_yaml(os.path.join(repo_root, f"configs/{name}.yaml"))
    if P > 1:
        cfg.update(num_particles=P, antithetic=True)
    _, b, pieces = build_mpc(cfg, device=dev)
    Hc, n, n_u = int(b.time_steps.shape[0]), int(b.lb_z.shape[0]), b.model.n_u
    rs = np.random.RandomState(0)
    xs = torch.zeros(Bc, 13, device=dev)
    xs[:, 6] = 1.0
    xs[:, :3] = torch.from_numpy(rs.randn(Bc, 3).astype(np.float32)).to(dev)
    x_ref = pieces.build_ref(torch.zeros(Bc, device=dev), xs)
    u_prev = torch.cat([b.cost_params.uref.expand(Bc, n_u),
                        torch.zeros(Bc, n - n_u, device=dev)], 1).contiguous()
    noise = (torch.randn((Bc, P, Hc, 13), generator=torch.Generator().manual_seed(1)).to(dev)
             if P > 1 else None)
    U = torch.from_numpy(rs.uniform(0.3, 0.9, (Bc, K, Hc, n)).astype(np.float32)).to(dev)
    ob = CO.cost_oracle_batched(b.model, b.params, b.cost_params, b.time_steps, xs, x_ref,
                                u_prev, noise, P, 4)
    n0 = (CO.value_batch_kernel.launches, CO.value_and_grad_kernel.launches)
    costs = ob.value_batch(U)
    v, g = ob.value_and_grad(U[:, 0].contiguous())
    assert (CO.value_batch_kernel.launches, CO.value_and_grad_kernel.launches) == (
        n0[0] + 1, n0[1] + 1)
    for i in range(Bc):
        args = (b.model, b.params, b.cost_params, b.time_steps, xs[i], x_ref[i], u_prev[i],
                None if noise is None else noise[i], P, 4)
        one, plain = CO.cost_oracle(*args), CO.cost_oracle_plain(*args)
        assert torch.equal(one.value_batch(U[i].contiguous()), costs[i])
        v1, g1 = one.value_and_grad(U[i, 0].contiguous())
        assert torch.equal(v1, v[i]) and torch.equal(g1, g[i])
        torch.testing.assert_close(costs[i], plain.value_batch(U[i].contiguous()), rtol=2e-5,
                                   atol=0)
        vp, gp = plain.value_and_grad(U[i, 0].contiguous())
        torch.testing.assert_close(v[i], vp, rtol=2e-5, atol=0)
        torch.testing.assert_close(g[i], gp, rtol=5e-4, atol=5e-5)
