"""Port parity, batched scenario solves (L6): ``parallel/batched.py`` on the
CPU (the plain version, one solve per scenario) against the JAX package's
``parallel/batched.py::make_batched_mpc`` (its vmapped XLA solve on a
one-device CPU mesh), at the small size of ``tests/test_sharding.py:21-31``
(horizon 6, ``max_iter`` 12).

- iris B=4 and hexa B=2, targets 0.5 m off: ``u_opt`` and ``opt_cost`` per
  scenario at rtol 2e-4 / atol 2e-5 with equal ``num_steps``; ``x_evol``
  the mean rollout of the port's own plan (JAX's ``rollout_mean``) at rtol
  1e-5;
- the batched plain path equals the port's solo ``mpc_fn`` per scenario,
  bit for bit;
- a 3-tick warm-start chain, the twin of
  ``test_sharding.py::test_batched_warm_start_donation``, its first solve
  in lockstep with JAX's (warm-started chains are fp-chaotic past that:
  ``engine/goldens.py``);
- P=8 antithetic, B=2, with JAX's per-scenario draws injected, at the
  ``family_p512anti`` tolerance (5e-4);
- ``make_batch_inputs`` gives JAX's ``xs``;
- the MPPI, fixed-step and policy routes take their batched solvers (held
  to the JAX package in ``tests/test_torch_batched_oracle.py``), and the
  default device is the card;
- on the card (``cuda`` marker): the batched kernel launch against the solo
  launches, bit for bit.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.rollout import draw_brownian as j_draw_brownian
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean as j_rollout_mean
from sde4mbrl_px4_tpu.parallel import batched as jbatched
from sde4mbrl_px4_tpu.parallel.mesh import make_mesh
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.parallel.batched import make_batch_inputs, make_batched_mpc

RTOL, ATOL = 2e-4, 2e-5          # tests/test_sharding.py:87-88
P_TOL = 5e-4                     # family_p512anti (tests/test_goldens_flagship.py:127)
T = torch.from_numpy


def small_cfg(repo_root, name, **top):
    cfg = j_load_yaml(os.path.join(repo_root, f"configs/{name}.yaml"))
    cfg.update(horizon=6, num_short_dt=6, **top)
    cfg["apg_mpc"].update(max_iter=12, max_no_improvement_iter=12)
    return cfg


def jax_side(cfg, B, spread, seed=0):
    """JAX's batched program on a one-device mesh and its inputs."""
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    reset_b, mpc_b, jb = jbatched.make_batched_mpc(copy.deepcopy(cfg), mesh)
    xs, rngs = jbatched.make_batch_inputs(mesh, B, seed=seed, spread=spread)
    return reset_b, mpc_b, jb, xs, rngs


def targets(xs):
    """Hold targets 0.5 m off in x (ENU), so every scenario has work."""
    t = np.array(xs, np.float32)
    t[:, 0] += 0.5
    return t


# one JAX program per config, shared by the module's tests
@pytest.fixture(scope="module")
def iris(repo_root):
    cfg = small_cfg(repo_root, "iris_posctrl_mpc")
    return cfg, jax_side(cfg, 4, 0.3)


@pytest.fixture(scope="module")
def hexa(repo_root):
    cfg = small_cfg(repo_root, "hexa_posctrl_mpc")
    return cfg, jax_side(cfg, 2, 0.3)


def assert_x_evol_is_own_rollout(sol_t, jb, xs_np):
    """``x_evol``: JAX's mean rollout of the port's own plan, rtol 1e-5
    (``tests/test_apg_kernel.py:199``)."""
    for b in range(xs_np.shape[0]):
        ref = j_rollout_mean(jb.model, jb.params, jnp.asarray(xs_np[b]),
                             jnp.asarray(sol_t.u_opt[b].numpy()), jb.time_steps)
        np.testing.assert_allclose(sol_t.x_evol[b].numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def assert_scenarios_match(sol_t, sol_j, jb, xs_np, rtol=RTOL, atol=ATOL):
    u_j, st_j = np.asarray(sol_j.u_opt), sol_j.opt_state
    np.testing.assert_array_equal(sol_t.opt_state.num_steps.numpy(),
                                  np.asarray(st_j.num_steps))
    np.testing.assert_allclose(sol_t.u_opt.numpy(), u_j, rtol=rtol, atol=atol)
    np.testing.assert_allclose(sol_t.opt_state.opt_cost.numpy(), np.asarray(st_j.opt_cost),
                               rtol=rtol)
    assert_x_evol_is_own_rollout(sol_t, jb, xs_np)


@pytest.mark.parametrize("vehicle", ["iris", "hexa"])
def test_batched_matches_jax_per_scenario(request, vehicle):
    """Port batched (plain) against JAX's vmapped solve, scenario by
    scenario; no kernel launch on the CPU."""
    cfg, (j_reset, j_mpc, jb, xs_j, rngs) = request.getfixturevalue(vehicle)
    B = xs_j.shape[0]
    t_reset, t_mpc, tb = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    xs_np = np.array(xs_j)
    xdes = targets(xs_np)
    launches = AK.apg_solve_kernel.launches
    sol_j = j_mpc(xs_j, rngs, j_reset(xs_j, rngs, xs_j), jnp.zeros(B), jnp.asarray(xdes))
    xs = T(xs_np)
    sol_t = t_mpc(xs, None, t_reset(xs, None, xs), torch.zeros(B), T(xdes))
    assert AK.apg_solve_kernel.launches == launches
    assert sol_t.u_opt.shape == (B, 6, tb.model.n_u) and sol_t.x_evol.shape == (B, 7, 13)
    assert_scenarios_match(sol_t, sol_j, jb, xs_np)


def test_batched_plain_equals_solo_mpc_fn(iris):
    """Each scenario of the batched plain path is the solo ``mpc_fn``'s
    solve, bit for bit (plan, warm start, stats, ``x_evol``)."""
    cfg, (_, _, _, xs_j, _) = iris
    t_reset, t_mpc, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    _, (reset_1, mpc_1), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    xs, xdes = T(np.array(xs_j)), T(targets(np.array(xs_j)))
    curr = torch.tensor([0.0, 0.05, 0.1, 0.15])
    sol = t_mpc(xs, None, t_reset(xs, None, xs), curr, xdes)
    for b in range(xs.shape[0]):
        one = mpc_1(xs[b], None, reset_1(xs[b], None, xs[b]), curr[b], xdes[b])
        assert torch.equal(one.u_opt, sol.u_opt[b])
        assert torch.equal(one.x_evol, sol.x_evol[b])
        for f_one, f_b in zip(one.opt_state, sol.opt_state):
            assert torch.equal(f_one, f_b[b])


def test_batched_reset_is_the_solo_reset(iris):
    cfg, (_, _, _, xs_j, _) = iris
    t_reset, _, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    _, (reset_1, _), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    xs = T(np.array(xs_j))
    xs[1, 7], xs[2, 5] = 0.2, 0.4           # tilt, and a vertical rate
    st = t_reset(xs, None, xs)
    assert st.yk.shape == (4, 6, 4) and st.stepsize.shape == (4,)
    for b in range(4):
        for f_one, f_b in zip(reset_1(xs[b], None, xs[b]), st):
            assert torch.equal(f_one, f_b[b])


def test_batched_warm_start_chain(iris):
    """Four chained batched steps (the twin of
    ``test_batched_warm_start_donation``): the first matches JAX's, every
    one is finite with ``x_evol`` its plan's rollout, and the median cost
    holds."""
    cfg, (j_reset, j_mpc, jb, xs_j, rngs) = iris
    t_reset, t_mpc, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    xs_np = np.array(xs_j)
    xs = T(xs_np)
    ts_j, ts_t = jnp.zeros(4), torch.zeros(4)
    sol_j = j_mpc(xs_j, rngs, j_reset(xs_j, rngs, xs_j), ts_j, xs_j)
    sol_t = t_mpc(xs, None, t_reset(xs, None, xs), ts_t, xs)
    assert_scenarios_match(sol_t, sol_j, jb, xs_np)
    c1 = sol_t.opt_state.opt_cost.numpy()
    for _ in range(3):
        sol_t = t_mpc(xs, sol_t.rng, sol_t.opt_state, ts_t, xs)
        assert torch.isfinite(sol_t.u_opt).all()
        assert_x_evol_is_own_rollout(sol_t, jb, xs_np)
    c4 = sol_t.opt_state.opt_cost.numpy()
    assert np.all(np.isfinite(c4))
    assert np.median(c4) <= np.median(c1) * 1.05


def jax_scenario_draws(rngs, H, P, n_calls):
    """Each call's (B, P, H, 13) block as the JAX package's vmapped
    ``mpc_fn`` draws it: per scenario ``(noise, next) = split(rng)`` and
    ``draw_brownian(noise, H, P, antithetic=True)`` (``engine/mpc_loader.py
    :664``, ``:721-724``), in the kernels' (P, H, 13) layout."""
    keys = [rngs[b] for b in range(rngs.shape[0])]
    for _ in range(n_calls):
        blocks = []
        for b, key in enumerate(keys):
            noise_key, keys[b] = jax.random.split(key)
            z = np.asarray(j_draw_brownian(noise_key, H, P, antithetic=True), np.float32)
            blocks.append(z.transpose(1, 0, 2))
        yield T(np.ascontiguousarray(np.stack(blocks)))


def test_batched_particles_match_jax_draws(repo_root):
    """P=8 antithetic, B=2, over two chained calls: the port fed JAX's
    per-scenario draws matches JAX's vmapped particle solve within 5e-4,
    with equal steps; ``rngs`` passes through."""
    cfg = small_cfg(repo_root, "iris_posctrl_mpc", num_particles=8, antithetic=True)
    cfg["apg_mpc"].update(max_iter=6, max_no_improvement_iter=6)
    j_reset, j_mpc, jb, xs_j, rngs = jax_side(cfg, 2, 0.3, seed=3)
    t_reset, t_mpc, tb = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    assert tb.num_particles == 8
    xs_np = np.array(xs_j)
    xs, xdes = T(xs_np), T(targets(xs_np))
    draws = jax_scenario_draws(np.asarray(rngs), 6, 8, 2)
    sol_j = j_mpc(xs_j, rngs, j_reset(xs_j, rngs, xs_j), jnp.zeros(2), jnp.asarray(xdes))
    sol_t = t_mpc(xs, draws, t_reset(xs, draws, xs), torch.zeros(2), xdes)
    assert sol_t.rng is draws
    assert_scenarios_match(sol_t, sol_j, jb, xs_np, rtol=P_TOL, atol=P_TOL)
    sol_j = j_mpc(xs_j, sol_j.rng, sol_j.opt_state, jnp.zeros(2), jnp.asarray(xdes))
    sol_t = t_mpc(xs, draws, sol_t.opt_state, torch.zeros(2), xdes)
    assert_scenarios_match(sol_t, sol_j, jb, xs_np, rtol=P_TOL, atol=P_TOL)


def test_batched_particles_draw_once_per_call(repo_root, monkeypatch):
    """With a generator, a P>1 call draws its (B, H, P, 13) block in one
    call: the same numbers as one ``torch.randn`` of that shape."""
    cfg = small_cfg(repo_root, "iris_posctrl_mpc", num_particles=4)
    cfg["apg_mpc"].update(max_iter=2, max_no_improvement_iter=2)
    calls = []
    orig = AK.apg_solve_plain_batched

    def spy(*args, **kw):
        calls.append(args[8].clone())
        return orig(*args, **kw)

    t_reset, t_mpc, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    xs, gen = make_batch_inputs(3, spread=0.3, device="cpu")
    monkeypatch.setattr(AK, "apg_solve_plain_batched", spy)
    sol = t_mpc(xs, gen, t_reset(xs, gen, xs), torch.zeros(3), xs)
    ref = torch.randn((3 * 6, 4, 13), generator=torch.Generator().manual_seed(0))
    assert len(calls) == 1 and calls[0].shape == (3, 4, 6, 13)
    assert torch.equal(calls[0], ref.reshape(3, 6, 4, 13).transpose(1, 2))
    assert sol.rng is gen and torch.isfinite(sol.u_opt).all()


@pytest.mark.parametrize("spread, seed, n", [(1.0, 0, 5), (0.5, 0, 256), (0.3, 7, 3)])
def test_make_batch_inputs_equal_jax(spread, seed, n):
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    xs_j, _ = jbatched.make_batch_inputs(mesh, n, seed=seed, spread=spread)
    xs_t, gen = make_batch_inputs(n, seed=seed, spread=spread, device="cpu")
    np.testing.assert_array_equal(xs_t.numpy(), np.array(xs_j))
    assert isinstance(gen, torch.Generator)


@pytest.mark.parametrize("mutation, route", [
    ({"solver": "mppi"}, "mppi_solve"),
    ({"apg_mpc.linesearch": None, "apg_mpc.stepsize": 1e-5}, "apg_solve_batched"),
    ({"solver": "policy"}, "policy_plan"),
])
def test_batched_oracle_and_policy_routes_run(repo_root, monkeypatch, mutation, route):
    """MPPI, fixed-step APG and the policy take their batched routes over
    the batched oracle (``tests/test_torch_batched_oracle.py`` holds them
    to the JAX package): one call of the route's solver for the batch, no
    whole-solve launch. The routes are the loader's solve, which
    ``make_batched_mpc`` serves."""
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader as ML

    cfg = small_cfg(repo_root, "iris_posctrl_mpc")
    cfg["mppi"] = {"samples": 8, "iters": 2}
    for key, val in mutation.items():
        blk, parts = cfg, key.split(".")
        for p in parts[:-1]:
            blk = blk[p]
        if val is None:
            del blk[parts[-1]]
        else:
            blk[parts[-1]] = val
    calls = []
    if route != "policy_plan":
        orig = getattr(ML, route)
        monkeypatch.setattr(ML, route, lambda *a, **k: calls.append(a) or orig(*a, **k))
    t_reset, t_mpc, tb = make_batched_mpc(cfg, device="cpu")
    xs, gen = make_batch_inputs(3, spread=0.3, device="cpu")
    sol = t_mpc(xs, gen, t_reset(xs, gen, xs), torch.zeros(3), xs)
    assert len(calls) == (0 if route == "policy_plan" else 1)
    assert sol.u_opt.shape == (3, 6, 4) and sol.x_evol.shape == (3, 7, 13)
    assert torch.isfinite(sol.u_opt).all() and torch.isfinite(sol.opt_state.opt_cost).all()
    if route == "policy_plan":
        assert (sol.opt_state.num_steps == 0).all()


def test_batched_defaults_to_card(repo_root):
    """No device means the card; without CUDA it raises (never the CPU)."""
    cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    if torch.cuda.is_available():
        assert make_batched_mpc(cfg)[2].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_batched_mpc(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_batch_inputs(2)


@pytest.mark.cuda
@pytest.mark.parametrize("name, P", [("iris_posctrl_mpc", 1), ("hexa_posctrl_mpc", 1),
                                     ("iris_posctrl_mpc", 8)])
def test_batched_kernel_equals_solo_launches_on_cuda(repo_root, name, P):
    """The batched launch (B scenarios on the kernel's grid) against B solo
    launches: every scenario's plan, stats and ``x_evol`` bit for bit, and
    one launch for the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU mode")
    cfg = j_load_yaml(os.path.join(repo_root, f"configs/{name}.yaml"))
    cfg["apg_mpc"].update(max_iter=30)
    if P > 1:
        cfg.update(num_particles=P, antithetic=True)
    dev = torch.device("cuda")
    t_reset, t_mpc, b = make_batched_mpc(copy.deepcopy(cfg), device=dev)
    _, (reset_1, mpc_1), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    xs, gen = make_batch_inputs(6, spread=0.5, device=dev)
    xdes = torch.from_numpy(targets(xs.cpu().numpy())).to(dev)
    noise = (torch.randn((6, P, 20, 13), generator=torch.Generator().manual_seed(1)).to(dev)
             if P > 1 else None)
    rngs = iter([noise]) if P > 1 else None
    launches = AK.apg_solve_kernel.launches
    sol = t_mpc(xs, rngs, t_reset(xs, None, xs), torch.zeros(6, device=dev), xdes)
    torch.cuda.synchronize()
    assert AK.apg_solve_kernel.launches == launches + 1
    for i in range(6):
        one = mpc_1(xs[i], iter([noise[i]]) if P > 1 else None,
                    reset_1(xs[i], None, xs[i]), 0.0, xdes[i])
        assert torch.equal(one.u_opt, sol.u_opt[i])
        assert torch.equal(one.x_evol, sol.x_evol[i])
        for f_one, f_b in zip(one.opt_state, sol.opt_state):
            assert torch.equal(f_one, f_b[i])
