"""Port parity, MPPI: ``solver/mppi.py::mppi_solve`` and the ``solver:
mppi`` route of the loader, on the CPU (the plain cost oracle).

- the toy quadratic and box-face cases of ``tests/test_mppi.py:14-34``;
- determinism per generator, and the documented draw order;
- lockstep with the JAX package's ``mppi_solve`` on the iris posctrl cost,
  with the draws reproduced from JAX's own key splits
  (``engine/mpc_loader.py:654``, ``solver/mppi.py:131-138``), rtol 1e-5;
  and the same with the sums a CUDA device runs (``ksum``'s tree) forced
  on the CPU, the last round's weight at rtol 1e-4;
- ``replay_solver_family("mppi")`` against
  ``tests/goldens/family_mppi_trace.npz`` at its own tolerance, 1e-4
  (``tests/test_goldens_flagship.py:128``), with JAX's draws injected;
- the 30-tick closed loop of ``tests/test_mppi.py:48-76`` with torch draws.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import H, load_port_bundles, problem
from sde4mbrl_px4_tpu.cost.cost import make_cost_fn
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde
from sde4mbrl_px4_tpu.solver.mppi import MPPIConfig as JMPPIConfig
from sde4mbrl_px4_tpu.solver.mppi import mppi_solve as j_mppi_solve
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.engine import goldens as G
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.solver.apg import CostOracle
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig, draw_mppi_noise, mppi_solve


def jax_draws(key, cfg: MPPIConfig, H: int, n: int):
    """The draws of one JAX ``mppi_solve(..., key)``, in its split order."""
    eps, c0 = [], []
    for _ in range(cfg.iters):
        key, sub, sub0 = jax.random.split(key, 3)
        eps.append(np.asarray(jax.random.normal(sub, (cfg.samples, H, n), jnp.float32)))
        c0.append(np.asarray(jax.random.normal(sub0, (cfg.samples, n), jnp.float32)))
    return (torch.from_numpy(np.stack(eps)),
            torch.from_numpy(np.stack(c0)) if cfg.noise_beta > 0 else None)


def jax_mpc_draws(cfg: MPPIConfig, n_solves: int, H: int = 20, n: int = 4):
    """Each solve's draws as the JAX ``mpc_fn`` makes them from PRNGKey(0):
    ``(noise, mppi, next) = split(rng, 3)`` per solve."""
    rng = jax.random.PRNGKey(0)
    for _ in range(n_solves):
        _, sub, rng = jax.random.split(rng, 3)
        yield jax_draws(sub, cfg, H, n)


def test_mppi_converges_on_quadratic():
    """min ||u - u*||^2 over a box: the mean walks to an interior optimum
    and pins to the box face when u* is outside."""
    Hq, n = 8, 3
    lb, ub = torch.zeros(n), torch.ones(n)
    cfg = MPPIConfig(samples=256, sigma=0.08, temperature=0.05, iters=40,
                     noise_beta=0.0)
    gen = torch.Generator().manual_seed(0)
    oracle = CostOracle.from_fn(lambda u: torch.sum((u - 0.4) ** 2))
    st = mppi_solve(oracle, torch.full((Hq, n), 0.9), lb, ub, cfg,
                    *draw_mppi_noise(gen, cfg, Hq, n, "cpu"))
    np.testing.assert_allclose(st.yk.numpy(), 0.4, atol=0.08)
    assert float(st.opt_cost) < float(st.init_cost)
    assert float(st.num_steps) == 40 and float(st.avg_linesearch) == 256
    face = CostOracle.from_fn(lambda u: torch.sum((u - 1.5) ** 2))
    st2 = mppi_solve(face, torch.full((Hq, n), 0.2), lb, ub, cfg,
                     *draw_mppi_noise(gen, cfg, Hq, n, "cpu"))
    np.testing.assert_allclose(st2.yk.numpy(), 1.0, atol=0.08)


def test_mppi_deterministic_per_generator():
    cfg = MPPIConfig(samples=64, iters=5)
    oracle = CostOracle.from_fn(lambda u: torch.sum(u ** 2))

    def solve(seed):
        eps, c0 = draw_mppi_noise(torch.Generator().manual_seed(seed), cfg, 4, 2, "cpu")
        return mppi_solve(oracle, torch.full((4, 2), 0.5), torch.zeros(2),
                          torch.ones(2), cfg, eps, c0).yk

    assert torch.equal(solve(7), solve(7))
    assert not torch.equal(solve(7), solve(8))


def test_draw_order_and_config():
    """One call draws eps (iters, K, H, n) then c0 (iters, K, n); no c0 at
    noise_beta 0. Unknown mppi keys warn."""
    cfg = MPPIConfig(samples=3, iters=2)
    eps, c0 = draw_mppi_noise(torch.Generator().manual_seed(1), cfg, 5, 4, "cpu")
    z = torch.randn(2 * 3 * 5 * 4 + 2 * 3 * 4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(eps.reshape(-1), z[:120]) and torch.equal(c0.reshape(-1), z[120:])
    assert draw_mppi_noise(torch.Generator(), cfg._replace(noise_beta=0.0), 5, 4,
                           "cpu")[1] is None
    with pytest.warns(UserWarning, match="unknown key"):
        assert MPPIConfig.from_config({"mppi": {"samples": 8, "sigmaa": 1}}).samples == 8
    assert MPPIConfig.from_config({}) == MPPIConfig()


def mppi_pair(iris_pos_bundle, repo_root, beta):
    """The JAX and the port's ``mppi_solve`` on the iris posctrl cost, K=64
    x 8 rounds, the same draws on both sides."""
    b = iris_pos_bundle[3]
    tb = load_port_bundles(repo_root)["iris_posctrl_mpc"]
    x0, x_ref, u_prev, u_init = problem(b.cost_params.uref, x_off=(0.5, 0.1))
    cost_fn = make_cost_fn(b.cost_params, b.time_steps)

    def seq_cost(u):
        xp, sg = rollout_sde(b.model, b.params, jnp.asarray(x0), u, b.time_steps,
                             jax.random.PRNGKey(0), 1, deterministic=True)
        return cost_fn(xp, sg, u, jnp.asarray(x_ref), jnp.asarray(u_prev))

    jcfg = JMPPIConfig(noise_beta=beta)
    key = jax.random.PRNGKey(5)
    st_j = jax.jit(lambda u: j_mppi_solve(seq_cost, u, b.lb, b.ub, jcfg, key))(
        jnp.asarray(u_init))
    cfg = MPPIConfig(noise_beta=beta)
    T = torch.from_numpy
    oracle = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps,
                            T(x0), T(x_ref), T(u_prev), None, 1, 4)
    st_t = mppi_solve(oracle, T(u_init), tb.lb, tb.ub, cfg,
                      *jax_draws(key, cfg, H, 4))
    for f in ("num_steps", "avg_linesearch", "stepsize", "avg_stepsize"):
        assert float(getattr(st_t, f)) == float(getattr(st_j, f)), f
    return st_t, st_j


@pytest.mark.parametrize("beta", [0.7, 0.0])
def test_mppi_lockstep_with_jax(iris_pos_bundle, repo_root, beta):
    """The iris posctrl cost, K=64 x 8 rounds, the same draws on both sides."""
    st_t, st_j = mppi_pair(iris_pos_bundle, repo_root, beta)
    np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_j.yk), rtol=1e-5, atol=1e-6)
    for f in ("init_cost", "opt_cost", "grad_sqr"):
        assert float(getattr(st_t, f)) == pytest.approx(float(getattr(st_j, f)),
                                                        rel=1e-5, abs=1e-7), f


@pytest.mark.parametrize("beta", [0.7, 0.0])
def test_mppi_tree_sums_lockstep_with_jax(iris_pos_bundle, repo_root, beta, monkeypatch):
    """The arithmetic a CUDA device runs (the sums over the candidates as
    ``ksum``'s tree, the softmax and the weighted plan from one stacked
    sum), forced on the CPU, against JAX: plans and costs rtol 1e-5, the
    last round's weight rtol 1e-4 (its order effect, as the batched test)."""
    import sde4mbrl_px4_tpu_torch.solver.mppi as M

    assert not M._tree_sums(torch.device("cpu")) and M._tree_sums(torch.device("cuda"))
    monkeypatch.setattr(M, "_tree_sums", lambda dev: True)
    st_t, st_j = mppi_pair(iris_pos_bundle, repo_root, beta)
    np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_j.yk), rtol=1e-5, atol=1e-6)
    for f in ("init_cost", "opt_cost"):
        assert float(getattr(st_t, f)) == pytest.approx(float(getattr(st_j, f)),
                                                        rel=1e-5, abs=1e-7), f
    assert float(st_t.grad_sqr) == pytest.approx(float(st_j.grad_sqr), rel=1e-4)


def test_family_mppi_replays_golden(repo_root):
    """The solver-family golden, with the JAX package's draws injected
    through ``mpc_fn``'s rng; no kernel launches on the CPU."""
    n0 = CO.value_batch_kernel.launches
    tr = G.replay_solver_family(repo_root, "mppi", draws=jax_mpc_draws(MPPIConfig(), 4),
                                device="cpu")
    assert CO.value_batch_kernel.launches == n0
    ref = np.load(os.path.join(G.golden_dir(repo_root), "family_mppi_trace.npz"))["trace"]
    assert tr.shape == ref.shape
    np.testing.assert_allclose(tr, ref, atol=1e-4, rtol=1e-4)


def test_policy_and_p512anti_families_replay(repo_root):
    """Every solver family replays: ``policy`` (the untrained init the config
    draws from its seed: rows of the hover plan, no iteration; its golden,
    on the JAX package's weights: ``tests/test_torch_policy.py``) and
    ``p512anti`` (its golden: ``tests/test_torch_particles.py``)."""
    rows = G.replay_solver_family(repo_root, "policy", n=2, device="cpu")
    assert rows.shape == (2, 5) and np.isfinite(rows).all() and (rows[:, -1] == 0).all()
    assert ((rows[:, :4] > 0) & (rows[:, :4] < 1)).all()
    rows = G.replay_solver_family(repo_root, "p512anti", n=1, device="cpu")
    assert rows.shape == (1, 5) and np.isfinite(rows).all() and 1 <= rows[0, -1] <= 6


def test_mppi_config_closed_loop(repo_root):
    """``solver: mppi`` (K=256) closes a 1 m position step in 30 ticks with
    draws from a torch generator, through the same mpc_fn contract."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg["solver"] = "mppi"
    cfg["mppi"] = {"samples": 256, "sigma": 0.02, "temperature": 0.1,
                   "iters": 8, "noise_beta": 0.7}
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # every mppi key is known
        cfg, (reset_fn, mpc_fn), _, bundle = make_mpc_from_config(cfg, device="cpu")
    assert bundle.precond is None
    x = hover_state()
    x[0] = 1.0
    tgt = hover_state()
    gen = torch.Generator().manual_seed(0)
    st = reset_fn(x, gen, x)
    e0 = float(torch.linalg.norm(x[:3]))
    for _ in range(30):
        u, st, rng, x_evol = mpc_fn(x, gen, st, 0.0, tgt, 3)   # budget ignored
        assert rng is gen
        x = x_evol[1]
    e1 = float(torch.linalg.norm(x[:3]))
    assert torch.isfinite(u).all()
    assert e1 < 0.35 * e0, (e0, e1)
    assert float(st.num_steps) == 8 and float(st.avg_linesearch) == 256
