"""Port parity, tuning: ``sde4mbrl_px4_tpu_torch/tuning/tuner.py`` against
the JAX package's ``tuning/tuner.py`` on the CPU, at a small size (H=6,
K=8, 3 rounds, at most 4 periods), given the JAX tuners' own draws:

- ``tune_mppi`` on the posctrl config (crn and not) and on the traj config:
  the first period's scores at the MPPI lockstep tolerance, rtol 1e-5; the
  4-period scores at rtol 1e-4 (chained solves are fp-chaotic,
  ``engine/goldens.py:67-71``: the later periods' plans drift by a few ulps
  a period) and the same ranking;
- ``tune_cost_weights`` on the posctrl config (crn and not; a 10-iteration
  budget) and on the traj config: the first period at the fixed-budget APG
  tolerance, rtol 2e-4 / atol 2e-5; the 4-period scores and errors at rtol
  1e-3 / atol 1e-5, their efforts at rtol 0.1 (a later period's flipped
  Armijo decision, ``CHAIN_EFFORT_RTOL``), and the same ranking;
- the JAX suite's own checks as twins (``tests/test_tuning.py``): grid
  order and validation, ranking sanity, a deterministic plant, the YAML
  blocks; ``mesh=`` refused, naming its ROADMAP item;
- per-scenario knobs and weights in one batched call equal to each
  candidate's solo call with its own knobs or weights (the CPU runs the
  card's tree sums for MPPI, bit for bit);
- on the card (``cuda``): the same, through the kernels.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.io.config import load_yaml_config
from sde4mbrl_px4_tpu.tuning import tuner as J
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.cost.cost import scenario_cost
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc, make_mpc_from_config
from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc
from sde4mbrl_px4_tpu_torch.solver import mppi as M
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig
from sde4mbrl_px4_tpu_torch.tuning import (
    TuneResult, WeightTuneResult, make_mppi_grid, make_weight_grid, tune_cost_weights,
    tune_mppi)

H, STEPS = 6, 4
MPPI_RTOL = 1e-5                     # the MPPI lockstep (tests/test_torch_mppi.py)
APG_RTOL, APG_ATOL = 2e-4, 2e-5      # fixed-budget APG (tests/test_apg_kernel.py:60-69)
CHAIN_MPPI_RTOL = 1e-4               # 4 chained periods, MPPI
CHAIN_APG_RTOL, CHAIN_APG_ATOL = 1e-3, 1e-5   # 4 chained periods, APG
# ... but the effort of the 4 periods' first controls at rtol 0.1: near a tie
# one Armijo decision of a later period flips (the traj config's fourth
# period moves one candidate's effort 12 %, its position by 1e-9 m)
CHAIN_EFFORT_RTOL = 0.1
MPPI_GRID = make_mppi_grid([1e-6, 0.03], [0.1], [0.0, 0.7])
WEIGHT_GRID = make_weight_grid([0.05, 20.0], [1.0], [1.0, 10.0], [1.0])


@pytest.fixture(scope="module", autouse=True)
def precond_cache(tmp_path_factory):
    """The traj config at H=6 has no committed hover_diag metric: both
    packages probe it and write it here, not under configs/models/."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDE4MBRL_PRECOND_CACHE", str(tmp_path_factory.mktemp("precond")))
        yield


def _cfg(repo_root, name, solver=None, max_iter=None):
    cfg = load_yaml_config(os.path.join(repo_root, f"configs/{name}.yaml"))
    cfg["horizon"] = cfg["num_short_dt"] = H
    if solver == "mppi":
        cfg["solver"] = "mppi"
        cfg["mppi"] = {"samples": 8, "sigma": 0.02, "temperature": 0.1, "iters": 3,
                       "noise_beta": 0.5}
    if max_iter is not None:
        cfg["apg_mpc"]["max_iter"] = max_iter
    return cfg


def _keys(seed: int, N: int, crn: bool):
    key = jax.random.PRNGKey(seed)
    return [key] * N if crn else list(jax.random.split(key, N))


def jax_mppi_draws(cfg, N: int, steps: int, crn: bool, seed: int = 0, n_u: int = 4):
    """Each period's ``(eps, c0)`` as the JAX tuner's candidates draw them:
    candidate i's key (``tuner.py:165-169``) threaded through ``mpc_fn``
    (``(noise, mppi, next) = split(rng, 3)``, ``engine/mpc_loader.py:654``),
    each round ``(key, sub, sub0) = split(key, 3)``; the traced beta always
    draws ``c0`` (``solver/mppi.py:133-138``). Shared draws under crn."""
    m = cfg["mppi"]
    K, iters = int(m["samples"]), int(m["iters"])
    per = []
    for rng in _keys(seed, 1 if crn else N, crn):
        rows = []
        for _ in range(steps):
            _, key, rng = jax.random.split(rng, 3)
            eps, c0 = [], []
            for _ in range(iters):
                key, sub, sub0 = jax.random.split(key, 3)
                eps.append(np.asarray(jax.random.normal(sub, (K, H, n_u), jnp.float32)))
                c0.append(np.asarray(jax.random.normal(sub0, (K, n_u), jnp.float32)))
            rows.append((np.stack(eps), np.stack(c0)))
        per.append(rows)
    for k in range(steps):
        eps = np.stack([p[k][0] for p in per])
        c0 = np.stack([p[k][1] for p in per])
        yield (torch.from_numpy(eps[0]), torch.from_numpy(c0[0])) if crn else \
            (torch.from_numpy(eps), torch.from_numpy(c0))


def jax_plant_draws(N: int, steps: int, crn: bool, seed: int = 0):
    """Each period's plant noise as the JAX weight tuner draws it
    (``tuner.py:307-315``): ``(solver, plant) = split(rng)``, then per
    period ``(plant, sub) = split(plant)``, ``normal(sub, (13,))``."""
    per = []
    for rng in _keys(seed, 1 if crn else N, crn):
        _, rng_p = jax.random.split(rng)
        rows = []
        for _ in range(steps):
            rng_p, sub = jax.random.split(rng_p)
            rows.append(np.asarray(jax.random.normal(sub, (13,))))
        per.append(rows)
    for k in range(steps):
        z = np.stack([p[k] for p in per])
        yield torch.from_numpy(z[0] if crn else z)


_JAX = {}


def jax_tune(kind, cfg, grid, steps, crn, **kw):
    """The JAX tuner's rows in grid order (each configuration run once per
    module)."""
    key = (kind, repr(sorted((k, repr(v)) for k, v in cfg.items())), grid.tobytes(), steps,
           crn, repr(sorted(kw.items())))
    if key not in _JAX:
        fn = J.tune_mppi if kind == "mppi" else J.tune_cost_weights
        res = fn(copy.deepcopy(cfg), grid, steps=steps, seed=0, crn=crn, **kw)
        _JAX[key] = res
    return _JAX[key]


def _by_grid(rows, grid, fields):
    """Result rows in grid order (their knob fields identify them)."""
    index = {tuple(np.float32(getattr(r, f)) for f in fields): r for r in rows}
    return [index[tuple(np.float32(v) for v in g)] for g in grid]


MPPI_FIELDS = ("sigma", "temperature", "noise_beta")
WEIGHT_FIELDS = ("p_scale", "v_scale", "q_scale", "w_scale")


def _assert_rows(port, ref, grid, fields, scores, rtol, atol=0.0):
    t, j = _by_grid(port, grid, fields), _by_grid(ref, grid, fields)
    for f in scores:
        np.testing.assert_allclose([getattr(r, f) for r in t], [getattr(r, f) for r in j],
                                   rtol=rtol, atol=atol, err_msg=f)


def _same_ranking(port, ref, fields, key, rtol, atol=0.0) -> int:
    """The same order for every pair of candidates whose JAX scores differ
    by more than the stated tolerance (closer pairs may swap: their order is
    the chained solves' rounding); returns how many pairs that checks."""
    rank = {tuple(getattr(r, f) for f in fields): i for i, r in enumerate(port)}
    checked = 0
    for i, a in enumerate(ref):
        for b in ref[i + 1:]:
            va, vb = getattr(a, key), getattr(b, key)
            if vb - va > rtol * abs(vb) + atol:
                checked += 1
                assert rank[tuple(getattr(a, f) for f in fields)] < \
                    rank[tuple(getattr(b, f) for f in fields)], (va, vb)
    return checked


# ------------------------------------------------------------------ twins

def test_make_grids_equal_jax():
    g = make_mppi_grid([0.01, 0.02], [0.1], [0.0, 0.5, 0.9])
    assert g.shape == (6, 3) and g.dtype == np.float32
    np.testing.assert_array_equal(g, J.make_mppi_grid([0.01, 0.02], [0.1], [0.0, 0.5, 0.9]))
    assert np.allclose(g[0], [0.01, 0.1, 0.0]) and np.allclose(g[-1], [0.02, 0.1, 0.9])
    w = make_weight_grid([0.5, 1.0], [1.0], [1.0, 2.0], [1.0])
    np.testing.assert_array_equal(w, J.make_weight_grid([0.5, 1.0], [1.0], [1.0, 2.0], [1.0]))
    assert np.allclose(w[0], [0.5, 1.0, 1.0, 1.0]) and np.allclose(w[-1], [1.0, 1.0, 2.0, 1.0])


@pytest.mark.parametrize("kind", ["mppi", "weights"])
def test_grid_shape_validation_and_mesh_refused(repo_root, kind):
    cfg = _cfg(repo_root, "iris_posctrl_mpc", "mppi" if kind == "mppi" else None)
    fn = tune_mppi if kind == "mppi" else tune_cost_weights
    with pytest.raises(ValueError, match="grid must be"):
        fn(cfg, np.zeros((4, 2 if kind == "mppi" else 3)), steps=2, device="cpu")
    grid = MPPI_GRID if kind == "mppi" else WEIGHT_GRID
    with pytest.raises(NotImplementedError, match="Batched and fleet over more than one GPU"):
        fn(cfg, grid, steps=2, device="cpu", mesh=object())


def test_yaml_blocks_equal_jax():
    import yaml

    r = TuneResult(sigma=0.02, temperature=0.1, noise_beta=0.7, mean_pos_err=0.1,
                   final_pos_err=0.05)
    rj = J.TuneResult(*r)
    assert r.yaml_block(samples=64, iters=8) == rj.yaml_block(samples=64, iters=8)
    assert yaml.safe_load(r.yaml_block(samples=64, iters=8))["mppi"] == {
        "samples": 64, "sigma": 0.02, "temperature": 0.1, "iters": 8, "noise_beta": 0.7}
    w = WeightTuneResult(p_scale=2.0, v_scale=1.0, q_scale=0.5, w_scale=1.0, score=0.1,
                         mean_pos_err=0.1, effort=0.01)
    base = {"perr": [10, 10, 20], "verr": 1.0, "qerr": [2, 2, 2], "werr": [1, 1, 1]}
    assert w.yaml_block(base) == J.WeightTuneResult(*w).yaml_block(base)
    block = yaml.safe_load(w.yaml_block(base))["cost_params"]
    assert block["perr"] == [20, 20, 40] and block["qerr"] == [1, 1, 1]


# ------------------------------------------------------- lockstep with JAX

@pytest.mark.parametrize("name, crn", [("iris_posctrl_mpc", True), ("iris_posctrl_mpc", False),
                                       ("iris_traj_mpc", True)])
def test_tune_mppi_matches_jax(repo_root, name, crn):
    """Given the JAX tuner's draws: the first period at rtol 1e-5, four
    periods at rtol 1e-4 with the same ranking."""
    cfg = _cfg(repo_root, name, "mppi")
    N = len(MPPI_GRID)
    for steps, rtol in ((1, MPPI_RTOL), (STEPS, CHAIN_MPPI_RTOL)):
        ref = jax_tune("mppi", cfg, MPPI_GRID, steps, crn)
        port = tune_mppi(copy.deepcopy(cfg), MPPI_GRID, steps=steps, crn=crn, device="cpu",
                         draws=jax_mppi_draws(cfg, N, steps, crn))
        assert len(port) == N
        _assert_rows(port, ref, MPPI_GRID, MPPI_FIELDS, ("mean_pos_err", "final_pos_err"),
                     rtol)
    _same_ranking(port, ref, MPPI_FIELDS, "mean_pos_err", rtol)


@pytest.mark.parametrize("name, crn", [("iris_posctrl_mpc", True), ("iris_posctrl_mpc", False),
                                       ("iris_traj_mpc", True)])
def test_tune_cost_weights_matches_jax(repo_root, name, crn):
    """Given the JAX tuner's plant draws: the first period at the
    fixed-budget APG tolerance, four periods at rtol 1e-3 / atol 1e-5 with
    the same ranking."""
    cfg = _cfg(repo_root, name, max_iter=10)
    N = len(WEIGHT_GRID)
    for steps, rtol, atol in ((1, APG_RTOL, APG_ATOL), (STEPS, CHAIN_APG_RTOL, CHAIN_APG_ATOL)):
        ref = jax_tune("weights", cfg, WEIGHT_GRID, steps, crn, effort_weight=0.05)
        port = tune_cost_weights(copy.deepcopy(cfg), WEIGHT_GRID, steps=steps, crn=crn,
                                 effort_weight=0.05, device="cpu",
                                 draws=jax_plant_draws(N, steps, crn))
        _assert_rows(port, ref, WEIGHT_GRID, WEIGHT_FIELDS, ("score", "mean_pos_err"), rtol,
                     atol)
        _assert_rows(port, ref, WEIGHT_GRID, WEIGHT_FIELDS, ("effort",),
                     rtol if steps == 1 else CHAIN_EFFORT_RTOL, atol)
    pairs = _same_ranking(port, ref, WEIGHT_FIELDS, "score", rtol, atol)
    if name == "iris_traj_mpc":
        assert pairs >= 4          # the weights move the traj scores apart


# ------------------------------------------------- the JAX suite's checks

def test_ranking_flags_degenerate_candidate(repo_root):
    """``tests/test_tuning.py::test_ranking_flags_degenerate_candidate``: no
    exploration (sigma ~ 0) ranks behind a sane candidate over 1.5 s, on
    the port's own draws and on the JAX tuner's, where the JAX tuner ranks
    them the same."""
    cfg = _cfg(repo_root, "iris_posctrl_mpc", "mppi")
    cfg["mppi"] = {"samples": 16, "sigma": 0.02, "temperature": 0.1, "iters": 5,
                   "noise_beta": 0.5}
    grid = np.asarray([[1e-6, 0.1, 0.5], [0.03, 0.1, 0.5]], np.float32)
    for draws in (None, jax_mppi_draws(cfg, 2, 30, True)):
        res = tune_mppi(copy.deepcopy(cfg), grid, steps=30, seed=0, device="cpu", draws=draws)
        assert all(np.isfinite([r.mean_pos_err for r in res]))
        assert res[0].mean_pos_err <= res[1].mean_pos_err
        assert res[0].sigma == pytest.approx(0.03)
    ref = jax_tune("mppi", cfg, grid, 30, True)
    assert [r.sigma for r in ref] == [r.sigma for r in res]


def test_weight_tuner_ranks_position_weight(repo_root):
    """``tests/test_tuning.py::test_weight_tuner_ranks_position_weight``:
    scaling the position weight up tracks the 1 m step better."""
    cfg = _cfg(repo_root, "iris_posctrl_mpc", max_iter=15)
    grid = make_weight_grid([0.2, 5.0], [1.0], [1.0], [1.0])
    for draws in (None, jax_plant_draws(2, 20, True)):
        res = tune_cost_weights(copy.deepcopy(cfg), grid, steps=20, seed=0,
                                effort_weight=0.05, device="cpu", draws=draws)
        assert res[0].p_scale == pytest.approx(5.0)
        assert res[0].mean_pos_err < res[1].mean_pos_err
        assert all(np.isfinite([r.score for r in res])) and all(r.effort >= 0.0 for r in res)
    ref = jax_tune("weights", cfg, grid, 20, True, effort_weight=0.05)
    assert [r.p_scale for r in ref] == [r.p_scale for r in res]


def test_weight_tuner_deterministic_plant(repo_root):
    """``noisy_plant=False``: the mean dynamics, two runs equal; and equal
    to the JAX tuner's (first period, the APG tolerance)."""
    cfg = _cfg(repo_root, "iris_posctrl_mpc", max_iter=10)
    grid = np.asarray([[1.0, 1.0, 1.0, 1.0]], np.float32)
    a = tune_cost_weights(dict(cfg), grid, steps=4, noisy_plant=False, device="cpu")[0]
    b = tune_cost_weights(dict(cfg), grid, steps=4, noisy_plant=False, device="cpu")[0]
    assert a.mean_pos_err == b.mean_pos_err
    one = tune_cost_weights(dict(cfg), grid, steps=1, noisy_plant=False, device="cpu")[0]
    ref = jax_tune("weights", cfg, grid, 1, True, noisy_plant=False)[0]
    assert one.mean_pos_err == pytest.approx(ref.mean_pos_err, rel=APG_RTOL, abs=APG_ATOL)


def test_traced_knobs_match_static_config(repo_root):
    """``tests/test_tuning.py::test_traced_config_matches_static``: a 1-row
    sweep reproduces the config-built solver's closed loop flown by hand
    with the same draws."""
    cfg = _cfg(repo_root, "iris_posctrl_mpc", "mppi")
    row = np.asarray([[0.02, 0.1, 0.5]], np.float32)
    draws = list(jax_mppi_draws(cfg, 1, STEPS, True))
    res = tune_mppi(dict(cfg), row, steps=STEPS, device="cpu", draws=iter(draws))[0]
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    x = hover_state()
    x[0] = 1.0
    xdes = hover_state()
    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned

    tgt = enu2ned(xdes)
    st = reset_fn(x, None, x)
    errs = []
    for k in range(STEPS):
        t = np.float32(0.0) + np.float32(k) * np.float32(0.05)
        u, st, _, x_evol = mpc_fn(x, iter([draws[k]]), st, float(t), xdes)
        x = x_evol[1]
        errs.append(float(torch.linalg.norm(x[:3] - tgt[:3])))
    assert res.mean_pos_err == pytest.approx(float(np.mean(errs)), rel=1e-6)
    assert res.final_pos_err == pytest.approx(errs[-1], rel=1e-6)


# ---------------------------------- per-scenario knobs and weights = solo

def _period_inputs(b, N, dev):
    x = hover_state(dev).expand(N, 13).clone()
    x[:, 0] = torch.linspace(0.5, 1.0, N, device=dev)
    return x, hover_state(dev).expand(N, 13)


def _assert_solo_equal(sol, solos):
    for i, one in enumerate(solos):
        assert torch.equal(one.u_opt, sol.u_opt[i]) and torch.equal(one.x_evol, sol.x_evol[i])
        for f in sol.opt_state._fields:
            assert torch.equal(getattr(one.opt_state, f), getattr(sol.opt_state, f)[i]), f


def _knob_batch(repo_root, dev):
    cfg = _cfg(repo_root, "iris_posctrl_mpc", "mppi")
    grid = torch.from_numpy(MPPI_GRID).to(dev)
    knobs = MPPIConfig(samples=8, sigma=grid[:, 0], temperature=grid[:, 1], iters=3,
                       noise_beta=grid[:, 2])
    N = len(MPPI_GRID)
    reset_b, mpc_b, b = make_batched_mpc(copy.deepcopy(cfg), device=dev, mppi_params=knobs)
    xs, xdes = _period_inputs(b, N, dev)
    gen = torch.Generator().manual_seed(3)
    eps, c0 = M.draw_mppi_noise(gen, knobs, H, 4, dev, batch=(N,))
    st = reset_b(xs, None, xdes)
    sol = mpc_b(xs, iter([(eps, c0)]), st, torch.zeros(N, device=dev), xdes)
    solos = []
    for i, g in enumerate(MPPI_GRID):
        one = MPPIConfig(samples=8, sigma=float(g[0]), temperature=float(g[1]), iters=3,
                         noise_beta=float(g[2]))
        _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device=dev,
                                                           mppi_params=one)
        solos.append(mpc_fn(xs[i], iter([(eps[i], c0[i])]), reset_fn(xs[i], None, xdes[i]),
                            0.0, xdes[i]))
    return sol, solos


def _weight_batch(repo_root, dev, name="iris_posctrl_mpc"):
    cfg = _cfg(repo_root, name, max_iter=10)
    _, probe, _ = build_mpc(copy.deepcopy(cfg), device=dev)
    hp = torch.from_numpy(WEIGHT_GRID).to(dev)
    cp0 = probe.cost_params
    cp = cp0._replace(perr=cp0.perr * hp[:, 0:1], verr=cp0.verr * hp[:, 1:2],
                      qerr=cp0.qerr * hp[:, 2:3], werr=cp0.werr * hp[:, 3:4])
    N = len(WEIGHT_GRID)
    reset_b, mpc_b, b = make_batched_mpc(copy.deepcopy(cfg), device=dev,
                                         cost_params_override=cp)
    xs, xdes = _period_inputs(b, N, dev)
    sol = mpc_b(xs, None, reset_b(xs, None, xdes), torch.zeros(N, device=dev), xdes)
    solos = []
    for i in range(N):
        _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(
            copy.deepcopy(cfg), device=dev, cost_params_override=scenario_cost(cp, i))
        solos.append(mpc_fn(xs[i], None, reset_fn(xs[i], None, xdes[i]), 0.0, xdes[i]))
    return sol, solos


def test_per_scenario_knobs_equal_solo_calls(repo_root, monkeypatch):
    """One batched MPPI call with (N,) knob tensors against each candidate's
    solo call with its knobs as Python floats, on the card's tree sums:
    bit for bit (beta 0 included: the chain then gives the raw noise)."""
    monkeypatch.setattr(M, "_tree_sums", lambda dev: True)
    sol, solos = _knob_batch(repo_root, torch.device("cpu"))
    _assert_solo_equal(sol, solos)
    # the knobs reach the solve: sigma is reported per scenario
    np.testing.assert_array_equal(sol.opt_state.stepsize.numpy(), MPPI_GRID[:, 0])


def test_per_scenario_weights_equal_solo_calls(repo_root):
    """One batched APG call with (N, 3) tracking weights against each
    candidate's solo call with its own weights, bit for bit; the weights
    change the plans."""
    sol, solos = _weight_batch(repo_root, torch.device("cpu"))
    _assert_solo_equal(sol, solos)
    assert not torch.equal(sol.u_opt[0], sol.u_opt[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["knobs", "weights", "weights_traj"])
def test_per_scenario_inputs_equal_solo_launches_on_cuda(repo_root, what):
    """The same on the card: one batched launch per evaluation, each
    candidate bit-equal to its solo launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    dev = torch.device("cuda")
    if what == "knobs":
        sol, solos = _knob_batch(repo_root, dev)
    else:
        sol, solos = _weight_batch(repo_root, dev,
                                   "iris_traj_mpc" if what == "weights_traj" else
                                   "iris_posctrl_mpc")
    _assert_solo_equal(sol, solos)
