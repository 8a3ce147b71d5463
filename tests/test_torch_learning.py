"""Port parity, SDE training and evaluation (``learning/trainer.py``,
``learning/evaluate.py``) against the JAX package's, on the CPU, from the
same inputs (numpy from a seed; the JAX package's ``init_params`` weights
carried across with ``params_from_numpy``).

- the dataset's windows and its ``RandomState`` batches: identical;
- ``make_loss_fn`` on one batch: the value at rtol 2e-5 (the rollout-cost
  tolerance, ``tests/test_pallas_kernels.py:76``), the gradient of every
  leaf at rtol 5e-4 / atol 5e-5 (``:86``);
- ``train_sde``, 10 steps of ``torch.optim.AdamW`` in lockstep with
  ``optax.adamw`` on the same batches: every parameter at rtol 1e-4, with
  an atol of a thousandth of one Adam step (lr / 1000: an entry whose
  gradient is near 0 moves by up to lr on either package's rounding; the
  worst such entry reads ~0.7e-3 lr), and the logged loss;
- ``kstep_errors`` at rtol 1e-4, atol 1e-6 (the attitude angle at 1e-3 rad:
  float32 ``arccos`` near 1 resolves ~3.5e-4 rad); ``calibration`` given JAX's own draws
  (its per-window ``draw_brownian`` keys): coverage within one (window,
  dim) pair, the spread ratio at rtol 1e-4;
- the twin of ``tests/test_learning.py::test_sysid_from_flight_log``, from
  a log recorded by the port, on a 64-wide and on a 32-wide trunk (the
  trainer takes any width);
- ``mesh=`` runs data-parallel over a pair of CPU ranks, within the
  lockstep tolerance of one process on the same batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.learning import evaluate as JE
from sde4mbrl_px4_tpu.learning import trainer as JT
from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE as JNeuralSDE
from sde4mbrl_px4_tpu.models.sde_model import init_params as j_init_params
from sde4mbrl_px4_tpu.models.vehicles import iris_config as j_iris
from sde4mbrl_px4_tpu.ops.rollout import draw_brownian as j_draw_brownian
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.learning import evaluate as TE
from sde4mbrl_px4_tpu_torch.learning import trainer as TT
from sde4mbrl_px4_tpu_torch.models.params_io import params_from_numpy, params_to_numpy
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, init_params
from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
STEP_RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return JNeuralSDE(vehicle=j_iris()), NeuralSDE.for_vehicle(iris_config())


@pytest.fixture(scope="module")
def flight(models):
    """(t, x, u, true params, init params as numpy): 240 samples of the
    "true" vehicle (+8 % thrust gain) rolled by the port's mean dynamics
    under hover-plus-excitation commands, the init from the JAX package's
    ``init_params`` (the numbers both packages start from)."""
    _, tm = models
    true = params_to_numpy(init_params(torch.Generator().manual_seed(1), tm))
    true["motor"]["log_gain"] = np.array([0.08, -0.04, 0.02, 0.0], np.float32)
    tp = params_from_numpy(true)
    rs = np.random.RandomState(0)
    x = hover_state()
    xs, us = [], []
    for k in range(240):
        u = np.clip(0.71 + 0.05 * np.sin(0.05 * k + np.arange(4))
                    + 0.01 * rs.randn(4), 1e-4, 1.0).astype(np.float32)
        xs.append(x.numpy())
        us.append(u)
        x = rollout_mean(tm, tp, x, torch.from_numpy(u)[None], torch.full((1,), 0.02))[1]
    t = np.arange(240) * 0.02
    init = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(2), models[0]))
    return t, np.stack(xs), np.stack(us), true, init


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def test_dataset_windows_and_batches_equal_jax(flight):
    t, x, u, _, _ = flight
    a, b = TT.TrajectoryDataset(t, x, u, 6), JT.TrajectoryDataset(t, x, u, 6)
    assert a.dt == b.dt and a.window == b.window == 6
    for f in ("x0", "u_win", "x_tgt"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    ia, ib = a.batches(32, seed=7), b.batches(32, seed=7)
    for _ in range(3):
        for pa, pb in zip(next(ia), next(ib)):
            np.testing.assert_array_equal(pa, pb)
    with pytest.raises(ValueError, match="shorter"):
        TT.TrajectoryDataset(t[:4], x[:4], u[:4], 6)


def test_loss_and_gradient_match_jax(models, flight):
    jm, tm = models
    t, x, u, _, init = flight
    cfg = TT.TrainConfig(window=6, pos_weight=2.0)
    ds = TT.TrajectoryDataset(t, x, u, cfg.window)
    batch = next(ds.batches(64, seed=3))
    j_loss, j_grad = jax.value_and_grad(JT.make_loss_fn(jm, ds.dt, JT.TrainConfig(
        window=6, pos_weight=2.0)))(jax.tree.map(jnp.asarray, init), *map(jnp.asarray, batch))
    params = TT._leaves(init, torch.device("cpu"))
    loss = TT.make_loss_fn(tm, ds.dt, cfg)(params, *map(torch.from_numpy, batch))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    grads = {k: v.grad.numpy() for k, v in _leaf_items(params)}
    for name, g in _flat(j_grad).items():
        np.testing.assert_allclose(grads[name], g, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_train_sde_lockstep_with_jax(models, flight):
    """10 AdamW steps from the same weights on the same batches: the
    decoupled decay scaled by the learning rate and eps outside the square
    root are optax's (a form that differs drifts past 1e-4 here)."""
    jm, tm = models
    t, x, u, _, init = flight
    kw = dict(window=4, batch_size=32, steps=10, lr=1e-3, weight_decay=1e-2, seed=5)
    ds_t, ds_j = TT.TrajectoryDataset(t, x, u, 4), JT.TrajectoryDataset(t, x, u, 4)
    logs_t, logs_j = [], []
    pt, mt = TT.train_sde(tm, init, ds_t, TT.TrainConfig(**kw), log_every=3,
                          log=logs_t.append, device="cpu")
    pj, mj = JT.train_sde(jm, jax.tree.map(jnp.asarray, init), ds_j, JT.TrainConfig(**kw),
                          log_every=3, log=logs_j.append)
    moved = 0
    for name, v in _flat(pj).items():
        np.testing.assert_allclose(_flat(pt)[name], v, rtol=STEP_RTOL, atol=kw["lr"] / 1000,
                                   err_msg=name)
        moved += int(np.abs(v - _flat(init)[name]).max() > 1e-3)
    assert moved >= 5                                  # every layer moved
    assert len(logs_t) == len(logs_j) == 4
    np.testing.assert_allclose(mt["final_loss"], mj["final_loss"], rtol=STEP_RTOL)
    assert all(isinstance(v, torch.Tensor) and not v.requires_grad for _, v in _leaf_items(pt))


def test_kstep_errors_match_jax(models, flight):
    """The init model's errors (cm to m) at rtol 1e-4; the true model
    predicts its own flight to float32 rounding in both packages."""
    jm, tm = models
    t, x, u, true, init = flight
    for p in (true, init):
        a = TE.kstep_errors(tm, p, t, x, u, ks=(1, 5, 20), max_windows=64, device="cpu")
        b = JE.kstep_errors(jm, jax.tree.map(jnp.asarray, p), t, x, u, ks=(1, 5, 20),
                            max_windows=64)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k]["windows"] == b[k]["windows"] and a[k]["horizon_s"] == b[k]["horizon_s"]
            for f in ("pos_rmse_m", "vel_rmse_mps", "att_err_rad", "rate_rmse_radps"):
                if p is true:
                    assert max(a[k][f], b[k][f]) < (2e-3 if f == "att_err_rad" else 1e-5)
                    continue
                np.testing.assert_allclose(a[k][f], b[k][f], rtol=1e-4,
                                           atol=1e-3 if f == "att_err_rad" else 1e-6,
                                           err_msg=f"{k} {f}")
        if p is init:
            assert a["k20"]["pos_rmse_m"] > 1e-3


def _jax_calibration_draws(seed, W, P, k):
    """The (W, P, k, 13) block JAX's ``calibration`` draws: window w's
    ``rollout_sde`` draws (k, P, 13) from ``split(PRNGKey(seed), W)[w]``."""
    rngs = jax.random.split(jax.random.PRNGKey(seed), W)
    return np.stack([np.swapaxes(np.asarray(j_draw_brownian(r, k, P)), 0, 1) for r in rngs])


def test_calibration_matches_jax_given_its_draws(models, flight):
    jm, tm = models
    t, x, u, _, init = flight
    p = dict(init, diffusion_log_scale=np.float32(np.log(0.3)))
    kw = dict(k=8, num_particles=32, max_windows=16, seed=4)
    b = JE.calibration(jm, jax.tree.map(jnp.asarray, p), t, x, u, **kw)
    W = b["windows"]
    draws = iter([_jax_calibration_draws(4, W, 32, 8)])
    a = TE.calibration(tm, p, t, x, u, rng=draws, device="cpu", **kw)
    assert {k: a[k] for k in ("k", "horizon_s", "num_particles", "windows")} == \
        {k: b[k] for k in ("k", "horizon_s", "num_particles", "windows")}
    for q, cov in b["coverage"].items():
        assert abs(a["coverage"][q] - cov) <= 1.0 / (W * 9) + 1e-12, (q, a, b)
    np.testing.assert_allclose(a["spread_ratio"], b["spread_ratio"], rtol=1e-4)
    # the port's own draws: a generator, the same report shape
    c = TE.calibration(tm, p, t, x, u, device="cpu", **kw)
    assert c["windows"] == W and 0.0 <= c["coverage"]["0.90"] <= 1.0
    with pytest.raises(ValueError, match="Brownian block"):
        TE.calibration(tm, p, t, x, u, rng=iter([np.zeros((1, 2, 3, 13))]), device="cpu", **kw)


@pytest.mark.parametrize("hidden", [64, 32])
def test_sysid_from_flight_log(tmp_path, models, hidden):
    """Flight log recorded by the port -> dataset -> 20 training steps: the
    NLL falls on the log's windows; the pre-engagement row is dropped."""
    from sde4mbrl_px4_tpu_torch.io.flight_log import FlightRecorder

    _, tm = models
    true = params_from_numpy(params_to_numpy(init_params(
        torch.Generator().manual_seed(0), tm, hidden=hidden)))
    rec = FlightRecorder()
    x = hover_state()
    rs = np.random.RandomState(0)
    rec.record(0.0, x.numpy(), cmd_motors=None)           # pre-engagement row
    tt = 0.0
    for _ in range(160):
        u = np.clip(0.71 + 0.05 * rs.randn(4), 0.1, 1.0).astype(np.float32)
        x = rollout_mean(tm, true, x, torch.from_numpy(u)[None], torch.tensor([0.02]))[1]
        tt += 0.02
        rec.record(tt, x.numpy(), cmd_motors=np.concatenate([u, np.zeros(2)]))
    p = str(tmp_path / "flight.npz")
    rec.save(p)
    ds = TT.TrajectoryDataset.from_flight_log(p, window=4)
    assert ds.x0.shape[0] == 156
    start = params_to_numpy(true)
    start["motor"]["log_gain"] = start["motor"]["log_gain"] + 0.05
    cfg = TT.TrainConfig(window=4, batch_size=32, steps=20, lr=1e-3)
    loss_fn = TT.make_loss_fn(tm, ds.dt, cfg)
    b0 = [torch.from_numpy(a) for a in next(ds.batches(64, seed=1))]
    before = float(loss_fn(params_from_numpy(start), *b0))
    fitted, metrics = TT.train_sde(tm, start, ds, cfg, log=lambda *a: None, device="cpu")
    assert float(loss_fn(fitted, *b0)) < before
    assert np.isfinite(metrics["final_loss"]) and fitted["net"]["w1"].shape == (hidden, hidden)


def test_mesh_is_refused(models, flight):
    """``mesh=`` runs: 10 data-parallel steps over a pair of CPU ranks (a
    (2, 1) mesh, ``parallel/rank_tasks.py::train``; each rank its half of
    every batch, the gradients summed in rank order and halved) against
    one process on the same batches: every parameter at the lockstep
    tolerance above (rtol 1e-4, atol lr / 1000), the final loss at rtol
    1e-4; a batch that does not divide over dp raises."""
    from sde4mbrl_px4_tpu_torch.parallel.distributed import spawn_ranks

    t, x, u, _, init = flight
    kw = dict(window=4, batch_size=32, steps=10, lr=1e-3, weight_decay=1e-2, seed=5)
    ranks = spawn_ranks("sde4mbrl_px4_tpu_torch.parallel.rank_tasks:train", 2,
                        dict(params=init, t=t, x=x, u=u, train_cfg=kw, devices="cpu"),
                        timeout=90.0)
    one, m1 = TT.train_sde(models[1], init, TT.TrajectoryDataset(t, x, u, 4),
                           TT.TrainConfig(**kw), log=lambda *a: None, device="cpu")
    for name, v in _flat(one).items():
        for r in ranks:
            np.testing.assert_allclose(_flat(r["params"])[name], v, rtol=STEP_RTOL,
                                       atol=kw["lr"] / 1000, err_msg=name)
        np.testing.assert_array_equal(_flat(ranks[0]["params"])[name],
                                      _flat(ranks[1]["params"])[name])
    np.testing.assert_allclose(ranks[0]["final_loss"], m1["final_loss"], rtol=STEP_RTOL)
    with pytest.raises(ValueError, match="must divide over the dp axis"):
        TT.train_sde(models[1], init, TT.TrajectoryDataset(t, x, u, 4),
                     TT.TrainConfig(batch_size=3, steps=1),
                     mesh=_two_row_mesh(), device="cpu")


def _two_row_mesh():
    """A (2, 1) mesh seen from rank 0 without a process group (nothing is
    gathered before the batch split raises)."""
    from sde4mbrl_px4_tpu_torch.parallel.mesh import Mesh

    grid = np.empty(2, dtype=object)
    grid[:] = ["cpu", "cpu"]
    return Mesh(grid.reshape(2, 1), ("dp", "mc"), 0)


def test_eval_model_drive_reports_on_a_recorded_flight(tmp_path, models, flight):
    """``sim/eval_model.py`` (``tools/eval_model.py``'s port) on a log the
    port recorded: its JSON report, k-step errors equal to
    ``kstep_errors`` on the same segment; too short a log exits."""
    from sde4mbrl_px4_tpu_torch.io.flight_log import FlightRecorder
    from sde4mbrl_px4_tpu_torch.models.params_io import save_params
    from sde4mbrl_px4_tpu_torch.sim import eval_model

    t, x, u, true, _ = flight
    rec = FlightRecorder()
    for k in range(60):
        rec.record(t[k], x[k], cmd_motors=np.concatenate([u[k], np.zeros(2, np.float32)]))
    log, ckpt = str(tmp_path / "f.npz"), str(tmp_path / "true.pkl")
    rec.save(log)
    save_params(ckpt, true, {"vehicle": "iris"})
    rep = eval_model.main([log, "--checkpoint", ckpt, "--ks", "1,5", "--calib-k", "5",
                           "--particles", "8", "--cpu"])
    assert rep["samples"] == 60 and set(rep["kstep"]) == {"k1", "k5"}
    assert rep["kstep"] == TE.kstep_errors(models[1], true, t[:60], x[:60], u[:60], ks=(1, 5),
                                           device="cpu")
    assert 0.0 <= rep["calibration"]["coverage"]["0.50"] <= 1.0
    with pytest.raises(SystemExit, match="need >= 62"):
        eval_model.main([log, "--checkpoint", ckpt, "--ks", "60", "--cpu"])
