"""Port parity, the ``hover_diag`` preconditioner probe
(``engine/mpc_loader.py::hover_diag_probe`` / ``_load_precond``) against
the JAX package's (``engine/mpc_loader.py:533-580``), on the CPU.

- on a cache miss both packages probe, at rtol 1e-4: a horizon-6 traj
  config and the shipped proximal posctrl config (nZ = 10) with the
  metric switched on; both write ``<key>.npy`` under the same key;
- on ``configs/iris_traj_mpc.yaml`` against its committed
  ``configs/models/precond/*.npy``: the JAX package's own CPU probe
  reproduces the file bit for bit (measured here, each run); the port's
  probe sums in another float32 order and is held at rtol 1e-6 (it reads
  ~3e-7);
- a retrained checkpoint in ``tmp_path`` misses the cache, is probed,
  writes its file there, loads it on the next build, and solves;
- the labeling expert (``learning/distill.py::_expert_cfg``) hits the
  committed file of the traj config: it changes only ``apg_mpc``;
- a trunk outside the P=1 register chain's widths flies on the CPU's plain
  version (``tests/test_torch_wide_trunk.py`` holds it on every width
  against the JAX package, and the card's forms against the plain ones).

No test writes under ``configs/models/precond/``: the caches live in
``tmp_path`` (``SDE4MBRL_PRECOND_CACHE``, ``HOME`` and checkpoint copies).
"""
import glob
import os
import shutil

import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load
from sde4mbrl_px4_tpu_torch.engine import mpc_loader as L
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.models.params_io import load_params, save_params

PROBE_RTOL = 1e-4
COMMITTED_RTOL = 1e-6


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Empty caches: the env dir first, ``HOME`` moved into ``tmp_path``."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    env = tmp_path / "env"
    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(env))
    return env


def _copy_checkpoint(cfg, tmp_path):
    """The checkpoint copied into ``tmp_path`` (the same bytes, so the same
    key): nothing next to it holds a cached metric."""
    dst = tmp_path / "ckpt" / os.path.basename(cfg["learned_model_params"])
    dst.parent.mkdir(exist_ok=True)
    shutil.copy(cfg["learned_model_params"], dst)
    cfg["learned_model_params"] = str(dst)
    return cfg


def _configs(repo_root, case):
    if case == "traj_h6":
        name, mut = "iris_traj_mpc", dict(horizon=6, num_short_dt=6)
    else:
        name, mut = "iris_constr_posctrl_mpc", {}
    j, t = (load(os.path.join(repo_root, f"configs/{name}.yaml"))
            for load in (j_load, load_yaml_config))
    for c in (j, t):
        c.update(mut)
        c["apg_mpc"]["precond"] = "hover_diag"
    return j, t


def _probe_both(j_cfg, t_cfg, cache, monkeypatch):
    """Each package's metric on a miss; returns (jax, port, the files)."""
    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(cache / "jax"))
    _, _, _, jb = j_make(j_cfg)
    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(cache / "port"))
    _, tb, _ = L.build_mpc(t_cfg, device="cpu")
    files = [sorted(glob.glob(str(cache / who / "*.npy"))) for who in ("jax", "port")]
    # the JAX bundle does not carry the metric: read the file its probe wrote
    return np.load(files[0][0]), tb.precond.numpy(), files


@pytest.mark.parametrize("case", ["traj_h6", "prox_posctrl"])
def test_probe_matches_jax(repo_root, cache, monkeypatch, case):
    j_cfg, t_cfg = _configs(repo_root, case)
    dj, dt, (fj, ft) = _probe_both(j_cfg, t_cfg, cache, monkeypatch)
    nZ = 10 if case == "prox_posctrl" else 4
    H = 6 if case == "traj_h6" else 20
    assert dt.shape == dj.shape == (H, nZ) and dt.dtype == np.float32
    np.testing.assert_allclose(dt, dj, rtol=PROBE_RTOL)
    assert dt.max() == 1.0 and dt.min() > 0
    # the same content key, so each package hits the other's file
    assert [os.path.basename(f) for f in fj] == [os.path.basename(f) for f in ft] != []
    np.testing.assert_array_equal(np.load(ft[0]), dt)


def test_probe_matches_the_committed_file(repo_root, cache, monkeypatch, tmp_path):
    """The flagship traj config: the committed file against the JAX
    package's CPU probe (measured: bit for bit) and the port's probe."""
    t_cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    _, tb, _ = L.build_mpc(dict(t_cfg), device="cpu")        # hits the committed file
    committed = tb.precond.numpy()
    key = L._precond_cache_key(t_cfg, "iris", tb.time_steps.numpy(), tb.lb.numpy(),
                               tb.ub.numpy(), 4, True)
    np.testing.assert_array_equal(
        committed, np.load(os.path.join(repo_root, f"configs/models/precond/{key}.npy")))
    j_cfg = _copy_checkpoint(j_load(os.path.join(repo_root, "configs/iris_traj_mpc.yaml")),
                             tmp_path)
    j_make(j_cfg)                                # misses: probes on the CPU, writes the env dir
    jax_probe = np.load(str(cache / f"{key}.npy"))
    jax_err = float(np.max(np.abs(jax_probe / committed - 1.0)))
    assert jax_err <= COMMITTED_RTOL, jax_err
    x_ref = L.enu2ned(tb.state_from_traj(tb.knot_times))
    z = tb.cost_params.uref.expand(20, 4).contiguous()
    port = L.hover_diag_probe(tb.model, tb.params, tb.cost_params, tb.time_steps, x_ref, z)
    np.testing.assert_allclose(port, committed, rtol=COMMITTED_RTOL)
    np.testing.assert_allclose(port, jax_probe, rtol=COMMITTED_RTOL)


def _traj_h6(repo_root, ckpt=None):
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg.update(horizon=6, num_short_dt=6)
    cfg["apg_mpc"].update(max_iter=8, max_no_improvement_iter=8)
    if ckpt:
        cfg["learned_model_params"] = ckpt
    return cfg


def test_retrained_checkpoint_is_probed_and_solves(repo_root, tmp_path, monkeypatch):
    """A retrained checkpoint changes the key: its first build probes and
    writes ``<dir>/precond/<key>.npy`` beside it (no env dir set), the
    second loads that file, and the solve runs on the metric."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("SDE4MBRL_PRECOND_CACHE", raising=False)
    tree, meta = load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    tree["motor"]["log_gain"] = np.asarray(tree["motor"]["log_gain"]) + 0.03
    ckpt = str(tmp_path / "retrained" / "iris_sde_retrained.pkl")
    save_params(ckpt, tree, dict(meta, trained=True))
    calls = []
    probe = L.hover_diag_probe

    def counted(*a, **k):
        calls.append(1)
        return probe(*a, **k)

    monkeypatch.setattr(L, "hover_diag_probe", counted)
    _, b1, _ = L.build_mpc(_traj_h6(repo_root, ckpt), device="cpu")
    files = glob.glob(str(tmp_path / "retrained" / "precond" / "*.npy"))
    assert len(calls) == 1 and len(files) == 1
    _, (reset_fn, mpc_fn), sft, b2 = L.make_mpc_from_config(_traj_h6(repo_root, ckpt),
                                                            device="cpu")
    assert len(calls) == 1                                     # the second build hits the file
    np.testing.assert_array_equal(b1.precond.numpy(), b2.precond.numpy())
    # the shipped checkpoint's metric at this horizon differs
    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(tmp_path / "shipped"))
    shipped = L.build_mpc(_traj_h6(repo_root), device="cpu")[1].precond.numpy()
    assert len(calls) == 2 and not np.array_equal(b1.precond.numpy(), shipped)
    x = L.enu2ned(sft(0.0))
    sol = mpc_fn(x, None, reset_fn(x, None, x), 0.0, x)
    assert torch.isfinite(sol.u_opt).all() and int(sol.opt_state.num_steps) >= 1


def test_expert_config_hits_the_committed_file(repo_root, cache, monkeypatch):
    """``_expert_cfg`` changes only ``apg_mpc`` (and drops ``solver`` /
    ``policy``), none of which the key hashes: the traj expert loads the
    committed metric and never probes."""
    from sde4mbrl_px4_tpu_torch.learning.distill import DistillConfig, _expert_cfg

    def refuse(*a, **k):
        raise AssertionError("probed on a committed key")

    monkeypatch.setattr(L, "hover_diag_probe", refuse)
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg.update(solver="policy", policy={"params_path": os.path.join(
        repo_root, "configs/models/iris_traj_policy.pkl")})
    ecfg = _expert_cfg(cfg, DistillConfig(expert_max_iter=300))
    assert ecfg["apg_mpc"]["max_iter"] == 300 and "solver" not in ecfg
    _, b, _ = L.build_mpc(ecfg, device="cpu")
    assert b.precond is not None and b.apg_config.max_iter == 300
    assert not glob.glob(str(cache / "*.npy"))


def _narrow_checkpoint(repo_root, tmp_path, hidden=32):
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, init_params
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config

    p = init_params(torch.Generator().manual_seed(3), NeuralSDE.for_vehicle(iris_config()),
                    hidden=hidden)
    ckpt = str(tmp_path / f"iris_h{hidden}.pkl")
    save_params(ckpt, p, {"vehicle": "iris", "hidden": hidden})
    return ckpt, p


def test_narrow_trunk_flies_on_the_cpu(repo_root, tmp_path, cache):
    """The plain version takes any trunk width, as the JAX package does: a
    32-wide checkpoint builds (probing its metric) and solves on the CPU."""
    ckpt, _ = _narrow_checkpoint(repo_root, tmp_path)
    _, (reset_fn, mpc_fn), sft, b = L.make_mpc_from_config(_traj_h6(repo_root, ckpt),
                                                           device="cpu")
    assert b.params["net"]["w1"].shape == (32, 32) and b.precond.shape == (6, 4)
    x = L.enu2ned(sft(0.0))
    sol = mpc_fn(x, None, reset_fn(x, None, x), 0.0, x)
    assert torch.isfinite(sol.u_opt).all()

