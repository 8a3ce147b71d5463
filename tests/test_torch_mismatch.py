"""Port parity, the model-mismatch sweep: ``sde4mbrl_px4_tpu_torch/sim/
mismatch_sweep.py`` against ``examples/mismatch_sweep.py`` on the CPU.

- the 11 cells are the example's;
- the nominal cell at 1 s (a 20-iteration budget, so the plain solves stay
  short): the MPC's mean and max error against the example's ``fly_mpc``
  at rtol 1e-3 (20 chained solves through the rigid-body plant: the first
  in lockstep at the fixed-budget tolerance, the later ones fp-chaotic),
  and the geometric baseline's against the example's ``fly_geometric`` at
  rtol 1e-5 (the same C++ controller; the frame conversion in float32 by
  each package);
- the drive: its JSON goes to ``--out`` and never to the JAX package's
  ``artifacts/MISMATCH*.json``, and without the native library it flies
  the MPC only and says so.
"""
import copy
import hashlib
import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config
from sde4mbrl_px4_tpu.sim import rigid_body as JRB
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.sim import mismatch_sweep as S
from sde4mbrl_px4_tpu_torch.sim import rigid_body as RB

SECONDS, ITERS = 1.0, 20
MPC_RTOL = 1e-3          # 20 chained solves (the later ones fp-chaotic)
GEO_RTOL = 1e-5          # the same C++ controller, float32 frame conversion


@pytest.fixture(scope="module")
def example(repo_root):
    spec = importlib.util.spec_from_file_location(
        "jax_mismatch_sweep", os.path.join(repo_root, "examples", "mismatch_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cfg(repo_root):
    c = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    c["apg_mpc"]["max_iter"] = ITERS
    return c


def test_cells_are_the_examples(example):
    assert S.CELLS == example.CELLS
    assert len(S.CELLS) == 11


def test_nominal_mpc_cell_matches_the_example(example, cfg):
    """The nominal cell's MPC, both packages on their own rigid-body plant
    (the port's is a copy) at 1 s."""
    jc, (j_reset, j_mpc), _, _ = j_make(copy.deepcopy(cfg))
    ref = example.fly_mpc((jc, j_reset, jax.jit(j_mpc)),
                          JRB.RigidBodyPlant(JRB.RigidBodyParams.nominal("iris")), SECONDS)
    tc, (t_reset, t_mpc), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    got = S.fly_mpc((tc, t_reset, t_mpc),
                    RB.RigidBodyPlant(RB.RigidBodyParams.nominal("iris")), SECONDS)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=MPC_RTOL)


def test_geometric_cells_match_the_example(example, repo_root):
    """The geometric baseline in the nominal and the wind cell, 1 s."""
    if not os.path.exists(os.path.join(repo_root, "csrc", "libmpc_native.so")):
        pytest.skip("native library not built (make -C csrc)")
    from sde4mbrl_px4_tpu.baselines.geometric import GeoParams as JGeo
    from sde4mbrl_px4_tpu.baselines.geometric import NativeGeometricController as JNative
    from sde4mbrl_px4_tpu_torch.baselines.geometric import (
        GeoParams, NativeGeometricController)

    kw = dict(norm_thrust_const=0.71 / 9.81, norm_thrust_offset=0.0, kp=(2.0, 2.0, 4.0),
              kv=(2.0, 2.0, 3.0))
    for name, pert in (S.CELLS[0], S.CELLS[9]):
        pj = JRB.RigidBodyParams.nominal("iris")
        pt = RB.RigidBodyParams.nominal("iris")
        if pert:
            pj, pt = pj.perturbed(**pert), pt.perturbed(**pert)
        ref = example.fly_geometric(JNative(JGeo(**kw)), JRB.RigidBodyPlant(pj), SECONDS)
        got = S.fly_geometric(NativeGeometricController(GeoParams(**kw)),
                              RB.RigidBodyPlant(pt), SECONDS)
        np.testing.assert_allclose(got, ref, rtol=GEO_RTOL, err_msg=name)


def _digests(repo_root):
    out = {}
    for name in ("MISMATCH.json", "MISMATCH_hexa.json"):
        with open(os.path.join(repo_root, "artifacts", name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_drive_writes_its_out_path_only(repo_root, tmp_path, monkeypatch, capsys):
    """One short cell through ``run``: the record at ``--out``, the JAX
    package's artifacts untouched; without the native library the sweep
    flies the MPC only and prints so."""
    before = _digests(repo_root)
    out = tmp_path / "sweep.json"
    rec = S.run(["--cpu", "--seconds", "0.2", "--iters", "2", "--cells", "nominal",
                 "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert [r["cell"] for r in rec["cells"]] == ["nominal"]
    assert rec["geometric"] == os.path.exists(os.path.join(repo_root, "csrc",
                                                           "libmpc_native.so"))
    from sde4mbrl_px4_tpu_torch.io import mavlink

    monkeypatch.setattr(mavlink, "_NATIVE", None)
    monkeypatch.setattr(mavlink, "load_native", lambda: None)
    monkeypatch.setattr("sde4mbrl_px4_tpu_torch.baselines.geometric.load_native", lambda: None)
    rec = S.run(["--cpu", "--seconds", "0.2", "--iters", "2", "--cells", "nominal",
                 "--out", str(out)])
    assert not rec["geometric"] and "geo_mean_m" not in rec["cells"][0]
    assert "MPC-only sweep" in capsys.readouterr().out
    assert _digests(repo_root) == before
