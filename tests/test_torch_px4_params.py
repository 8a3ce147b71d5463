"""Port, PX4 parameter files (``io/px4_params.py``) and their push through
the mission layer, on the CPU.

- a twin of ``tests/test_px4_params.py``: the shipped assets parse, a dump
  round-trips, 64-bit ints and numpy types keep their firmware type,
  conflicting duplicates and malformed lines are refused, the minimal push
  set, and ``push_params`` through ``dispatch`` onto the FCU's parameter
  store (the port's ``SimVehicle`` over the port's ``FCUSim``);
- parity: both shipped assets (``configs/params_hexa.params``,
  ``params_hexa_full.params``) parse to the same dicts as in the JAX package
  (values and Python types), ``dump_params_file`` writes byte-equal files,
  and ``diff_params`` gives the same push sets.
"""
import os

import numpy as np
import pytest

from sde4mbrl_px4_tpu.io import px4_params as JP
from sde4mbrl_px4_tpu_torch.io.px4_params import (
    diff_params,
    dump_params_file,
    parse_params_file,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = ("params_hexa.params", "params_hexa_full.params")


@pytest.fixture
def fcu(repo_root):
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant

    params, _ = load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    return FCUSim(SDEPlant(NeuralSDE.for_vehicle(iris_config()), params, sim_dt=0.005))


def test_parse_shipped_asset():
    params = parse_params_file(os.path.join(REPO, "configs", "params_hexa.params"))
    assert params["COM_RCL_EXCEPT"] == 4
    assert isinstance(params["COM_RCL_EXCEPT"], int)
    assert params["MPC_TILTMAX_AIR"] == pytest.approx(30.0)
    assert isinstance(params["MPC_TILTMAX_AIR"], float)
    assert len(params) == 9


def test_roundtrip(tmp_path):
    src = {"A_INT": 4, "B_FLOAT": 0.5, "C_NEG": -1, "D_BIG": 921600}
    p = str(tmp_path / "dump.params")
    dump_params_file(p, src, header="roundtrip test")
    back = parse_params_file(p)
    assert back == src
    for k in ("A_INT", "C_NEG", "D_BIG"):
        assert isinstance(back[k], int)
    assert isinstance(back["B_FLOAT"], float)


def test_int_fidelity_and_numpy_types(tmp_path):
    p = tmp_path / "big.params"
    p.write_text("1\t1\tBIG64\t9007199254740993\t8\n1\t1\tEXP\t4.000000\t6\n")
    d = parse_params_file(str(p))
    assert d["BIG64"] == 9007199254740993
    assert d["EXP"] == 4 and isinstance(d["EXP"], int)
    p.write_text("1\t1\tX\t4.7\t6\n")
    with pytest.raises(ValueError, match="fractional"):
        parse_params_file(str(p))
    out = str(tmp_path / "np.params")
    dump_params_file(out, {"RATE": np.int32(921600), "GAIN": np.float32(0.5)})
    back = parse_params_file(out)
    assert back["RATE"] == 921600 and isinstance(back["RATE"], int)
    assert isinstance(back["GAIN"], float)


def test_duplicate_conflict_raises(tmp_path):
    p = tmp_path / "dup.params"
    p.write_text("1\t1\tBAT1_N_CELLS\t4\t6\n1\t2\tBAT1_N_CELLS\t6\t6\n")
    with pytest.raises(ValueError, match="duplicate"):
        parse_params_file(str(p))
    p.write_text("1\t1\tBAT1_N_CELLS\t4\t6\n1\t1\tBAT1_N_CELLS\t4\t6\n")
    assert parse_params_file(str(p)) == {"BAT1_N_CELLS": 4}


def test_parse_rejects_malformed(tmp_path):
    p = tmp_path / "bad.params"
    p.write_text("1\t1\tNAME_ONLY\n")
    with pytest.raises(ValueError, match="expected 5 fields"):
        parse_params_file(str(p))
    p.write_text("1\t1\tX\tnotanumber\t9\n")
    with pytest.raises(ValueError):
        parse_params_file(str(p))


def test_diff_params():
    d = diff_params({"A": 1, "B": 2.0, "C": 3}, {"A": 1, "B": 2.5, "D": 4})
    assert set(d) == {"B", "D"}
    assert d["B"] == (2.0, 2.5)
    assert d["D"] == (None, 4)
    assert diff_params({"X": 1.0}, {"X": 1.0 + 1e-9}) == {}


def test_full_vehicle_dump_asset(tmp_path):
    """The committed full dump: several hundred params, consistent with the
    preflight subset, diffable, and parsed back after a re-dump (its
    generator's byte-for-byte output: the test below)."""
    full_path = os.path.join(REPO, "configs", "params_hexa_full.params")
    full = parse_params_file(full_path)
    assert len(full) >= 400, len(full)
    assert full["SYS_AUTOSTART"] == 6001
    assert full["COM_RCL_EXCEPT"] == 4
    assert full["SER_TEL2_BAUD"] == 921600
    assert full["BAT1_N_CELLS"] == 6
    assert isinstance(full["MPC_XY_VEL_MAX"], float)
    subset = parse_params_file(os.path.join(REPO, "configs", "params_hexa.params"))
    overlap = {k: full[k] for k in subset if k in full}
    assert len(overlap) >= 5
    assert diff_params(overlap, {k: subset[k] for k in overlap}) == {}
    stock = dict(full)
    stock["COM_RCL_EXCEPT"] = 0
    stock["MAV_1_MODE"] = 0
    del stock["SER_TEL2_BAUD"]
    assert set(diff_params(stock, full)) == {"COM_RCL_EXCEPT", "MAV_1_MODE", "SER_TEL2_BAUD"}
    out = str(tmp_path / "again.params")
    dump_params_file(out, full)
    assert parse_params_file(out) == full


def test_generator_reproduces_the_committed_dump(tmp_path, monkeypatch):
    """``sim/gen_px4_params.py`` (the port of ``tools/gen_px4_params.py``)
    writes ``configs/params_hexa_full.params`` byte for byte, to the path it
    is given (here ``tmp_path``), as ``tests/test_px4_params.py:90-95``
    holds the original; without a path it writes under ``build/``."""
    from sde4mbrl_px4_tpu_torch.sim import gen_px4_params

    out = gen_px4_params.main(str(tmp_path / "hexa_full.params"))
    with open(out, "rb") as f, open(os.path.join(REPO, "configs",
                                                 "params_hexa_full.params"), "rb") as g:
        assert f.read() == g.read()
    assert gen_px4_params.build_params() == parse_params_file(out)
    monkeypatch.setattr(gen_px4_params, "_ROOT", str(tmp_path))
    assert gen_px4_params.main() == str(tmp_path / "build" / "params_hexa_full.params")


def test_mission_push_full_dump(fcu):
    from sde4mbrl_px4_tpu_torch.cli.mission import MissionControl, SimVehicle, dispatch

    ctl = MissionControl(SimVehicle(fcu), engine=None, log=lambda *a: None)
    full_path = os.path.join(REPO, "configs", "params_hexa_full.params")
    assert dispatch(ctl, f"push_params {full_path}")
    assert len(fcu.params) >= len(parse_params_file(full_path))
    assert fcu.params["SYS_AUTOSTART"] == 6001
    assert fcu.params["EKF2_HGT_MODE"] == 3
    assert fcu.params["MPC_THR_HOVER"] == pytest.approx(0.42)


def test_mission_push_params(fcu, tmp_path):
    from sde4mbrl_px4_tpu_torch.cli.mission import MissionControl, SimVehicle, dispatch

    logs = []
    ctl = MissionControl(SimVehicle(fcu), engine=None, log=logs.append)
    pfile = str(tmp_path / "mission.params")
    dump_params_file(pfile, {"MPC_TILTMAX_AIR": 25.0, "NAV_RCL_ACT": 0})
    assert dispatch(ctl, f"push_params {pfile}")
    assert fcu.params["MPC_TILTMAX_AIR"] == pytest.approx(25.0)
    assert fcu.params["NAV_RCL_ACT"] == 0
    assert fcu.params["COM_RCL_EXCEPT"] == 4     # the preflight push from __init__
    assert any("Pushed 2/2" in str(m) for m in logs)


# ------------------------------------------------------ parity with the JAX package

@pytest.mark.parametrize("name", ASSETS)
def test_shipped_assets_parse_and_dump_equal_to_jax(tmp_path, name):
    path = os.path.join(REPO, "configs", name)
    a, b = parse_params_file(path), JP.parse_params_file(path)
    assert a == b
    assert [type(v) for v in a.values()] == [type(v) for v in b.values()]
    outs = []
    for tag, dump in (("torch", dump_params_file), ("jax", JP.dump_params_file)):
        out = str(tmp_path / f"{tag}.params")
        dump(out, a, header=f"regenerated from {name}\nsecond line")
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


def test_diff_params_equal_to_jax():
    full = parse_params_file(os.path.join(REPO, "configs", "params_hexa_full.params"))
    rs = np.random.RandomState(0)
    names = sorted(full)
    cur = dict(full)
    for k in rs.choice(names, 40, replace=False):
        v = cur[k]
        cur[k] = v + 1 if isinstance(v, int) else v * (1 + 1e-9 * rs.randn()) + rs.randn() * 0.1
    for k in rs.choice(names, 10, replace=False):
        cur.pop(k)
    assert diff_params(cur, full) == JP.diff_params(cur, full)
    assert len(diff_params(cur, full)) >= 10
