"""Port parity, the geometric baseline and the trajectory generators:
``sde4mbrl_px4_tpu_torch/baselines/geometric.py`` and ``models/trajgen.py``
against the JAX package's, on the CPU.

- ``geometric_control``: the behaviour checks of ``tests/test_geometric.py:24-78``
  as twins, each also held to the JAX function at rtol 1e-5; random states
  in both attitude laws, one by one and as a batch;
- the native controller (``csrc/libmpc_native.so``) against the torch
  version at the JAX suite's tolerances (``tests/test_geometric.py:90-110``:
  rtol 1e-4 / atol 1e-5, the C++ computes in double), its trajectory
  follower and its parameter file; skipped, with the JAX suite's reason,
  where the library is not built;
- ``GeoParams.from_yaml`` on the shipped launch file, as the JAX package's;
- the ``trajgen`` CSVs byte-equal to the JAX package's and read alike by the
  port's sampler and the native follower (``tests/test_aux.py:99-123``).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.baselines import geometric as J
from sde4mbrl_px4_tpu.models import trajgen as JG
from sde4mbrl_px4_tpu_torch.baselines.geometric import (
    ERROR_GEOMETRIC, ERROR_QUATERNION, GeoParams, NativeGeometricController,
    geometric_control)
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.models import trajgen as TG
from sde4mbrl_px4_tpu_torch.models.trajectory import load_trajectory_csv, make_state_from_traj

RTOL = 1e-5               # the port against the JAX function (both float32)
NATIVE_RTOL, NATIVE_ATOL = 1e-4, 1e-5    # tests/test_geometric.py:107


def _both(p, x, tp, tv, ta, yaw):
    """(port cmd, port q_des, JAX cmd, JAX q_des) as numpy."""
    cmd, qd = geometric_control(p, torch.as_tensor(np.asarray(x, np.float32)),
                                torch.as_tensor(np.asarray(tp, np.float32)),
                                torch.as_tensor(np.asarray(tv, np.float32)),
                                torch.as_tensor(np.asarray(ta, np.float32)),
                                torch.tensor(np.float32(yaw)))
    jp = J.GeoParams(*p)
    cj, qj = J.geometric_control(jp, jnp.asarray(x, jnp.float32), jnp.asarray(tp, jnp.float32),
                                 jnp.asarray(tv, jnp.float32), jnp.asarray(ta, jnp.float32),
                                 jnp.float32(yaw))
    return cmd.numpy(), qd.numpy(), np.asarray(cj), np.asarray(qj)


def _assert_jax(c, q, cj, qj):
    np.testing.assert_allclose(c, cj, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(q, qj, rtol=RTOL, atol=1e-6)


def test_hover_equilibrium_thrust():
    """At the target with zero acceleration: thrust c*g + offset, no rates."""
    p = GeoParams()
    c, q, cj, qj = _both(p, hover_state(), np.zeros(3), np.zeros(3), np.zeros(3), 0.0)
    assert c[3] == pytest.approx(p.norm_thrust_const * p.gravity + p.norm_thrust_offset,
                                 abs=1e-5)
    np.testing.assert_allclose(c[:3], 0.0, atol=1e-5)
    np.testing.assert_allclose(q, [1, 0, 0, 0], atol=1e-5)
    _assert_jax(c, q, cj, qj)


def test_position_error_tilts_toward_target():
    """A target ahead in +x (ENU): a pitch-rate command, positive thrust."""
    c, q, cj, qj = _both(GeoParams(), hover_state(), [2.0, 0.0, 0.0], np.zeros(3),
                         np.zeros(3), 0.0)
    assert abs(c[1]) > 0.1 and c[3] > 0.0
    _assert_jax(c, q, cj, qj)


def test_fb_acc_clipping():
    """A huge position error: the feedback acceleration is norm-clipped."""
    p = GeoParams(max_fb_acc=2.0)
    far = _both(p, hover_state(), [100.0, 0, 0], np.zeros(3), np.zeros(3), 0.0)
    vfar = _both(p, hover_state(), [1000.0, 0, 0], np.zeros(3), np.zeros(3), 0.0)
    np.testing.assert_allclose(far[0], vfar[0], atol=1e-5)
    _assert_jax(*far)


def test_thrust_clamped_to_unit_interval():
    c, q, cj, qj = _both(GeoParams(norm_thrust_const=10.0), hover_state(), np.zeros(3),
                         np.zeros(3), [0.0, 0, 50.0], 0.0)
    assert 0.0 <= c[3] <= 1.0
    _assert_jax(c, q, cj, qj)


def test_feedthrough_mode():
    """The position error is ignored: a level attitude from pure vertical
    acceleration."""
    c, q, cj, qj = _both(GeoParams(feedthrough=True), hover_state(), [5.0, 5.0, 5.0],
                         np.zeros(3), [0.0, 0.0, 9.8], 0.0)
    np.testing.assert_allclose(q, [1, 0, 0, 0], atol=1e-5)
    _assert_jax(c, q, cj, qj)


def _random_cases(n=10, seed=42):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        x = rs.randn(13)
        x[6:10] /= np.linalg.norm(x[6:10])
        yield x, rs.randn(3), 0.5 * rs.randn(3), 0.3 * rs.randn(3), rs.uniform(-3, 3)


@pytest.mark.parametrize("mode", [ERROR_QUATERNION, ERROR_GEOMETRIC])
def test_random_states_match_jax_one_by_one_and_batched(mode):
    """Both attitude laws with rotor drag, against the JAX function at
    rtol 1e-5; the same states as one (10, ...) batch give each row's
    result to float32 rounding (rtol 1e-6 / atol 1e-6: the SE(3) law's
    batched 3x3 products sum in another order and cancel to ~0.05)."""
    p = GeoParams(ctrl_mode=mode, drag_d=(0.1, 0.1, 0.05))
    cases = list(_random_cases())
    rows = [_both(p, *case) for case in cases]
    for c, q, cj, qj in rows:
        _assert_jax(c, q, cj, qj)
    stack = [torch.as_tensor(np.stack([case[i] for case in cases]).astype(np.float32))
             for i in range(5)]
    cb, qb = geometric_control(p, *stack)
    np.testing.assert_allclose(cb.numpy(), np.stack([r[0] for r in rows]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(qb.numpy(), np.stack([r[1] for r in rows]), rtol=1e-6,
                               atol=1e-6)


def test_geo_params_from_yaml_equal_jax(repo_root):
    path = os.path.join(repo_root, "configs/launch/iris_geoctrl.yaml")
    p = GeoParams.from_yaml(path)
    assert tuple(p) == tuple(J.GeoParams.from_yaml(path))
    assert p.kp == (2.0, 2.0, 4.0) and p.max_fb_acc == 7.0


# ------------------------------------------------------------- native

@pytest.fixture(scope="module")
def native_ctrl(repo_root):
    if not os.path.exists(os.path.join(repo_root, "csrc", "libmpc_native.so")):
        pytest.skip("native library not built (make -C csrc)")
    return NativeGeometricController()


@pytest.mark.parametrize("mode", [ERROR_QUATERNION, ERROR_GEOMETRIC])
def test_native_matches_torch(native_ctrl, mode):
    """``tests/test_geometric.py::test_cpp_jax_parity`` with the port's
    function: the C++ in double, the port in float32."""
    p = GeoParams(ctrl_mode=mode, drag_d=(0.1, 0.1, 0.05))
    native_ctrl.set_params(p)
    for x, tp, tv, ta, yaw in _random_cases():
        cmd_c, qd_c = native_ctrl.update(x, tp, tv, ta, yaw)
        cmd_t, qd_t, _, _ = _both(p, x, tp, tv, ta, yaw)
        np.testing.assert_allclose(cmd_c, cmd_t, rtol=NATIVE_RTOL, atol=NATIVE_ATOL)
        assert abs(float(np.dot(qd_c, qd_t))) > 1 - 1e-6     # q and -q are equal
    native_ctrl.set_params(GeoParams())


def test_native_trajectory_follower(native_ctrl, tmp_path):
    """``tests/test_geometric.py::test_cpp_trajectory_follower`` on a port
    ``trajgen`` circle: interpolation, clamping past the end, backward
    seeks."""
    rows = TG.circle_trajectory(radius=2.0, period=4.0, z=1.0, dt=0.05)
    csv = str(tmp_path / "circ.csv")
    TG.write_trajectory_csv(csv, rows)
    assert native_ctrl.load_trajectory(csv)
    pos, _, _, _ = native_ctrl.sample_trajectory(0.125)
    t = rows[:, 0]
    i = np.searchsorted(t, 0.125) - 1
    alpha = (0.125 - t[i]) / (t[i + 1] - t[i])
    np.testing.assert_allclose(pos, rows[i, 1:4] + alpha * (rows[i + 1, 1:4] - rows[i, 1:4]),
                               atol=1e-9)
    np.testing.assert_allclose(native_ctrl.sample_trajectory(1e9)[0], rows[-1, 1:4], atol=1e-9)
    pos0 = native_ctrl.sample_trajectory(0.01)[0]
    np.testing.assert_allclose(
        pos0, rows[0, 1:4] + (0.01 / (t[1] - t[0])) * (rows[1, 1:4] - rows[0, 1:4]), atol=1e-9)


def test_native_param_file_loading(native_ctrl, tmp_path):
    cfgf = tmp_path / "geo.yaml"
    cfgf.write_text("attctrl_tau: 0.25\nKp_x: 4.0\nctrl_mode: 2\n# comment\n")
    assert native_ctrl.load_params_file(str(cfgf))
    assert native_ctrl._p.attctrl_tau == pytest.approx(0.25)
    assert native_ctrl._p.Kp[0] == pytest.approx(4.0) and native_ctrl._p.ctrl_mode == 2
    native_ctrl.set_params(GeoParams())


# ------------------------------------------------------------- trajgen

@pytest.mark.parametrize("kind, kw", [("circle", {}), ("circle", {"ramp": 1.5}),
                                      ("lemniscate", {"dt": 0.05}),
                                      ("lemniscate", {"ramp": 2.0})])
def test_trajgen_csv_equal_jax(tmp_path, kind, kw):
    """The port's generators write the JAX package's files byte for byte."""
    fn, jfn = getattr(TG, f"{kind}_trajectory"), getattr(JG, f"{kind}_trajectory")
    rows = fn(**kw)
    np.testing.assert_array_equal(rows, jfn(**kw))
    a, b = tmp_path / "port.csv", tmp_path / "jax.csv"
    TG.write_trajectory_csv(str(a), rows)
    JG.write_trajectory_csv(str(b), jfn(**kw))
    assert a.read_bytes() == b.read_bytes()


def test_trajgen_csv_feeds_native_follower(native_ctrl, tmp_path):
    """``tests/test_aux.py::test_trajgen_csv_feeds_native_follower``: the
    port's sampler and the C++ follower read a generated CSV alike."""
    p = str(tmp_path / "lemn.csv")
    TG.write_trajectory_csv(p, TG.lemniscate_trajectory(dt=0.05))
    sft = make_state_from_traj(load_trajectory_csv(p, convert_to_ned=False))
    assert native_ctrl.load_trajectory(p)
    for t in (0.0, 0.33, 1.7, 5.0):
        pos_c, vel_c, _, _ = native_ctrl.sample_trajectory(t)
        x_t = sft(t).numpy()
        np.testing.assert_allclose(pos_c, x_t[:3], atol=1e-5)
        np.testing.assert_allclose(vel_c, x_t[3:6], atol=1e-5)
