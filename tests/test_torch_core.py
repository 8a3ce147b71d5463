"""Port parity, core layer: quaternion math, frames and types of
``sde4mbrl_px4_tpu_torch.core`` against ``sde4mbrl_px4_tpu.core`` on the
same random batches (numpy, seeded). Tolerance rtol 1e-6 with an absolute
floor of 1e-6 for entries that cancel to ~0 (fp32 reassociation)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.core import frames as jframes
from sde4mbrl_px4_tpu.core import quaternion as jq
from sde4mbrl_px4_tpu.core import types as jtypes
from sde4mbrl_px4_tpu_torch.core import frames as tframes
from sde4mbrl_px4_tpu_torch.core import quaternion as tq
from sde4mbrl_px4_tpu_torch.core import types as ttypes

RTOL, ATOL = 1e-6, 1e-6


def _quats(rs, n):
    q = rs.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _close(t_out, j_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    return {"q": _quats(rs, 64), "p": _quats(rs, 64),
            "v": rs.randn(64, 3).astype(np.float32),
            "w": rs.randn(64, 3).astype(np.float32),
            "yaw": rs.uniform(-np.pi, np.pi, 64).astype(np.float32),
            "acc": (rs.randn(64, 3) + [0.0, 0.0, 9.81]).astype(np.float32)}


@pytest.mark.parametrize("name", ["qmul", "qrotate", "qrotate_inv", "qerr_vec"])
def test_binary_quaternion_ops(batch, name):
    a = batch["q"]
    b = batch["p"] if name in ("qmul", "qerr_vec") else batch["v"]
    out_t = getattr(tq, name)(torch.from_numpy(a), torch.from_numpy(b))
    out_j = getattr(jq, name)(jnp.asarray(a), jnp.asarray(b))
    _close(out_t, out_j)


@pytest.mark.parametrize("name", ["qconj", "qnormalize"])
def test_unary_quaternion_ops(batch, name):
    q = 1.7 * batch["q"]
    _close(getattr(tq, name)(torch.from_numpy(q)), getattr(jq, name)(jnp.asarray(q)))


def test_qmul_omega_is_half_q_times_pure_omega(batch):
    q, w = batch["q"], batch["w"]
    ref = 0.5 * jq.qmul(jnp.asarray(q), jnp.concatenate(
        [jnp.zeros((64, 1)), jnp.asarray(w)], axis=1))
    _close(tq.qmul_omega(torch.from_numpy(q), torch.from_numpy(w)), ref)


def test_cross_matches_numpy(batch):
    a, b = batch["v"], batch["w"]
    _close(tq.cross(torch.from_numpy(a), torch.from_numpy(b)), np.cross(a, b))


def test_rotmat_and_flatness_attitude(batch):
    q_t = tq.acc_yaw_to_q(torch.from_numpy(batch["acc"]), torch.from_numpy(batch["yaw"]))
    q_j = jq.acc_yaw_to_q(jnp.asarray(batch["acc"]), jnp.asarray(batch["yaw"]))
    _close(q_t, q_j)
    R = np.array(jq.q_to_rotmat(jnp.asarray(batch["q"])))
    _close(tq.rotmat_to_q(torch.from_numpy(R)), jq.rotmat_to_q(jnp.asarray(R)))


@pytest.mark.parametrize("direction", ["enu2ned", "ned2enu"])
def test_frames(batch, direction):
    rs = np.random.RandomState(1)
    x = rs.randn(64, 13).astype(np.float32)
    x[:, 6:10] = batch["q"]
    out_t = getattr(tframes, direction)(torch.from_numpy(x))
    _close(out_t, getattr(jframes, direction)(jnp.asarray(x)))
    # involution
    back = tframes.ned2enu(out_t)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-6, atol=1e-6)


def test_types_match():
    np.testing.assert_array_equal(ttypes.hover_state().numpy(),
                                  np.asarray(jtypes.hover_state()))
    assert ttypes.CONTROL_STATES == jtypes.CONTROL_STATES
    for k in ("CTRL_INACTIVE", "CTRL_TRAJ_ACTIVE", "CTRL_TRAJ_IDLE",
              "CTRL_POSE_ACTIVE", "CTRL_TEST"):
        assert getattr(ttypes, k) == getattr(jtypes, k)
