"""Port parity, hexacopter (6 motors, F = 9 + 6 = 15 trunk inputs), on the
CPU at the shipped widths; mirrors ``tests/test_hexa.py``:

- the model's dimensions, hover balance and yaw authority;
- the cost oracle at n_u = 6 (on CPU tensors, its plain version) against
  the JAX package's ``pallas_cost_oracle`` in interpret mode: cost rtol
  2e-5, gradient rtol 5e-4 / atol 5e-5 (``tests/test_pallas_kernels.py:76,86``);
- the plain solve through ``mpc_fn`` in lockstep with JAX's XLA ``mpc_fn``
  at ``max_iter`` 10 for ``hexa_traj_mpc`` and ``hexa_posctrl_mpc``: equal
  ``num_steps``, u within rtol 2e-4 / atol 2e-5
  (``tests/test_apg_kernel.py:60-69``);
- the controller passing six motors through the pickup.

The flagship replays are ``test_torch_hexa_pos.py``,
``test_torch_hexa_traj.py`` and (slow) ``test_torch_hexa_engagement.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.pallas.solve_kernels import pallas_cost_oracle
from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES, hover_state
from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile, make_mpc_from_config
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

H, N_U = 20, 6


@pytest.fixture(scope="module")
def hexa(repo_root):
    return load_mpc_from_cfgfile(os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"),
                                 device="cpu")


def test_hexa_model_dimensions(hexa):
    cfg, fns, sft, b = hexa
    assert b.model.n_u == N_U
    assert b.model.mixing.shape == (4, N_U)
    assert b.cost_params.uref.shape == (N_U,)
    assert tuple(b.params["net"]["w0"].shape) == (9 + N_U, 64)
    assert sft is not None and b.lb.shape == (N_U,)


def test_hexa_hover_balance(hexa):
    """6 x ct x 0.33 = m g by construction."""
    veh = hexa[3].model.vehicle
    thrust = float(np.sum(veh.mixing[0]) * veh.hover_u)
    assert thrust == pytest.approx(veh.mass * 9.81, rel=1e-5)


def test_hexa_mixing_yaw_authority(hexa):
    """Alternating spin: yaw torque from differential same-direction motors."""
    mix = hexa[3].model.mixing
    u = torch.full((N_U,), 0.33)
    u[0::2] += 0.1
    wrench = mix @ u
    assert abs(float(wrench[3])) > 1e-3
    assert abs(float(wrench[1])) < 1e-6 and abs(float(wrench[2])) < 1e-6


def test_hexa_oracle_matches_pallas_interpret(repo_root, hexa):
    """value, value_batch (K = 4) and value_and_grad at n_u = 6 against the
    Pallas oracle in interpret mode, on the problem of ``test_hexa.py``."""
    from sde4mbrl_px4_tpu.engine.mpc_loader import load_mpc_from_cfgfile as j_load

    jb = j_load(os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"))[3]
    b = hexa[3]
    x0 = hover_state().numpy()
    x0[1] = 0.2
    x_ref = np.tile(hover_state().numpy(), (H + 1, 1))
    uref = b.cost_params.uref.numpy()
    pk = pallas_cost_oracle(jb.model, jb.params, jb.cost_params, jb.time_steps,
                            jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(uref),
                            jnp.zeros((1, H, 13), jnp.float32), 1, 4, interpret=True)
    T = torch.from_numpy
    port = CO.cost_oracle(b.model, b.params, b.cost_params, b.time_steps, T(x0), T(x_ref),
                          T(uref), None, 1, 4)
    U = np.random.RandomState(0).uniform(0.2, 0.6, (4, H, N_U)).astype(np.float32)
    vb_p = np.asarray(pk.value_batch(jnp.asarray(U)))
    vb_t = port.value_batch(T(U)).numpy()
    np.testing.assert_allclose(vb_t, vb_p, rtol=2e-5)
    assert float(port.value(T(U[0]))) == pytest.approx(float(vb_p[0]), rel=2e-5)
    v_p, g_p = pk.value_and_grad(jnp.asarray(U[1]))
    v_t, g_t = port.value_and_grad(T(U[1]))
    assert float(v_t) == pytest.approx(float(v_p), rel=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_p), rtol=5e-4, atol=5e-5)
    assert float(np.abs(np.asarray(g_p)[:, 4:]).max()) > 0   # motors 5-6 carry gradient


@pytest.mark.parametrize("name", ["hexa_traj_mpc", "hexa_posctrl_mpc"])
def test_hexa_mpc_fn_lockstep_with_xla(repo_root, name):
    """One ``mpc_fn`` solve at max_iter 10 from an offset state: the port's
    plain solve against JAX's XLA ``mpc_fn`` (the CPU route of the JAX
    loader), equal ``num_steps``, u rtol 2e-4 / atol 2e-5."""
    path = os.path.join(repo_root, f"configs/{name}.yaml")
    cfgs = []
    for load in (load_yaml_config, j_load_yaml):
        cfg = load(path)
        cfg["apg_mpc"].update(max_iter=10, max_no_improvement_iter=10)
        cfgs.append(cfg)
    _, (t_reset, t_mpc), t_sft, _ = make_mpc_from_config(cfgs[0], device="cpu")
    _, (j_reset, j_mpc), _, _ = j_make(cfgs[1])
    t0 = 3.0 if t_sft is not None else 0.0
    xdes = (t_sft(t0) if t_sft is not None else hover_state()).numpy()
    x = enu2ned(torch.from_numpy(xdes)).numpy()
    x[0] += 0.3
    x[3] += 0.2
    rng = jax.random.PRNGKey(0)
    j_st = j_reset(jnp.asarray(x), rng, jnp.asarray(x))
    j_sol = jax.jit(j_mpc)(jnp.asarray(x), rng, j_st, jnp.float32(t0), jnp.asarray(xdes))
    T = torch.from_numpy
    t_st = t_reset(T(x), None, T(x))
    t_sol = t_mpc(T(x), None, t_st, t0, T(xdes))
    assert t_sol.u_opt.shape == (H, N_U)
    assert int(t_sol.opt_state.num_steps) == int(j_sol.opt_state.num_steps) == 10
    np.testing.assert_allclose(t_sol.u_opt.numpy(), np.asarray(j_sol.u_opt),
                               rtol=2e-4, atol=2e-5)
    assert float(t_sol.opt_state.opt_cost) == pytest.approx(
        float(j_sol.opt_state.opt_cost), rel=2e-4)


def test_hexa_controller_passes_six_motors(repo_root):
    """The plan pickup passes hexa 6-motor plans through unchanged (the
    reference pads iris plans to 6 at ``sde_control.py:302-303``)."""
    c = RecedingHorizonController(
        os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"),
        os.path.join(repo_root, "configs/hexa_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0, device="cpu")
    c.pos.deadline_ms, c.pos._iter_ms, c.pos.deadline_min_iters = 1.0, 1.0, 3
    x = enu2ned(hover_state()).numpy()
    x[2] += 0.2
    rec = c.solve_once(x, CONTROL_STATES["pos"], -1.0, hover_state().numpy(), 1e6)
    assert rec.num_steps == 3
    u6, w4, idx = c.pick_command(1e6)
    assert u6.shape == (6,) and w4.shape == (4,) and idx == 0
    assert not np.allclose(u6[4:], 0.0)          # real commands on motors 5-6
    np.testing.assert_allclose(u6, c.u_plan[0, :6])
