"""P=1 trunks of more than 16 inputs (ROADMAP item 40), and ROADMAP fault 9.

The JAX package's whole solve and cost oracle take any number of controls
(``sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py:115``, ``:133``, ``:188``): a
trunk of F = 9 + n_u inputs. The port's P=1 wide step keeps a row's
features, controls and wrench in registers for up to 16 inputs; past that
its forms over more inputs run (``consts.p1_wide_inputs``). These tests
hold the port's routes to the JAX package on an 8-rotor vehicle (F = 17),
which neither package ships: each builds it with its own
``models/vehicles.py::_mixing`` (8 rotors evenly spaced, the hexa's mass
and inertia), and both loaders are pointed at it where they would build the
hexa (any n_u other than 4). At a small size (H = 6), with the reference's
tolerances:

- the whole solve at P=1 on a 32-unit trunk: ``pallas_apg_solve`` in
  interpret mode against the port's ``apg_solve_kernel`` (its plain twin on
  the CPU) at a fixed 10 iterations, rtol 2e-4 / atol 2e-5, equal steps,
  ``x_evol`` against the JAX mean rollout of the plan at rtol 1e-5;
- the cost oracle on a 72-unit trunk: ``pallas_cost_oracle`` in interpret
  mode against the port's oracle: ``value_batch`` rtol 2e-5,
  ``value_and_grad`` rtol 5e-4 / atol 5e-5, ``trajectory`` rtol 1e-5.

Fault 9: on the card, ``trajectory`` on a 1024-unit trunk (numpy seed 5)
was 1.7e-6 from its plain twin at one entry, past rtol 1e-5 / atol 1e-6.
Here the JAX package's interpret-mode ``trajectory`` and the port's plain
one on that trunk, four plans, at the reference's tolerance; the card's
side (the kernel and the plain fp32 twin against the float64 rollout) is
``chip_smoke.py`` phase 30's fault 9 line and
``test_wide_inputs_match_plain_on_cuda`` below, which skips without a card.

Weights are drawn with numpy from a seed and carried to the port with
``params_from_numpy``.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.engine import mpc_loader as JL
from sde4mbrl_px4_tpu.models import vehicles as JV
from sde4mbrl_px4_tpu.ops.pallas.apg_kernel import pallas_apg_solve
from sde4mbrl_px4_tpu.ops.pallas.solve_kernels import pallas_cost_oracle
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.engine import mpc_loader as L
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.models import vehicles as TV
from sde4mbrl_px4_tpu_torch.models.params_io import load_params, params_from_numpy, save_params
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import p1_wide_inputs, p1_widths

H = 6
MOTORS = 8
SOLVE_RTOL, SOLVE_ATOL, X_RTOL = 2e-4, 2e-5, 1e-5
VAL_RTOL, G_RTOL, G_ATOL = 2e-5, 5e-4, 5e-5
T = torch.from_numpy


def rotor_vehicle(V, n: int):
    """An n-rotor vehicle from package ``V``'s ``models/vehicles.py``: the
    hexa's mass and inertia, rotors evenly spaced at 0.30 m with alternating
    spin, hovering at 2 / n a motor (as ``chip_smoke.py::rotor_vehicle``)."""
    hexa, hover = V.hexa_config(), 2.0 / n
    ct = hexa.mass * 9.81 / (n * hover)
    ang = 2.0 * np.pi * (np.arange(n) + 0.5) / n
    xy = 0.30 * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    spin = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return V.VehicleConfig(name=f"rotor{n}", n_motors=n, mass=hexa.mass,
                           inertia=hexa.inertia, mixing=V._mixing(xy, spin, ct, 0.06 * ct),
                           hover_u=hover)


def rotor_tree(tree, n: int, hidden: int, seed: int):
    """The hexa checkpoint ``tree`` with a trunk of 9 + n inputs and
    ``hidden`` units drawn from a numpy seed, each weight at the spread of
    the hexa's, biases 0 but the output layer's (kept)."""
    rs = np.random.RandomState(seed)
    net = tree["net"]
    OUT = net["w2"].shape[1]
    new = {k: (rs.standard_normal(shape) * float(np.std(net[k]))).astype(np.float32)
           for k, shape in (("w0", (9 + n, hidden)), ("w1", (hidden, hidden)),
                            ("w2", (hidden, OUT)))}
    new.update(b0=np.zeros(hidden, np.float32), b1=np.zeros(hidden, np.float32),
               b2=np.asarray(net["b2"], np.float32))
    return {**tree, "net": new}


@pytest.fixture
def rotors(monkeypatch):
    """Both loaders build the 8-rotor vehicle where they would build the
    hexa; returns n."""
    monkeypatch.setattr(JL, "hexa_config", lambda: rotor_vehicle(JV, MOTORS))
    monkeypatch.setattr(L, "hexa_config", lambda: rotor_vehicle(TV, MOTORS))
    return MOTORS


def rotor_config(repo_root, tmp_path, n: int, hidden: int) -> dict:
    """The hexa traj config at H = 6 widened to n controls, on an n-rotor
    checkpoint of ``hidden`` units, at a fixed budget of 10 iterations."""
    tree, meta = load_params(os.path.join(repo_root, "configs/models/hexa_sde.pkl"))
    ckpt = str(tmp_path / f"rotor{n}_h{hidden}.pkl")
    save_params(ckpt, params_from_numpy(rotor_tree(tree, n, hidden, 7)),
                {**meta, "vehicle": f"rotor{n}", "hidden": hidden})
    cfg = load_yaml_config(os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"))
    cfg.update(horizon=H, num_short_dt=H, learned_model_params=ckpt)
    cfg["input_constr"] = {"input_id": list(range(n)), "input_bound": [[1.0e-4, 1.0]] * n}
    cfg["cost_params"]["uref"] = [2.0 / n] * n
    cfg["apg_mpc"].update(max_iter=10, max_no_improvement_iter=10)
    cfg["apg_mpc"].pop("precond", None)
    return cfg


def bundles(cfg):
    """(JAX bundle, port bundle on the CPU) of one config."""
    return JL.make_mpc_from_config(copy.deepcopy(cfg))[3], L.make_mpc_from_config(
        copy.deepcopy(cfg), device="cpu")[3]


def problem(uref):
    x0 = np.asarray(hover_state().numpy()).copy()
    x0[0], x0[3] = 0.3, 0.2
    x_ref = np.tile(hover_state().numpy(), (H + 1, 1))
    u_prev = np.asarray(uref, np.float32)
    u_init = np.tile(u_prev, (H, 1)) + np.float32(0.02)
    return x0, x_ref, u_prev, u_init


def test_rotor_vehicles_agree_and_take_the_wide_step(rotors):
    """The 8-rotor vehicle of both packages is the same airframe, and its
    17-input trunk runs the wide step's forms over more than 16 inputs at
    every width (the register chain takes at most 16)."""
    jv, tv = rotor_vehicle(JV, rotors), rotor_vehicle(TV, rotors)
    np.testing.assert_array_equal(jv.mixing, tv.mixing)
    assert (jv.mass, jv.hover_u, jv.n_motors) == (tv.mass, tv.hover_u, tv.n_motors)
    assert tv.mixing.shape == (4, rotors)
    # the total thrust at hover balances the weight; the rotors cancel torques
    u = np.full(rotors, tv.hover_u)
    np.testing.assert_allclose(tv.mixing @ u, [tv.mass * 9.81, 0.0, 0.0, 0.0], atol=1e-9)
    for hid in (32, 64, 72, 128):
        assert not p1_widths(9 + rotors, hid) and p1_wide_inputs(9 + rotors)


def test_whole_solve_matches_interpret_pallas_8_rotors_h32(repo_root, tmp_path, rotors):
    """The JAX package's own whole solve at P=1 on an 8-rotor, 32-unit trunk
    (its Pallas kernel in interpret mode) against the port's whole solve:
    the TPU kernel takes 17 inputs, and so does the port."""
    jb, tb = bundles(rotor_config(repo_root, tmp_path, rotors, 32))
    assert tb.model.n_u == rotors and tb.params["net"]["w0"].shape == (9 + rotors, 32)
    x0, x_ref, u_prev, u_init = problem(tb.cost_params.uref.numpy())
    apg = jb.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
    st_p = pallas_apg_solve(
        jb.model, jb.params, jb.cost_params, apg, jb.time_steps, jnp.asarray(x0),
        jnp.asarray(x_ref), jnp.asarray(u_prev), jnp.zeros((1, H, 13), jnp.float32), 1,
        jb.lb, jb.ub, jnp.asarray(u_init), interpret=True, deterministic=True)
    tapg = tb.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
    launches = AK.apg_solve_kernel.launches
    st_t, x_evol = AK.apg_solve_kernel(tb.model, tb.params, tb.cost_params, tapg,
                                       tb.time_steps, T(x0), T(x_ref), T(u_prev), None, 1,
                                       tb.lb, tb.ub, T(u_init))
    assert AK.apg_solve_kernel.launches == launches        # CPU: the plain twin
    assert int(st_t.num_steps) == int(st_p.num_steps)
    np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_p.yk), rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL)
    assert float(st_t.opt_cost) == pytest.approx(float(st_p.opt_cost), rel=SOLVE_RTOL)
    ref = rollout_mean(jb.model, jb.params, jnp.asarray(x0), jnp.asarray(st_t.yk.numpy()),
                       jb.time_steps)
    np.testing.assert_allclose(x_evol.numpy(), np.asarray(ref), rtol=X_RTOL, atol=1e-6)


def test_oracle_matches_interpret_pallas_8_rotors_h72(repo_root, tmp_path, rotors):
    """The JAX package's cost oracle on an 8-rotor, 72-unit trunk (its
    Pallas kernels in interpret mode) against the port's oracle:
    ``value_batch``, ``value_and_grad`` and ``trajectory``."""
    jb, tb = bundles(rotor_config(repo_root, tmp_path, rotors, 72))
    x0, x_ref, u_prev, _ = problem(tb.cost_params.uref.numpy())
    pk = pallas_cost_oracle(jb.model, jb.params, jb.cost_params, jb.time_steps,
                            jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_prev),
                            jnp.zeros((1, H, 13), jnp.float32), 1, maxls=4, interpret=True)
    port = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps, T(x0),
                          T(x_ref), T(u_prev), None, 1, 4)
    hover = float(tb.cost_params.uref[0])
    U = (np.random.RandomState(11).uniform(0.6, 1.4, (5, H, rotors)) * hover).astype(np.float32)
    np.testing.assert_allclose(port.value_batch(T(U)).numpy(),
                               np.asarray(pk.value_batch(jnp.asarray(U))), rtol=VAL_RTOL)
    v_t, g_t = port.value_and_grad(T(U[0]))
    v_p, g_p = pk.value_and_grad(jnp.asarray(U[0]))
    assert float(v_t) == pytest.approx(float(v_p), rel=VAL_RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_p), rtol=G_RTOL, atol=G_ATOL)
    np.testing.assert_allclose(port.trajectory(T(U[1])).numpy(),
                               np.asarray(pk.trajectory(jnp.asarray(U[1]))), rtol=X_RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("plan", range(4))
def test_fault9_trajectory_matches_interpret_pallas_h1024(repo_root, tmp_path, plan):
    """Fault 9's problem on the CPU: the iris traj config (H = 20) on a
    1024-unit trunk drawn from numpy seed 5 (the card tests' ``card_problem``),
    x0 off the hover, the card tests' plans (numpy seed 3): the JAX package's
    interpret-mode ``trajectory`` against the port's plain one at the
    reference's rtol 1e-5 / atol 1e-6."""
    from test_torch_wide_trunk import numpy_trunk

    tree, meta = load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    ckpt = str(tmp_path / "iris_h1024.pkl")
    save_params(ckpt, params_from_numpy(numpy_trunk(tree, 1024, 5)), {**meta, "hidden": 1024})
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg["learned_model_params"] = ckpt
    cfg["apg_mpc"].pop("precond", None)
    jb, tb = bundles(cfg)
    hz = int(tb.time_steps.shape[0])
    x0 = hover_state().numpy().copy()
    x0[0], x0[3] = 0.3, 0.2
    x_ref = np.tile(hover_state().numpy(), (hz + 1, 1))
    u_prev = tb.cost_params.uref.numpy()
    U = np.random.RandomState(3).uniform(0.3, 0.95, (20, hz, 4)).astype(np.float32)
    pk = pallas_cost_oracle(jb.model, jb.params, jb.cost_params, jb.time_steps,
                            jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_prev),
                            jnp.zeros((1, hz, 13), jnp.float32), 1, maxls=4, interpret=True)
    port = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps, T(x0),
                          T(x_ref), T(u_prev), None, 1, 4)
    np.testing.assert_allclose(port.trajectory(T(U[plan])).numpy(),
                               np.asarray(pk.trajectory(jnp.asarray(U[plan]))), rtol=X_RTOL,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [64, 256])
def test_wide_inputs_match_plain_on_cuda(repo_root, tmp_path, rotors, hidden):
    """On the card, the 8-rotor trunk at 64 units (the weights in shared
    memory) and 256 (in device memory): the whole solve at a fixed 10
    iterations and ``value_and_grad`` in their forms over more than 16
    inputs against their plain twins (equal steps, ``yk`` rtol 2e-4 / atol
    2e-5; the gradient rtol 5e-4 / atol 5e-5), and two scenarios in one
    launch bit-equal to their solo launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wide step's forms over 16 inputs are CUDA kernels")
    dev = torch.device("cuda")
    cfg = rotor_config(repo_root, tmp_path, rotors, hidden)
    b = L.make_mpc_from_config(copy.deepcopy(cfg), device=dev)[3]
    x0, x_ref, u_prev, u_init = (T(v).to(dev) for v in problem(b.cost_params.uref.cpu().numpy()))
    x_ref, u_init = x_ref.contiguous(), u_init.contiguous()
    args = (b.model, b.params, b.cost_params, b.apg_config, b.time_steps, x0, x_ref, u_prev,
            None, 1, b.lb, b.ub, u_init)
    w0 = (AK.apg_solve_kernel.launches_wide_inputs, CO.value_and_grad_kernel.launches_wide_inputs)
    st_k, _ = AK.apg_solve_kernel(*args)
    st_p, _ = AK.apg_solve_plain(*args)
    assert int(st_k.num_steps) == int(st_p.num_steps)
    torch.testing.assert_close(st_k.yk, st_p.yk, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    oargs = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev, None, 1, 4)
    u = u_init + 0.01
    (vk, gk), (vp, gp) = (CO.cost_oracle(*oargs).value_and_grad(u),
                          CO.cost_oracle_plain(*oargs).value_and_grad(u))
    torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0.0)
    torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
    X0 = x0.expand(2, 13).clone()
    X0[1, 0] += 0.1
    XR, UP = x_ref.expand(2, *x_ref.shape).contiguous(), u_prev.expand(2, -1).contiguous()
    UI = u_init.expand(2, *u_init.shape).contiguous()
    st_b, _ = AK.apg_solve_kernel_batched(b.model, b.params, b.cost_params, b.apg_config,
                                          b.time_steps, X0, XR, UP, None, 1, b.lb, b.ub, UI)
    vb, gb = CO.cost_oracle_batched(b.model, b.params, b.cost_params, b.time_steps, X0, XR, UP,
                                    None, 1, 4).value_and_grad(UI + 0.01)
    for i in range(2):
        st_1, _ = AK.apg_solve_kernel(b.model, b.params, b.cost_params, b.apg_config,
                                      b.time_steps, X0[i], x_ref, u_prev, None, 1, b.lb, b.ub,
                                      u_init)
        v1, g1 = CO.cost_oracle(b.model, b.params, b.cost_params, b.time_steps, X0[i], x_ref,
                                u_prev, None, 1, 4).value_and_grad(u)
        assert torch.equal(st_1.yk, st_b.yk[i]) and torch.equal(v1, vb[i])
        assert torch.equal(g1, gb[i])
    assert (AK.apg_solve_kernel.launches_wide_inputs - w0[0],
            CO.value_and_grad_kernel.launches_wide_inputs - w0[1]) == (4, 4)
