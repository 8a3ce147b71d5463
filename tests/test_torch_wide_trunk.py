"""The P=1 kernels on any trunk width (ROADMAP.md item 21).

The JAX package's kernels take the trunk at whatever width its arrays have
(``sde4mbrl_px4_tpu/models/sde_model.py::init_params(..., hidden)``; the
Pallas kernels read ``w0, w1, w2`` as refs of any shape). The port's P=1
kernels pick a form by the trunk's shape (``csrc/apg_solve.cuh::p1_form``):
the register chain on 64 hidden units, the shared-memory step elsewhere,
its weights in device memory where the blocks would not fit 227 KB with
them. On the CPU every wrapper runs its plain twin, which these tests hold
to the JAX package on trunks outside the register chain's widths, at a
small size (H = 6 as ``tests/test_torch_precond.py::_traj_h6``), with the
reference's tolerances:

- the whole solve at P=1, hidden 32: ``pallas_apg_solve`` in interpret mode
  (as ``tests/test_apg_kernel.py:157`` runs it) against ``apg_solve_plain``
  at a fixed budget of 10 iterations, rtol 2e-4 / atol 2e-5, equal steps,
  ``x_evol`` against the JAX mean rollout of the plan at rtol 1e-5;
- the cost oracle, hidden 72: ``pallas_cost_oracle`` in interpret mode
  against ``cost_oracle_plain``: ``value_batch`` rtol 2e-5,
  ``value_and_grad`` rtol 5e-4 / atol 5e-5, ``trajectory`` rtol 1e-5;
- ``build_mpc`` on a 128-unit checkpoint (the shipped one through
  ``goldens.padded_trunk(..., 128, seed=0)``) builds and solves, its first
  solve in lockstep with the JAX package's ``make_mpc_from_config`` at the
  fixed-budget tolerance;
- the form each shape picks: the register chain on its widths, else the
  libraries' choice of a shared-memory step form.

Weights are drawn with numpy from a seed and carried to the port with
``params_from_numpy``. ``test_p1_forms_match_plain_on_cuda`` holds every new
form (the whole solve, ``value_and_grad``, ``value_batch``, ``trajectory``)
against its plain twin on the card at hidden 32, 128 and 256, and skips
without one.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_solve_lockstep, first_solve_pair
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.ops.pallas.apg_kernel import pallas_apg_solve
from sde4mbrl_px4_tpu.ops.pallas.solve_kernels import pallas_cost_oracle
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.engine import mpc_loader as L
from sde4mbrl_px4_tpu_torch.engine.goldens import padded_trunk
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.models.params_io import load_params, params_from_numpy, save_params
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import (
    ORACLE_TRAJECTORY, ORACLE_VALUE_AND_GRAD, ORACLE_VALUE_BATCH, P1_BY_SHAPE, P1_CHAIN,
    P1_GLOBAL, P1_SMEM, SMEM_LIMIT_PARTICLES, build_consts, p1_widths)

H = 6
SOLVE_RTOL, SOLVE_ATOL, X_RTOL = 2e-4, 2e-5, 1e-5
VAL_RTOL, G_RTOL, G_ATOL = 2e-5, 5e-4, 5e-5
T = torch.from_numpy


def numpy_trunk(tree, hidden: int, seed: int):
    """The checkpoint ``tree`` with its trunk redrawn at ``hidden`` units from
    a numpy seed, each weight at the spread of the checkpoint's, biases 0
    but the output layer's (kept)."""
    rs = np.random.RandomState(seed)
    net = tree["net"]
    F, OUT = net["w0"].shape[0], net["w2"].shape[1]
    new = {k: (rs.standard_normal(shape) * float(np.std(net[k]))).astype(np.float32)
           for k, shape in (("w0", (F, hidden)), ("w1", (hidden, hidden)),
                            ("w2", (hidden, OUT)))}
    new.update(b0=np.zeros(hidden, np.float32), b1=np.zeros(hidden, np.float32),
               b2=np.asarray(net["b2"], np.float32))
    return {**tree, "net": new}


def traj_h6(repo_root, ckpt: str, max_iter: int = 10, precond: bool = False) -> dict:
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg.update(horizon=H, num_short_dt=H, learned_model_params=ckpt)
    cfg["apg_mpc"].update(max_iter=max_iter, max_no_improvement_iter=max_iter)
    if not precond:
        cfg["apg_mpc"].pop("precond", None)
    return cfg


def checkpoint(repo_root, tmp_path, hidden: int, seed: int = 7) -> str:
    tree, meta = load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    ckpt = str(tmp_path / f"iris_h{hidden}.pkl")
    save_params(ckpt, params_from_numpy(numpy_trunk(tree, hidden, seed)),
                {**meta, "hidden": hidden})
    return ckpt


def bundles(cfg):
    """(JAX bundle, port bundle on the CPU) of one config."""
    return j_make(copy.deepcopy(cfg))[3], L.make_mpc_from_config(copy.deepcopy(cfg),
                                                                 device="cpu")[3]


def problem(uref):
    x0 = np.asarray(hover_state().numpy()).copy()
    x0[0], x0[3] = 0.3, 0.2
    x_ref = np.tile(hover_state().numpy(), (H + 1, 1))
    u_prev = np.asarray(uref, np.float32)
    u_init = np.tile(u_prev, (H, 1)) + np.float32(0.02)
    return x0, x_ref, u_prev, u_init


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Empty metric caches in ``tmp_path``."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(tmp_path / "precond"))


@pytest.mark.parametrize("hidden, n_u, step", [
    (32, 4, P1_SMEM), (64, 4, P1_CHAIN), (64, 6, P1_CHAIN), (72, 4, P1_SMEM),
    (128, 4, P1_SMEM), (128, 6, P1_SMEM), (256, 4, P1_GLOBAL), (256, 6, P1_GLOBAL)])
def test_p1_step_by_shape(repo_root, hidden, n_u, step):
    """The form of each shape: the register chain exactly on 64 units (iris
    F = 13, hexa F = 15), else a shared-memory step form, which the
    libraries pick (``ApgArgs.step`` asks for that); and the trunk last in the
    consts, as the form with its weights in device memory needs. Which step
    form each kernel takes at ``step``'s widths (the weights in shared
    memory to 128 units, in device memory at 256) is the libraries' choice,
    held on the card by ``test_p1_forms_match_plain_on_cuda``."""
    vehicle = "hexa" if n_u == 6 else "iris"
    tb = L.load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{vehicle}_traj_mpc.yaml"),
                                 device="cpu")[3]
    rs = np.random.RandomState(hidden)
    net = {"w0": rs.standard_normal((9 + n_u, hidden)), "b0": np.zeros(hidden),
           "w1": rs.standard_normal((hidden, hidden)), "b1": np.zeros(hidden),
           "w2": rs.standard_normal((hidden, 12)), "b2": np.zeros(12)}
    params = {**tb.params, "net": params_from_numpy(net)}
    x0 = hover_state()
    _, a = build_consts(tb.model, params, tb.cost_params, tb.apg_config, tb.time_steps, x0,
                        x0.expand(tb.time_steps.shape[0] + 1, 13), torch.zeros(n_u))
    assert (a.F, a.HID, a.step) == (9 + n_u, hidden, P1_BY_SHAPE)
    assert p1_widths(a.F, a.HID) == (step == P1_CHAIN)
    assert a.n_consts == a.o_b2 + 12 and a.o_w0 == a.o_ub + n_u
    assert (a.o_b0, a.o_w1, a.o_b1, a.o_w2) == (
        a.o_w0 + a.F * hidden, a.o_w0 + (a.F + 1) * hidden,
        a.o_w0 + (a.F + 1 + hidden) * hidden, a.o_w0 + (a.F + 2 + hidden) * hidden)


def test_whole_solve_matches_interpret_pallas_h32(repo_root, tmp_path):
    """The JAX package's own whole solve at P=1 on a 32-unit trunk (its
    Pallas kernel in interpret mode) against the port's plain whole solve:
    the TPU kernel takes the width, and so does the port."""
    jb, tb = bundles(traj_h6(repo_root, checkpoint(repo_root, tmp_path, 32)))
    assert tb.params["net"]["w1"].shape == (32, 32)
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


def test_oracle_matches_interpret_pallas_h72(repo_root, tmp_path):
    """The JAX package's cost oracle on a 72-unit trunk (its Pallas kernels
    in interpret mode) against the port's plain oracle: ``value_batch``,
    ``value_and_grad`` and ``trajectory``."""
    jb, tb = bundles(traj_h6(repo_root, checkpoint(repo_root, tmp_path, 72)))
    x0, x_ref, u_prev, _ = problem(tb.cost_params.uref.numpy())
    pk = pallas_cost_oracle(jb.model, jb.params, jb.cost_params, jb.time_steps,
                            jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_prev),
                            jnp.zeros((1, H, 13), jnp.float32), 1, maxls=4, interpret=True)
    port = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps, T(x0),
                          T(x_ref), T(u_prev), None, 1, 4)
    U = np.random.RandomState(11).uniform(0.3, 0.95, (5, H, 4)).astype(np.float32)
    np.testing.assert_allclose(port.value_batch(T(U)).numpy(),
                               np.asarray(pk.value_batch(jnp.asarray(U))), rtol=VAL_RTOL)
    v_t, g_t = port.value_and_grad(T(U[0]))
    v_p, g_p = pk.value_and_grad(jnp.asarray(U[0]))
    assert float(v_t) == pytest.approx(float(v_p), rel=VAL_RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_p), rtol=G_RTOL, atol=G_ATOL)
    np.testing.assert_allclose(port.trajectory(T(U[1])).numpy(),
                               np.asarray(pk.trajectory(jnp.asarray(U[1]))), rtol=X_RTOL,
                               atol=1e-6)


def test_build_mpc_on_a_128_unit_checkpoint(repo_root, tmp_path, cache):
    """The slice's model: the shipped checkpoint through ``padded_trunk(...,
    128, seed=0)`` (its 64 units and 64 new ones at the shipped spread),
    saved and named in ``learned_model_params``. The port builds it on the
    CPU (probing its ``hover_diag`` metric), and its first solve, at a fixed
    budget, is the JAX package's own."""
    tree, meta = load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    ckpt = str(tmp_path / "iris_h128.pkl")
    save_params(ckpt, padded_trunk(params_from_numpy(tree), 128, seed=0),
                {**meta, "hidden": 128})
    cfg = traj_h6(repo_root, ckpt, precond=True)
    sol_j, sol_t, tb = first_solve_pair(cfg, None)
    assert tb.params["net"]["w1"].shape == (128, 128) and tb.precond.shape == (H, 4)
    assert torch.isfinite(sol_t.u_opt).all()
    assert_solve_lockstep(sol_j, sol_t, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [32, 128, 256])
def test_p1_forms_match_plain_on_cuda(repo_root, hidden):
    """Each new form against its plain twin on the card, the iris traj
    config at H = 20 on a trunk of ``hidden`` units (the shared-memory step
    at 32 and 128, its global-weight form at 256): the whole solve at a
    fixed 10 iterations (rtol 2e-4 / atol 2e-5, equal steps, ``x_evol``
    rtol 1e-5), ``value_batch`` K = 1, 20 (rtol 2e-5), ``value_and_grad``
    (rtol 5e-4 / atol 5e-5) and ``trajectory`` (rtol 1e-5); each kernel
    runs the form the libraries pick by shape, within 227 KB, and the other
    step form, named in ``ApgArgs.step``, gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the P=1 shared-memory step is a CUDA kernel")
    import ctypes

    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean as t_rollout_mean

    dev = torch.device("cuda")
    b = L.load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
                                device=dev)[3]
    tree = {"net": {k: v.cpu().numpy() for k, v in b.params["net"].items()}}
    params = {**b.params, "net": params_from_numpy(numpy_trunk(tree, hidden, 5)["net"], dev)}
    hz = int(b.time_steps.shape[0])
    x0 = hover_state(dev)
    x0[0], x0[3] = 0.3, 0.2
    x_ref = hover_state(dev).expand(hz + 1, 13).contiguous()
    u_prev = b.cost_params.uref.clone()
    u_init = (u_prev.expand(hz, 4) + 0.02).contiguous()
    apg = b.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
    args = (b.model, params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev, None, 1,
            b.lb, b.ub, u_init)
    st_k, xe_k = AK.apg_solve_kernel(*args)
    torch.cuda.synchronize()
    st_p, _ = AK.apg_solve_plain(*args)
    assert int(st_k.num_steps) == int(st_p.num_steps)
    torch.testing.assert_close(st_k.yk, st_p.yk, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    ref = t_rollout_mean(b.model, params, x0, st_k.yk, b.time_steps)
    torch.testing.assert_close(xe_k, ref, rtol=X_RTOL, atol=1e-6)
    oargs = (b.model, params, b.cost_params, b.time_steps, x0, x_ref, u_prev, None, 1, 4)
    kern, plain = CO.cost_oracle(*oargs), CO.cost_oracle_plain(*oargs)
    U = torch.from_numpy(np.random.RandomState(3).uniform(0.3, 0.95, (20, hz, 4)).astype(
        np.float32)).to(dev)
    for K in (1, 20):
        torch.testing.assert_close(kern.value_batch(U[:K]), plain.value_batch(U[:K]),
                                   rtol=VAL_RTOL, atol=0.0)
    (vk, gk), (vp, gp) = kern.value_and_grad(U[0]), plain.value_and_grad(U[0])
    torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0.0)
    torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(kern.trajectory(U[1]), plain.trajectory(U[1]), rtol=X_RTOL,
                               atol=1e-6)
    _, a = build_consts(b.model, params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev)
    want = P1_GLOBAL if hidden == 256 else P1_SMEM
    lib, alib = CO.load_oracle_library(), AK.load_apg_library(p1_step=True)
    assert alib.apg_p1_form(ctypes.byref(a)) == want
    for kind in (ORACLE_VALUE_BATCH, ORACLE_VALUE_AND_GRAD, ORACLE_TRAJECTORY):
        assert lib.oracle_p1_form(ctypes.byref(a), kind) == want
    assert max(alib.apg_smem_bytes(ctypes.byref(a)), lib.trajectory_smem_bytes(ctypes.byref(a)),
               lib.value_and_grad_smem_bytes(ctypes.byref(a)),
               lib.value_batch_smem_bytes(ctypes.byref(a), 20)) <= SMEM_LIMIT_PARTICLES
    if hidden == 256:
        return
    # the weights in device memory instead: the same sums, the same bits
    consts, g = build_consts(b.model, params, b.cost_params, None, b.time_steps, x0, x_ref,
                             u_prev)
    g.step = P1_GLOBAL
    assert torch.equal(CO.value_batch_kernel(consts, g, U), kern.value_batch(U))
    assert all(torch.equal(p, q) for p, q in zip(CO.value_and_grad_kernel(consts, g, U[0]),
                                                 kern.value_and_grad(U[0])))
    assert torch.equal(CO.trajectory_kernel(consts, g, U[1]), kern.trajectory(U[1]))
