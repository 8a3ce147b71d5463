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
  libraries' choice of a P=1 step form; for the whole solve and
  ``value_and_grad`` (the wide step) the width at which each leaves its
  weights in shared memory (the 227 KB line), the width past which its
  global-weight form keeps its width-sized buffers in device memory, and
  that 2048 units then fit, from this module's mirror of the libraries'
  layouts (:func:`p1_step_bytes`);
- the P=1 kernels' inputs: the register chain takes at most 16 (8 motors
  or more run the wide step), and the wide step any number, past 16 in forms
  of their own (``consts.p1_wide_inputs``; the 8-motor vehicle against the
  JAX package: ``tests/test_torch_wide_inputs.py``).

Weights are drawn with numpy from a seed and carried to the port with
``params_from_numpy``. ``test_p1_forms_match_plain_on_cuda`` holds every new
form (the whole solve, ``value_and_grad``, ``value_batch``, ``trajectory``)
against its plain twin on the card at hidden 32, 72, 128, 152 and 256, the
weights in device memory against shared memory bit for bit, and
:func:`p1_step_bytes` against the libraries' answer;
``test_wide_step_far_matches_plain_on_cuda`` holds the wide step at 1024
and 2048 units, its buffers in the launch's scratch, to its plain twin and
its scenarios to their solo launches. Both skip without a card.
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
    P1_FMAX, P1_GLOBAL, P1_SMEM, SMEM_LIMIT_PARTICLES, ApgArgs, build_consts,
    p1_wide_inputs, p1_widths)

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


def traj_args(repo_root, hidden: int, n_u: int, seed: int = None):
    """The ApgArgs of the shipped traj config of the airframe with ``n_u``
    motors on a trunk of ``hidden`` units drawn from a numpy seed."""
    vehicle = "hexa" if n_u == 6 else "iris"
    tb = L.load_mpc_from_cfgfile(os.path.join(repo_root, f"configs/{vehicle}_traj_mpc.yaml"),
                                 device="cpu")[3]
    rs = np.random.RandomState(hidden if seed is None else seed)
    net = {"w0": rs.standard_normal((9 + n_u, hidden)), "b0": np.zeros(hidden),
           "w1": rs.standard_normal((hidden, hidden)), "b1": np.zeros(hidden),
           "w2": rs.standard_normal((hidden, 12)), "b2": np.zeros(12)}
    params = {**tb.params, "net": params_from_numpy(net)}
    x0 = hover_state()
    return build_consts(tb.model, params, tb.cost_params, tb.apg_config, tb.time_steps, x0,
                        x0.expand(tb.time_steps.shape[0] + 1, 13), torch.zeros(n_u))[1]


# The wide step's layer 1 slices (csrc/sweeps.cuh kSlices) and the whole
# solve's static shared memory (sizeof(Scal), csrc/apg_solve.cu), for the
# mirror below.
P1_SLICES, APG_SCAL_BYTES = 8, 72


def wide_step_bufs(a, kind, step):
    """The wide step's buffers in floats, in each library's layout order
    (``csrc/apg_solve.cu::layout`` for the whole solve, ``kind`` None;
    ``csrc/cost_oracle.cu::layout`` for ``value_and_grad``): (the buffers
    always in shared memory, the width-sized ones (h0p, h1p, pp, w2t) that
    the global-weight form moves to device memory past 227 KB)."""
    H, HZ, HID, K = a.H, a.H * a.nZ, a.HID, a.K
    consts = a.o_w0 if step == P1_GLOBAL else a.n_consts
    if kind is None:
        near = ([consts] + [HZ] * 7 + [K * HZ, (H + 1) * 13, H * a.OUT, H * 4, K * HID, K, K,
                                         a.nZ, HID, HID, 32])
        return near, [H * HID, H * HID, P1_SLICES * K * HID, a.OUT * HID]
    near = [consts, HZ, HID, 1, 1, 32, (H + 1) * 13, HZ, a.nZ, HID, HID, H * a.OUT, H * 4]
    return near, [H * HID, H * HID, P1_SLICES * HID, a.OUT * HID]


def p1_step_bytes(a, kind, step, far: bool = False) -> int:
    """Shared memory of a P=1 launch on the wide step in form ``step`` for
    a's dimensions, the whole solve (``kind`` None; ``apg_smem_bytes``, every
    buffer on 16 bytes, with its static Scal) or ``value_and_grad``
    (``value_and_grad_smem_bytes``, with its static value); ``far``: the
    width-sized buffers in device memory."""
    near, wide = wide_step_bufs(a, kind, step)
    bufs = near if far else near + wide
    if kind is None:
        return sum((n + 3) // 4 * 4 for n in bufs[:-1]) * 4 + bufs[-1] * 4 + APG_SCAL_BYTES
    return sum(bufs) * 4 + 4


def p1_far_floats(a, kind) -> int:
    """Floats of one scenario's region of the scratch with the width-sized
    buffers in device memory (``apg_scratch_floats`` /
    ``value_and_grad_scratch_floats`` at B = 1)."""
    _, wide = wide_step_bufs(a, kind, P1_GLOBAL)
    n = sum((n + 3) // 4 * 4 for n in wide[:-1]) + wide[-1] if kind is None else sum(wide)
    return (n + 3) // 4 * 4


def p1_step_form(a, kind):
    """The P=1 form the libraries take by shape in the whole solve (``kind``
    None) or ``value_and_grad``, and whether its buffers go to device
    memory: the register chain on its widths, else the wide step with the
    weights in shared memory where the block fits 227 KB with them, else in
    device memory, its width-sized buffers there too where the block would
    not fit 227 KB with them."""
    if p1_widths(a.F, a.HID):
        return P1_CHAIN, False
    if p1_step_bytes(a, kind, P1_SMEM) <= SMEM_LIMIT_PARTICLES:
        return P1_SMEM, False
    return P1_GLOBAL, p1_step_bytes(a, kind, P1_GLOBAL) > SMEM_LIMIT_PARTICLES


# (hidden, n_u, the chain or a step form, (the whole solve's form, value_and_grad's))
P1_SHAPES = [
    (32, 4, P1_SMEM, (P1_SMEM, P1_SMEM)), (64, 4, P1_CHAIN, (P1_CHAIN, P1_CHAIN)),
    (64, 6, P1_CHAIN, (P1_CHAIN, P1_CHAIN)), (72, 4, P1_SMEM, (P1_SMEM, P1_SMEM)),
    (128, 4, P1_SMEM, (P1_SMEM, P1_SMEM)), (128, 6, P1_SMEM, (P1_SMEM, P1_SMEM)),
    (152, 4, P1_SMEM, (P1_SMEM, P1_SMEM)), (184, 4, P1_SMEM, (P1_SMEM, P1_SMEM)),
    (184, 6, P1_SMEM, (P1_GLOBAL, P1_SMEM)), (192, 4, P1_SMEM, (P1_GLOBAL, P1_SMEM)),
    (200, 4, P1_SMEM, (P1_GLOBAL, P1_GLOBAL)), (256, 4, P1_GLOBAL, (P1_GLOBAL, P1_GLOBAL)),
    (256, 6, P1_GLOBAL, (P1_GLOBAL, P1_GLOBAL))]


@pytest.mark.parametrize("hidden, n_u, step, forms", P1_SHAPES)
def test_p1_step_by_shape(repo_root, hidden, n_u, step, forms):
    """The form of each shape: the register chain exactly on 64 units (iris
    F = 13, hexa F = 15), else a P=1 step form, which the libraries pick
    (``ApgArgs.step`` asks for that); and the trunk last in the consts, as
    the form with its weights in device memory needs. The whole solve and
    ``value_and_grad`` (the wide step) keep the weights in shared memory to
    184 and 192 units on iris (176 and 192 on the hexa), then read them in
    device memory (:func:`p1_step_form` on :func:`p1_step_bytes`, which the
    card's test holds to the libraries' own answer); ``value_batch``'s and
    ``trajectory``'s forms are theirs, held on the card by
    ``test_p1_forms_match_plain_on_cuda``."""
    a = traj_args(repo_root, hidden, n_u)
    assert (a.F, a.HID, a.step) == (9 + n_u, hidden, P1_BY_SHAPE)
    assert p1_widths(a.F, a.HID) == (step == P1_CHAIN)
    assert (p1_step_form(a, None), p1_step_form(a, ORACLE_VALUE_AND_GRAD)) == tuple(
        (f, False) for f in forms)
    assert a.n_consts == a.o_b2 + 12 and a.o_w0 == a.o_ub + n_u
    assert (a.o_b0, a.o_w1, a.o_b1, a.o_w2) == (
        a.o_w0 + a.F * hidden, a.o_w0 + (a.F + 1) * hidden,
        a.o_w0 + (a.F + 1 + hidden) * hidden, a.o_w0 + (a.F + 2 + hidden) * hidden)


# (n_u, kind, the widest trunk in shared memory, the widest in device memory
# with every buffer in shared memory)
WIDE_STEP_LINES = [(4, None, 184, 624), (4, ORACLE_VALUE_AND_GRAD, 192, 896),
                   (6, None, 176, 616), (6, ORACLE_VALUE_AND_GRAD, 192, 896)]


@pytest.mark.parametrize("n_u, kind, smem, glob", WIDE_STEP_LINES)
def test_wide_step_227kb_lines(repo_root, n_u, kind, smem, glob):
    """The 227 KB lines of the wide step on the traj configs (H = 20, K =
    4), in multiples of 8 units: the widest trunk whose block fits with the
    weights in shared memory, and the widest with them in device memory
    and every buffer in shared memory; past that the width-sized buffers
    (the stash, layer 1's slice sums, the transposed output layer) go to the
    launch's scratch in device memory, and the block fits to 2048 units and
    past."""
    for hid, step, fits in ((smem, P1_SMEM, True), (smem + 8, P1_SMEM, False),
                            (glob, P1_GLOBAL, True), (glob + 8, P1_GLOBAL, False)):
        a = traj_args(repo_root, hid, n_u, seed=0)
        need = p1_step_bytes(a, kind, step)
        assert (need <= SMEM_LIMIT_PARTICLES) == fits, (hid, step, need)
        assert p1_step_form(a, kind) == ((P1_SMEM, False) if step == P1_SMEM and fits else
                                         (P1_GLOBAL, step == P1_GLOBAL and not fits))
    for hid in (glob + 8, 1024, 2048):
        a = traj_args(repo_root, hid, n_u, seed=0)
        assert p1_step_form(a, kind) == (P1_GLOBAL, True)
        assert p1_step_bytes(a, kind, P1_GLOBAL, far=True) <= SMEM_LIMIT_PARTICLES
        assert p1_far_floats(a, kind) >= 2 * a.H * hid + (P1_SLICES + 12) * hid


@pytest.mark.parametrize("n_u, F_ok", [(4, True), (6, True), (7, True), (8, False)])
def test_p1_kernels_refuse_wide_inputs(n_u, F_ok):
    """A trunk of 9 + n_u inputs at P=1: the register chain holds at most 16
    features in registers, so 8 motors or more (F = 17) run the wide step
    even on 64 units; the wide step takes them, past 16 in its forms over
    more inputs (``p1_wide_inputs``), and the wrappers raise for none: the
    plain whole solve and ``value_and_grad`` run an 8-motor trunk."""
    a = ApgArgs()
    a.F, a.HID, a.n_u, a.has_noise = 9 + n_u, 128, n_u, 0
    assert p1_widths(a.F, 64) == F_ok          # the chain's own limit
    assert p1_wide_inputs(a.F) == (not F_ok) == (a.F > P1_FMAX)
    assert not hasattr(AK, "p1_check_inputs") and not hasattr(CO, "p1_check_inputs")


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


def card_problem(repo_root, hidden: int):
    """The card tests' problem: the iris traj config at H = 20 on the card
    with a trunk of ``hidden`` units drawn from a numpy seed, x0 off the
    hover, a fixed 10-iteration budget. Returns (bundle, params, the whole
    solve's arguments, the oracle's arguments, plans U (20, H, 4))."""
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
    oargs = (b.model, params, b.cost_params, b.time_steps, x0, x_ref, u_prev, None, 1, 4)
    U = torch.from_numpy(np.random.RandomState(3).uniform(0.3, 0.95, (20, hz, 4)).astype(
        np.float32)).to(dev)
    return b, params, args, oargs, U


def card_solve_matches_plain(b, params, args):
    """The whole solve on the card against its plain twin: equal steps,
    ``yk`` at rtol 2e-4 / atol 2e-5, ``x_evol`` the mean rollout of its
    plan at rtol 1e-5. Returns the kernel's (state, x_evol)."""
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean as t_rollout_mean

    st_k, xe_k = AK.apg_solve_kernel(*args)
    torch.cuda.synchronize()
    st_p, _ = AK.apg_solve_plain(*args)
    assert int(st_k.num_steps) == int(st_p.num_steps)
    torch.testing.assert_close(st_k.yk, st_p.yk, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    ref = t_rollout_mean(b.model, params, args[5], st_k.yk, b.time_steps)
    torch.testing.assert_close(xe_k, ref, rtol=X_RTOL, atol=1e-6)
    return st_k, xe_k


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [32, 72, 128, 152, 256])
def test_p1_forms_match_plain_on_cuda(repo_root, hidden):
    """Each new form against its plain twin on the card, the iris traj
    config at H = 20 on a trunk of ``hidden`` units (the weights in shared
    memory to 152 units, in device memory at 256; the whole solve and
    ``value_and_grad`` on the wide step): the whole solve at a fixed 10
    iterations (rtol 2e-4 / atol 2e-5, equal steps, ``x_evol`` rtol 1e-5),
    ``value_batch`` K = 1, 20 (rtol 2e-5), ``value_and_grad`` (rtol 5e-4 /
    atol 5e-5) and ``trajectory`` (rtol 1e-5); each kernel runs the form the
    libraries pick by shape, within 227 KB, the wide step's bytes are
    :func:`p1_step_bytes`, and the weights in device memory, named in
    ``ApgArgs.step``, give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the P=1 shared-memory step is a CUDA kernel")
    import ctypes

    b, params, args, oargs, U = card_problem(repo_root, hidden)
    st_k, xe_k = card_solve_matches_plain(b, params, args)
    kern, plain = CO.cost_oracle(*oargs), CO.cost_oracle_plain(*oargs)
    for K in (1, 20):
        torch.testing.assert_close(kern.value_batch(U[:K]), plain.value_batch(U[:K]),
                                   rtol=VAL_RTOL, atol=0.0)
    (vk, gk), (vp, gp) = kern.value_and_grad(U[0]), plain.value_and_grad(U[0])
    torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0.0)
    torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
    torch.testing.assert_close(kern.trajectory(U[1]), plain.trajectory(U[1]), rtol=X_RTOL,
                               atol=1e-6)
    _, a = build_consts(*args[:8])
    want = P1_GLOBAL if hidden == 256 else P1_SMEM
    lib, alib = CO.load_oracle_library(), AK.load_apg_library(p1_step=True)
    assert alib.apg_p1_form(ctypes.byref(a)) == want
    assert p1_step_form(a, None) == p1_step_form(a, ORACLE_VALUE_AND_GRAD) == (want, False)
    for kind in (ORACLE_VALUE_BATCH, ORACLE_VALUE_AND_GRAD, ORACLE_TRAJECTORY):
        assert lib.oracle_p1_form(ctypes.byref(a), kind) == want
    assert alib.apg_smem_bytes(ctypes.byref(a)) == p1_step_bytes(a, None, want)
    assert lib.value_and_grad_smem_bytes(ctypes.byref(a)) == p1_step_bytes(
        a, ORACLE_VALUE_AND_GRAD, want)
    assert max(alib.apg_smem_bytes(ctypes.byref(a)), lib.trajectory_smem_bytes(ctypes.byref(a)),
               lib.value_and_grad_smem_bytes(ctypes.byref(a)),
               lib.value_batch_smem_bytes(ctypes.byref(a), 20)) <= SMEM_LIMIT_PARTICLES
    if hidden == 256:
        return
    # the weights in device memory instead: the same sums, the same bits
    consts, g = build_consts(b.model, params, b.cost_params, None, *args[4:8])
    g.step = P1_GLOBAL
    from sde4mbrl_px4_tpu_torch.p1_step_ab import forced
    with forced(P1_GLOBAL):
        st_g, xe_g = AK.apg_solve_kernel(*args)
    assert torch.equal(st_g.yk, st_k.yk) and torch.equal(xe_g, xe_k)
    assert torch.equal(st_g.opt_cost, st_k.opt_cost)
    assert torch.equal(CO.value_batch_kernel(consts, g, U), kern.value_batch(U))
    assert all(torch.equal(p, q) for p, q in zip(CO.value_and_grad_kernel(consts, g, U[0]),
                                                 kern.value_and_grad(U[0])))
    assert torch.equal(CO.trajectory_kernel(consts, g, U[1]), kern.trajectory(U[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [1024, 2048])
def test_wide_step_far_matches_plain_on_cuda(repo_root, hidden):
    """The wide step past 227 KB on the card (the problem of
    :func:`card_problem`): its stash, slice sums and transposed output
    layer in the launch's scratch in device memory, the weights there too.
    The whole solve at a fixed 10 iterations and ``value_and_grad`` against
    their plain twins at the tolerances of
    ``test_p1_forms_match_plain_on_cuda``; the shared memory and the
    scratch each library asks for against :func:`p1_step_bytes` and
    :func:`p1_far_floats`; and B = 2 scenarios in one launch of each,
    bit-equal to their solo launches (each scenario its own region of the
    scratch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the P=1 wide step is a CUDA kernel")
    import ctypes

    b, params, args, oargs, U = card_problem(repo_root, hidden)
    _, a = build_consts(*args[:8])
    lib, alib = CO.load_oracle_library(), AK.load_apg_library(p1_step=True)
    assert alib.apg_p1_form(ctypes.byref(a)) == lib.oracle_p1_form(
        ctypes.byref(a), ORACLE_VALUE_AND_GRAD) == P1_GLOBAL
    assert p1_step_form(a, None) == p1_step_form(a, ORACLE_VALUE_AND_GRAD) == (P1_GLOBAL, True)
    assert alib.apg_smem_bytes(ctypes.byref(a)) == p1_step_bytes(a, None, P1_GLOBAL, True)
    assert lib.value_and_grad_smem_bytes(ctypes.byref(a)) == p1_step_bytes(
        a, ORACLE_VALUE_AND_GRAD, P1_GLOBAL, True)
    assert alib.apg_scratch_floats(ctypes.byref(a)) == p1_far_floats(a, None)
    assert lib.value_and_grad_scratch_floats(ctypes.byref(a)) == p1_far_floats(
        a, ORACLE_VALUE_AND_GRAD)
    st_k, xe_k = card_solve_matches_plain(b, params, args)
    kern, plain = CO.cost_oracle(*oargs), CO.cost_oracle_plain(*oargs)
    (vk, gk), (vp, gp) = kern.value_and_grad(U[0]), plain.value_and_grad(U[0])
    torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0.0)
    torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
    # two scenarios, x0 0.1 m apart, in one launch of each kernel
    m, cp, ts, x0, x_ref, u_prev, u_init = (b.model, b.cost_params, b.time_steps, args[5],
                                            args[6], args[7], args[12])
    X0 = x0.expand(2, 13).clone()
    X0[1, 0] += 0.1
    XR, UP = x_ref.expand(2, *x_ref.shape).contiguous(), u_prev.expand(2, -1).contiguous()
    UI = u_init.expand(2, *u_init.shape).contiguous()
    st_b, xe_b = AK.apg_solve_kernel_batched(m, params, cp, args[3], ts, X0, XR, UP, None, 1,
                                             b.lb, b.ub, UI)
    vb, gb = CO.cost_oracle_batched(m, params, cp, ts, X0, XR, UP, None, 1, 4).value_and_grad(
        U[:2].contiguous())
    for i in range(2):
        st_1, xe_1 = AK.apg_solve_kernel(m, params, cp, args[3], ts, X0[i], x_ref, u_prev, None,
                                         1, b.lb, b.ub, u_init)
        v1, g1 = CO.cost_oracle(m, params, cp, ts, X0[i], x_ref, u_prev, None, 1,
                                4).value_and_grad(U[i])
        assert torch.equal(st_1.yk, st_b.yk[i]) and torch.equal(xe_1, xe_b[i])
        assert torch.equal(v1, vb[i]) and torch.equal(g1, gb[i])
    assert torch.equal(st_b.yk[0], st_k.yk) and torch.equal(vb[0], vk)
