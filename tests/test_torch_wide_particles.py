"""The particle forms of kernels #1-#3 on any trunk width (ROADMAP.md item 35).

The JAX package's particle kernels take the trunk at whatever width its
arrays have (the Pallas kernels read ``w0, w1, w2`` as refs of any shape),
and its loader sends every particle solve with P <= 128, and any P with
``pallas_chunk``, to them (``sde4mbrl_px4_tpu/engine/mpc_loader.py:333-334``).
The port's particle forms keep the trunk, and its transposes for the
reverse sweep, in a block's shared memory up to 144 units at P=512; past
that they read the weights in place from device memory (the global-weight
forms, ``csrc/apg_solve.cuh::part_form``), planned only where no chunk of
the shared-memory form fits (``ops/cuda/consts.py::plan_particles``). On
the CPU every wrapper runs its plain twin, which these tests hold to the
JAX package on trunks past 144 units, at H = 6, on the same draws (numpy's,
or JAX's own key splits through ``mpc_fn``'s ``rng``), with the reference's
tolerances:

- the cost oracle on a 160-unit trunk at P = 8 in chunks of 4:
  ``pallas_cost_oracle`` in interpret mode against the port's oracle,
  ``value_batch`` rtol 2e-5, ``value_and_grad`` rtol 5e-4 / atol 5e-5;
- the whole solve on a 160-unit trunk at P = 4: ``pallas_apg_solve`` in
  interpret mode against ``apg_solve_plain`` at a fixed 10 iterations,
  rtol 2e-4 / atol 2e-5, equal steps;
- ``mpc_fn`` at P = 8 antithetic on a saved 192-unit checkpoint, its first
  solve in lockstep with the JAX ``mpc_fn``'s on JAX's draws;
- MPPI over K x P paths (``solver: mppi``, K = 16, P = 8 antithetic) on a
  saved 192-unit checkpoint, the first solve of both ``mpc_fn``s in
  lockstep at ``tests/test_torch_mppi.py``'s tolerance (rtol 1e-5) on
  JAX's draws;
- the form choice of ``plan_particles`` on stub byte counts: the
  shared-memory form wherever any chunk fits, the global-weight form only
  past that, and an error naming the width and the bytes past both.

Weights are drawn with numpy from a seed and carried to the port with
``params_from_numpy``. ``test_global_forms_match_plain_on_cuda`` holds every
global-weight form against its plain twin on the card at 152 and 256 units
and the forced global-weight form bit for bit against the shared-memory
form at 128 units, and skips without a card.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_solve_lockstep, first_solve_pair, jax_solve_draws
from test_torch_wide_trunk import (G_ATOL, G_RTOL, H, SOLVE_ATOL, SOLVE_RTOL, VAL_RTOL,
                                   bundles, checkpoint, numpy_trunk, problem, traj_h6)
from sde4mbrl_px4_tpu.ops.pallas.apg_kernel import pallas_apg_solve
from sde4mbrl_px4_tpu.ops.pallas.solve_kernels import pallas_cost_oracle
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.engine import mpc_loader as L
from sde4mbrl_px4_tpu_torch.models.params_io import params_from_numpy
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import (P1_BY_SHAPE, P1_GLOBAL, P1_SMEM, ApgArgs,
                                                    plan_particles)
from sde4mbrl_px4_tpu_torch.p1_step_ab import forced
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig

T = torch.from_numpy


def plans(K: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(0.3, 0.95, (K, H, 4)).astype(np.float32)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Empty metric caches in ``tmp_path``."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(tmp_path / "precond"))


def test_oracle_matches_interpret_pallas_h160_p8_chunk4(repo_root, tmp_path):
    """The JAX package's particle oracle on a 160-unit trunk (its Pallas
    kernels in interpret mode, P = 8 in chunks of 4) against the port's
    oracle on the same draws: the TPU kernels take the width, and so does
    the port."""
    jb, tb = bundles(traj_h6(repo_root, checkpoint(repo_root, tmp_path, 160, seed=9)))
    assert tb.params["net"]["w1"].shape == (160, 160)
    x0, x_ref, u_prev, _ = problem(tb.cost_params.uref.numpy())
    noise = np.random.RandomState(8).standard_normal((8, H, 13)).astype(np.float32)
    pk = pallas_cost_oracle(jb.model, jb.params, jb.cost_params, jb.time_steps,
                            jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_prev),
                            jnp.asarray(noise), 8, maxls=4, interpret=True, chunk=4)
    launches = (CO.value_batch_kernel.launches, CO.value_and_grad_kernel.launches)
    port = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps, T(x0),
                          T(x_ref), T(u_prev), T(noise), 8, 4, chunk=4)
    U = plans(4, 16)
    np.testing.assert_allclose(port.value_batch(T(U)).numpy(),
                               np.asarray(pk.value_batch(jnp.asarray(U))), rtol=VAL_RTOL)
    v_t, g_t = port.value_and_grad(T(U[0]))
    v_p, g_p = pk.value_and_grad(jnp.asarray(U[0]))
    assert float(v_t) == pytest.approx(float(v_p), rel=VAL_RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_p), rtol=G_RTOL, atol=G_ATOL)
    assert launches == (CO.value_batch_kernel.launches, CO.value_and_grad_kernel.launches)


def test_whole_solve_matches_interpret_pallas_h160_p4(repo_root, tmp_path):
    """The JAX package's whole solve at P = 4 on a 160-unit trunk (its
    Pallas kernel in interpret mode) against the port's plain whole solve on
    the same draws at a fixed budget of 10 iterations."""
    jb, tb = bundles(traj_h6(repo_root, checkpoint(repo_root, tmp_path, 160, seed=4)))
    x0, x_ref, u_prev, u_init = problem(tb.cost_params.uref.numpy())
    noise = np.random.RandomState(4).standard_normal((4, H, 13)).astype(np.float32)
    apg = jb.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
    st_p = pallas_apg_solve(
        jb.model, jb.params, jb.cost_params, apg, jb.time_steps, jnp.asarray(x0),
        jnp.asarray(x_ref), jnp.asarray(u_prev), jnp.asarray(noise), 4, jb.lb, jb.ub,
        jnp.asarray(u_init), interpret=True)
    tapg = tb.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
    launches = AK.apg_solve_kernel.launches
    st_t, x_evol = AK.apg_solve_kernel(tb.model, tb.params, tb.cost_params, tapg,
                                       tb.time_steps, T(x0), T(x_ref), T(u_prev), T(noise), 4,
                                       tb.lb, tb.ub, T(u_init))
    assert AK.apg_solve_kernel.launches == launches        # CPU: the plain twin
    assert int(st_t.num_steps) == int(st_p.num_steps)
    np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_p.yk), rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL)
    assert float(st_t.opt_cost) == pytest.approx(float(st_p.opt_cost), rel=SOLVE_RTOL)
    assert x_evol.shape == (H + 1, 13) and bool(torch.isfinite(x_evol).all())


def test_mpc_fn_p8_antithetic_h192_lockstep_with_jax(repo_root, tmp_path, cache):
    """``mpc_fn`` at P = 8 antithetic on a saved 192-unit checkpoint, the
    port fed the JAX ``mpc_fn``'s own draws: its first solve in lockstep
    with the JAX package's; no launch on the CPU."""
    cfg = traj_h6(repo_root, checkpoint(repo_root, tmp_path, 192, seed=2), max_iter=8)
    cfg.update(num_particles=8, antithetic=True)
    counts = (AK.apg_solve_kernel.launches, CO.trajectory_kernel.launches)
    sol_j, sol_t, tb = first_solve_pair(cfg, jax_solve_draws(8, 1, True, H=H))
    assert tb.num_particles == 8 and tb.params["net"]["w1"].shape == (192, 192)
    assert torch.isfinite(sol_t.u_opt).all()
    assert_solve_lockstep(sol_j, sol_t, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    assert counts == (AK.apg_solve_kernel.launches, CO.trajectory_kernel.launches)


def test_mppi_p8_antithetic_h192_lockstep_with_jax(repo_root, tmp_path, cache):
    """MPPI over K x P paths on a saved 192-unit checkpoint (the particle
    ``value_batch``, its plain twin on the CPU, at H = 6): the first solve of
    the port's ``mpc_fn`` on the JAX ``mpc_fn``'s own draws (``split(rng,
    3)``: the block, MPPI's eps and c0) in lockstep with the JAX one's; no
    launch on the CPU."""
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=H, num_short_dt=H, solver="mppi", mppi={"samples": 16, "iters": 4},
               num_particles=8, antithetic=True,
               learned_model_params=checkpoint(repo_root, tmp_path, 192, seed=6))
    cfg["apg_mpc"].pop("precond", None)
    counts = (CO.value_batch_kernel.launches, CO.trajectory_kernel.launches)
    sol_j, sol_t, tb = first_solve_pair(
        cfg, jax_solve_draws(8, 1, True, mppi_cfg=MPPIConfig.from_config(cfg), H=H))
    assert tb.num_particles == 8 and tb.params["net"]["w1"].shape == (192, 192)
    assert torch.isfinite(sol_t.u_opt).all()
    np.testing.assert_allclose(sol_t.u_opt.numpy(), np.asarray(sol_j.u_opt), rtol=1e-5,
                               atol=1e-6)
    for f in ("init_cost", "opt_cost"):
        assert float(getattr(sol_t.opt_state, f)) == pytest.approx(
            float(getattr(sol_j.opt_state, f)), rel=1e-5), f
    for f in ("num_steps", "avg_linesearch"):
        assert float(getattr(sol_t.opt_state, f)) == float(getattr(sol_j.opt_state, f)), f
    np.testing.assert_allclose(sol_t.x_evol.numpy(), np.asarray(sol_j.x_evol), rtol=1e-4,
                               atol=1e-5)
    assert counts == (CO.value_batch_kernel.launches, CO.trajectory_kernel.launches)


class StubForms:
    """Shared-memory bytes of a particle block by form (``a.step``), as
    the libraries count them: the shared-memory form ``per_row`` bytes a
    chunk row plus the trunk and its transposes (``trunk``), the
    global-weight form the rows alone."""

    def __init__(self, trunk: int, per_row: int = 1000):
        self.trunk, self.per_row, self.asked = trunk, per_row, []

    def __call__(self, a) -> int:
        self.asked.append(a.step)
        rows = self.per_row * a.Pc
        return rows + (self.trunk if a.step == P1_SMEM else 0)


@pytest.mark.parametrize("trunk, want_form, want_pc", [
    (0, P1_SMEM, 32),            # narrow trunk: the largest chunk of the shared form
    (30_000, P1_SMEM, 8),        # a smaller chunk of the shared form still fits
    (39_500, P1_GLOBAL, 32),     # no chunk of it fits: the global-weight form
])
def test_plan_particles_takes_the_global_form_only_past_the_shared_one(trunk, want_form,
                                                                      want_pc):
    """The form choice (``consts.plan_particles``): every chunk of the
    shared-memory form first, the global-weight form only where none fits;
    the plan leaves ``step`` as it came (the libraries take the planned
    form by shape), and a form named there is planned alone."""
    need = StubForms(trunk)
    a = ApgArgs()
    a.step, a.HID, a.F = P1_BY_SHAPE, 256, 13
    plan_particles(a, 512, 0, need, 40_000, c_max=lambda form: 16 if form == P1_SMEM else 8)
    assert (a.Pc, a.n_chunks, a.step) == (want_pc, 512 // want_pc, P1_BY_SHAPE)
    assert a.cluster == min(512 // want_pc, 16 if want_form == P1_SMEM else 8)
    assert need.asked[-1] == want_form
    assert (P1_GLOBAL in need.asked) == (want_form == P1_GLOBAL)
    need.asked.clear()
    a.step = P1_GLOBAL
    plan_particles(a, 512, 0, need, 40_000)
    assert set(need.asked) == {P1_GLOBAL} and a.step == P1_GLOBAL and a.Pc == 32


def test_plan_particles_names_the_width_and_bytes_past_both_forms():
    a = ApgArgs()
    a.step, a.HID, a.F = P1_BY_SHAPE, 4096, 13
    with pytest.raises(ValueError, match=r"P=64 on a 4096-unit trunk \(F=13\) in chunks of 1 "
                                         r"needs 90000 bytes \(the shared-memory form\) or "
                                         r"50000 bytes \(the global-weight form\).*above the "
                                         r"40000-byte budget"):
        plan_particles(a, 64, 0, StubForms(40_000, per_row=50_000), 40_000)
    assert a.step == P1_BY_SHAPE


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [128, 152, 256])
def test_global_forms_match_plain_on_cuda(repo_root, hidden):
    """On the card, the iris traj config at H = 20, P = 128 antithetic, on a
    trunk of ``hidden`` units: at 152 and 256 units the whole solve takes its
    global-weight form by shape, and the oracle's, named in ``ApgArgs.step``
    (by shape ``value_batch`` keeps its shared-memory form to 224 units and
    ``value_and_grad`` to 152 at P = 128), each held to its plain twin (the
    whole solve at a fixed 5 iterations, rtol 2e-4 / atol 2e-5, equal steps;
    ``value_batch`` K = 1, 4 at 2e-5; ``value_and_grad`` 5e-4 / 5e-5); at 128
    units (the shared-memory forms' trunk) the global-weight forms, named in
    ``ApgArgs.step``, give the shared-memory forms' bits on the same chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the particle global-weight forms are CUDA kernels")
    import ctypes

    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian

    dev = torch.device("cuda")
    b = L.load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
                                device=dev)[3]
    tree = {"net": {k: v.cpu().numpy() for k, v in b.params["net"].items()}}
    params = {**b.params, "net": params_from_numpy(numpy_trunk(tree, hidden, 5)["net"], dev)}
    hz, P = int(b.time_steps.shape[0]), 128
    x0 = hover_state(dev)
    x0[0], x0[3] = 0.3, 0.2
    x_ref = hover_state(dev).expand(hz + 1, 13).contiguous()
    u_prev = b.cost_params.uref.clone()
    u_init = (u_prev.expand(hz, 4) + 0.02).contiguous()
    z = draw_brownian(torch.Generator().manual_seed(hidden), hz, P, True, dev).transpose(0, 1)
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    args = (b.model, params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev, z, P, b.lb,
            b.ub, u_init)
    oargs = (b.model, params, b.cost_params, b.time_steps, x0, x_ref, u_prev, z, P, 4)
    U = torch.from_numpy(np.random.RandomState(3).uniform(0.3, 0.95, (4, hz, 4)).astype(
        np.float32)).to(dev)
    _, a = build_consts(b.model, params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev,
                        b.lb, b.ub, particles=True)
    AK.plan_solve_particles(a, P, 0)
    form = AK.load_apg_library().apg_part_form(ctypes.byref(a))
    if hidden != 128:
        assert form == P1_GLOBAL
        n0 = (AK.apg_solve_kernel.launches_global, CO.value_batch_kernel.launches_global,
              CO.value_and_grad_kernel.launches_global)
        st_k, _ = AK.apg_solve_kernel(*args, precond=b.precond)
        torch.cuda.synchronize()
        st_p, _ = AK.apg_solve_plain(*args, precond=b.precond)
        assert int(st_k.num_steps) == int(st_p.num_steps)
        torch.testing.assert_close(st_k.yk, st_p.yk, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
        with forced(P1_GLOBAL):
            kern = CO.cost_oracle(*oargs)
        plain = CO.cost_oracle_plain(*oargs)
        for K in (1, 4):
            torch.testing.assert_close(kern.value_batch(U[:K]), plain.value_batch(U[:K]),
                                       rtol=VAL_RTOL, atol=0.0)
        (vk, gk), (vp, gp) = kern.value_and_grad(U[0]), plain.value_and_grad(U[0])
        torch.testing.assert_close(vk, vp, rtol=VAL_RTOL, atol=0.0)
        torch.testing.assert_close(gk, gp, rtol=G_RTOL, atol=G_ATOL)
        assert (AK.apg_solve_kernel.launches_global, CO.value_batch_kernel.launches_global,
                CO.value_and_grad_kernel.launches_global) == (n0[0] + 1, n0[1] + 2, n0[2] + 1)
        return
    assert form == P1_SMEM
    res = {}
    for step in (P1_SMEM, P1_GLOBAL):
        with forced(step):
            st, _ = AK.apg_solve_kernel(*args, precond=b.precond, chunk=a.Pc)
            o = CO.cost_oracle(*oargs, chunk=a.Pc)
            res[step] = (st.yk, st.num_steps, o.value_batch(U[:1]), o.value_batch(U),
                         *o.value_and_grad(U[0]))
    assert all(torch.equal(p, q) for p, q in zip(res[P1_SMEM], res[P1_GLOBAL]))
