"""Port parity, Monte-Carlo particles: the noise branch and the particle
chunks (K11) of the cost oracle and the whole solve, on the CPU (the plain
versions), against the JAX package on the same Brownian draws.

- ``draw_brownian``: one generator call, antithetic halves exact negatives,
  an odd antithetic P refused;
- the chunk a particle launch takes (``plan_particles``), its cluster
  (``plan_cluster``: every chunk swept by one block) and the ``ApgArgs``
  mirror of the kernels' header;
- the plain oracle at P=4 against ``pallas_cost_oracle`` in interpret mode
  and the XLA oracle (``tests/test_pallas_kernels.py:98-104``): values rtol
  2e-5, gradients rtol 5e-4 / atol 5e-5;
- P=8 with ``chunk=4`` against the chunked interpret oracle at 2e-5
  (``:184-214``);
- ``apg_solve_plain`` at P=4 and the fixed-step ``apg_solve`` at P=4 in
  lockstep with the JAX XLA ``apg_solve`` (equal ``num_steps``, rtol 5e-4 /
  atol 5e-5, ``tests/test_apg_kernel.py:100-105``);
- ``mpc_fn`` at P=8 antithetic over 3 chained solves with the JAX
  ``mpc_fn``'s own draws injected, against the JAX ``mpc_fn``;
- ``replay_solver_family("p512anti")`` against
  ``tests/goldens/family_p512anti_trace.npz`` at its tolerance, 5e-4
  (``tests/test_goldens_flagship.py:127``), with JAX's draws injected;
- the controller draws each solve's block from its generator once.

JAX's draws reach the port as numpy arrays through ``mpc_fn``'s ``rng`` (an
iterator of (P, H, 13) blocks); the weights are the committed checkpoint on
both sides.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import H, assert_lockstep, load_port_bundles, problem
from sde4mbrl_px4_tpu.core.frames import enu2ned as j_enu2ned
from sde4mbrl_px4_tpu.cost.cost import make_cost_fn
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.pallas.solve_kernels import pallas_cost_oracle
from sde4mbrl_px4_tpu.ops.rollout import draw_brownian as j_draw_brownian
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean as j_rollout_mean
from sde4mbrl_px4_tpu.ops.rollout import rollout_sde
from sde4mbrl_px4_tpu.solver.apg import CostOracle as JaxOracle
from sde4mbrl_px4_tpu.solver.apg import apg_solve as j_apg_solve
from sde4mbrl_px4_tpu_torch.engine import goldens as G
from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian
from sde4mbrl_px4_tpu_torch.solver.apg import apg_solve

VAL_RTOL, G_RTOL, G_ATOL = 2e-5, 5e-4, 5e-5
SOLVE_RTOL, SOLVE_ATOL = 5e-4, 5e-5
T = torch.from_numpy


def plans(K, seed, n=4):
    return np.random.RandomState(seed).uniform(0.3, 0.95, (K, H, n)).astype(np.float32)


def kernel_layout(noise_hp):
    """(H, P, 13) draws -> the kernels' (P, H, 13) layout, as numpy."""
    return np.ascontiguousarray(np.asarray(noise_hp, np.float32).transpose(1, 0, 2))


def jax_brownian_draws(P, n_solves, antithetic):
    """Each solve's Brownian block as the JAX ``mpc_fn`` draws it from
    PRNGKey(0) (``engine/mpc_loader.py:664``, ``:721-724``): ``(noise,
    next) = split(rng)``, ``draw_brownian(noise, H, P, antithetic)``, in the
    kernels' (P, H, 13) layout."""
    rng = jax.random.PRNGKey(0)
    for _ in range(n_solves):
        rng_noise, rng = jax.random.split(rng)
        yield T(kernel_layout(j_draw_brownian(rng_noise, H, P, antithetic=antithetic)))


def xla_particle_oracle(b, x0, x_ref, u_prev, key, P):
    """The JAX package's XLA oracle at P particles drawn from ``key``."""
    cost_fn = make_cost_fn(b.cost_params, b.time_steps)

    def seq_cost(u):
        xp, sg = rollout_sde(b.model, b.params, jnp.asarray(x0), u, b.time_steps, key, P)
        return cost_fn(xp, sg, u, jnp.asarray(x_ref), jnp.asarray(u_prev))

    return JaxOracle.from_fn(seq_cost), seq_cost


def test_draw_brownian_structure():
    """One generator call; antithetic halves are exact negatives; odd P with
    antithetic is refused."""
    z = draw_brownian(torch.Generator().manual_seed(3), H, 6)
    assert z.shape == (H, 6, 13) and z.dtype == torch.float32
    ref = torch.randn((H, 6, 13), generator=torch.Generator().manual_seed(3))
    assert torch.equal(z, ref)
    za = draw_brownian(torch.Generator().manual_seed(3), H, 6, antithetic=True)
    assert za.shape == (H, 6, 13)
    assert torch.equal(za[:, 3:], -za[:, :3])
    assert torch.equal(za[:, :3], torch.randn((H, 3, 13),
                                              generator=torch.Generator().manual_seed(3)))
    with pytest.raises(ValueError, match="even particle count"):
        draw_brownian(torch.Generator(), H, 7, antithetic=True)


def test_plan_particles_chunk_choice():
    """The chunk of a particle launch: the resolved ``chunk`` when given,
    else the largest divisor of P whose shared memory fits; nothing fitting
    raises."""
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import ApgArgs, plan_particles

    def need(a):                      # bytes grow with the chunk's rows
        return 1000 * a.Pc

    a = ApgArgs()
    plan_particles(a, 512, 0, need, 40_000)
    assert (a.P, a.Pc, a.n_chunks, a.has_noise) == (512, 32, 16, 1)
    assert (a.cluster, a.chunks_per_block) == (1, 16)          # c_max defaults to 1
    plan_particles(a, 512, 0, need, 40_000, c_max=16)
    assert (a.Pc, a.n_chunks, a.cluster, a.chunks_per_block) == (32, 16, 16, 1)
    plan_particles(a, 1024, 0, need, 40_000, c_max=8)
    assert (a.Pc, a.n_chunks, a.cluster, a.chunks_per_block) == (32, 32, 8, 4)
    plan_particles(a, 24, 0, need, 40_000)
    assert (a.Pc, a.n_chunks) == (24, 1)
    plan_particles(a, 64, 16, need, 40_000)
    assert (a.Pc, a.n_chunks) == (16, 4)
    with pytest.raises(ValueError, match="above the 20000-byte budget"):
        plan_particles(a, 64, 32, need, 20_000)
    with pytest.raises(ValueError, match="above the 500-byte budget"):
        plan_particles(a, 7, 0, need, 500)


@pytest.mark.parametrize("c_max", [8, 16])
@pytest.mark.parametrize("n_chunks", [1, 3, 4, 16, 32])
def test_plan_cluster_covers_every_chunk_once(n_chunks, c_max):
    """The cluster of a particle launch: C = min(n_chunks, C_max) blocks,
    the grid one cluster of C; block ``rank`` sweeps chunks rank, rank + C,
    ... (the device loop of ``csrc/sweeps.cuh::vg_part`` / ``cand_part``),
    so every chunk has exactly one block, every block at least one chunk,
    and none more than ``chunks_per_block``."""
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import plan_cluster

    def cluster_chunks(rank):
        return range(rank, n_chunks, C)

    C, cpb = plan_cluster(n_chunks, c_max)
    assert C == min(n_chunks, c_max)
    grid = C                              # one cluster per launch
    assert grid % C == 0
    owner = {}
    for rank in range(C):
        mine = list(cluster_chunks(rank))
        assert 1 <= len(mine) <= cpb
        for ch in mine:
            assert ch not in owner
            owner[ch] = rank
    assert sorted(owner) == list(range(n_chunks))
    assert cpb == max(len(cluster_chunks(r)) for r in range(C))
    with pytest.raises(ValueError):
        plan_cluster(n_chunks, 0)


def test_apg_args_mirror_the_header():
    """``consts.ApgArgs`` mirrors ``csrc/apg_solve.cuh::ApgArgs`` field for
    field, the cluster fields last; every field is 4 bytes, so the size is
    4 bytes per field (the launchers' ``*_args_size()`` checks the same on
    the card). The constants of ``csrc/cost_oracle.cuh`` (which kernel a
    query is for, the candidate rows of a P=1 ``value_batch`` block) are
    mirrored too."""
    import ctypes
    import re

    from sde4mbrl_px4_tpu_torch.ops.cuda import consts
    from sde4mbrl_px4_tpu_torch.ops.cuda.build import CSRC
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import APG_MAXK, ApgArgs

    oracle = (CSRC / "cost_oracle.cuh").read_text()
    defines = dict(re.findall(r"#define (ORACLE_\w+) (\w+)", oracle))
    assert defines["ORACLE_P1_ROWS"] == "APG_MAXK" and consts.ORACLE_P1_ROWS == APG_MAXK
    assert int(defines["ORACLE_TILE"]) == consts.ORACLE_TILE
    kinds = re.search(r"enum \{ (ORACLE_VALUE_BATCH.*?) \};", oracle).group(1)
    for name, value in re.findall(r"(ORACLE_\w+) = (\d+)", kinds):
        assert getattr(consts, name) == int(value)
    apg = (CSRC / "apg_solve.cuh").read_text()
    assert int(re.search(r"#define APG_MAXK (\d+)", apg).group(1)) == APG_MAXK

    text = (CSRC / "apg_solve.cuh").read_text()
    body = re.search(r"struct ApgArgs \{(.*?)\};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    header = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            header += [n.strip().split("[")[0] for n in decl.split(None, 1)[1].split(",")]
    python = [name for name, _ in ApgArgs._fields_]
    assert python == header
    assert python[-3:] == ["cluster", "chunks_per_block", "groups"]
    assert ctypes.sizeof(ApgArgs) == 4 * (len(python) - 1 + APG_MAXK + 1)
    a = ApgArgs()
    assert (a.cluster, a.chunks_per_block, a.groups) == (0, 0, 0)


@pytest.mark.parametrize("P, chunk, want", [(64, 16, 16), (16, 16, 0), (8, 16, None),
                                            (64, 12, None), (1, 0, 0)])
def test_resolve_particles_checks_the_chunk(P, chunk, want):
    """The one wrapper-level chunk check (``solve_kernels.py:221-224``): the
    chunk must divide P, and ``P <= chunk`` turns it off."""
    if want is None:
        with pytest.raises(ValueError, match="must divide"):
            CO.resolve_particles(None, P, True, chunk, H, torch.device("cpu"))
        return
    assert CO.resolve_particles(None, P, True, chunk, H, torch.device("cpu")) == (P, None, want)


@pytest.fixture(scope="module")
def p4(repo_root, iris_traj_bundle):
    """P=4 on the traj config: (xla, pallas-interpret, port, problem)."""
    b = iris_traj_bundle[3]
    tb = load_port_bundles(repo_root)["iris_traj_mpc"]
    x0, x_ref, u_prev, u_init = problem(b.cost_params.uref)
    key = jax.random.PRNGKey(11)
    noise = kernel_layout(j_draw_brownian(key, H, 4))
    xla, _ = xla_particle_oracle(b, x0, x_ref, u_prev, key, 4)
    pk = pallas_cost_oracle(
        b.model, b.params, b.cost_params, b.time_steps, jnp.asarray(x0),
        jnp.asarray(x_ref), jnp.asarray(u_prev), jnp.asarray(noise), 4, maxls=4,
        interpret=True)
    port = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps, T(x0),
                          T(x_ref), T(u_prev), T(noise), 4, 4)
    return xla, pk, port, (x0, x_ref, u_prev, u_init, key, noise)


def test_particle_value_matches_jax(p4):
    xla, pk, port, _ = p4
    u = plans(1, 3)[0]
    n0 = CO.value_batch_kernel.launches
    v = float(port.value(T(u)))
    assert CO.value_batch_kernel.launches == n0          # CPU: plain version
    assert v == pytest.approx(float(xla.value(jnp.asarray(u))), rel=VAL_RTOL)
    assert v == pytest.approx(float(pk.value(jnp.asarray(u))), rel=VAL_RTOL)


def test_particle_value_batch_matches_jax(p4):
    xla, pk, port, _ = p4
    U = plans(3, 21)
    v = port.value_batch(T(U)).numpy()
    assert v.shape == (3,)
    np.testing.assert_allclose(v, np.asarray(xla.value_batch(jnp.asarray(U))), rtol=VAL_RTOL)
    np.testing.assert_allclose(v, np.asarray(pk.value_batch(jnp.asarray(U))), rtol=VAL_RTOL)


def test_particle_value_and_grad_matches_jax(p4):
    xla, pk, port, _ = p4
    u = plans(1, 7)[0]
    v, g = port.value_and_grad(T(u))
    for ref in (xla, pk):
        v_r, g_r = ref.value_and_grad(jnp.asarray(u))
        assert float(v) == pytest.approx(float(v_r), rel=VAL_RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=G_RTOL, atol=G_ATOL)


def test_chunked_particles_match_jax_chunked(repo_root, iris_traj_bundle):
    """P=8 in chunks of 4 (numpy draws): the port's oracle against the JAX
    package's chunked interpret-mode oracle; the plain version takes the
    unchunked mean, which the chunked one equals in exact arithmetic."""
    b = iris_traj_bundle[3]
    tb = load_port_bundles(repo_root)["iris_traj_mpc"]
    x0, x_ref, u_prev, _ = problem(b.cost_params.uref)
    noise = np.random.RandomState(2).standard_normal((8, H, 13)).astype(np.float32)
    chunked = pallas_cost_oracle(
        b.model, b.params, b.cost_params, b.time_steps, jnp.asarray(x0),
        jnp.asarray(x_ref), jnp.asarray(u_prev), jnp.asarray(noise), 8, maxls=4,
        interpret=True, chunk=4)
    port = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps, T(x0),
                          T(x_ref), T(u_prev), T(noise), 8, 4, chunk=4)
    u = plans(1, 17)[0]
    assert float(port.value(T(u))) == pytest.approx(float(chunked.value(jnp.asarray(u))),
                                                    rel=VAL_RTOL)
    U = plans(3, 5)
    np.testing.assert_allclose(port.value_batch(T(U)).numpy(),
                               np.asarray(chunked.value_batch(jnp.asarray(U))), rtol=VAL_RTOL)
    v, g = port.value_and_grad(T(u))
    v_c, g_c = chunked.value_and_grad(jnp.asarray(u))
    assert float(v) == pytest.approx(float(v_c), rel=VAL_RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_c), rtol=G_RTOL, atol=G_ATOL)


@pytest.fixture(scope="module")
def p64_chunk16(repo_root, iris_pos_bundle):
    """P=64 in chunks of 16 on the posctrl config (numpy draws): the port's
    oracle and the JAX package's chunked interpret-mode oracle."""
    b = iris_pos_bundle[3]
    tb = load_port_bundles(repo_root)["iris_posctrl_mpc"]
    x0, x_ref, u_prev, _ = problem(b.cost_params.uref)
    noise = np.random.RandomState(64).standard_normal((64, H, 13)).astype(np.float32)
    chunked = pallas_cost_oracle(
        b.model, b.params, b.cost_params, b.time_steps, jnp.asarray(x0),
        jnp.asarray(x_ref), jnp.asarray(u_prev), jnp.asarray(noise), 64, maxls=4,
        interpret=True, chunk=16)
    port = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps, T(x0),
                          T(x_ref), T(u_prev), T(noise), 64, 4, chunk=16)
    return chunked, port


@pytest.mark.parametrize("K", [1, 4])
def test_p64_chunks_of_16_value_batch_matches_jax(p64_chunk16, K):
    """``value_batch`` at P=64 in 4 chunks of 16 (on the card a cluster of 4
    blocks per candidate) against the chunked interpret-mode oracle."""
    chunked, port = p64_chunk16
    U = plans(K, 64 + K)
    v = port.value_batch(T(U)).numpy()
    assert v.shape == (K,)
    np.testing.assert_allclose(v, np.asarray(chunked.value_batch(jnp.asarray(U))), rtol=VAL_RTOL)


def test_particle_solve_lockstep_with_xla(p4, repo_root, iris_traj_bundle):
    """``apg_solve_plain`` at P=4, max_iter=5 (the traj config's BB
    linesearch), in lockstep with the JAX XLA ``apg_solve`` over the same
    draws; ``x_evol`` is the mean rollout of the plan."""
    _, _, _, (x0, x_ref, u_prev, u_init, key, noise) = p4
    b = iris_traj_bundle[3]
    tb = load_port_bundles(repo_root)["iris_traj_mpc"]
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    _, seq_cost = xla_particle_oracle(b, x0, x_ref, u_prev, key, 4)
    st_x = j_apg_solve(seq_cost, jnp.asarray(u_init), b.lb, b.ub, apg)
    tapg = tb.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    n0 = AK.apg_solve_kernel.launches
    st_t, x_evol = AK.apg_solve_kernel(
        tb.model, tb.params, tb.cost_params, tapg, tb.time_steps, T(x0), T(x_ref),
        T(u_prev), T(noise), 4, tb.lb, tb.ub, T(u_init))
    assert AK.apg_solve_kernel.launches == n0
    assert_lockstep(st_x, st_t, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    ref = j_rollout_mean(b.model, b.params, jnp.asarray(x0), jnp.asarray(st_t.yk.numpy()),
                         b.time_steps)
    assert x_evol.shape == (H + 1, 13)
    np.testing.assert_allclose(x_evol.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fixed_step_particles_lockstep(repo_root, iris_pos_bundle):
    """Fixed-step APG (posctrl without its linesearch block, stepsize 1e-5)
    at P=4 over the plain particle oracle, in lockstep with the JAX
    ``apg_solve`` on the same draws."""
    b = iris_pos_bundle[3]
    tb = load_port_bundles(repo_root)["iris_posctrl_mpc"]
    x0, x_ref, u_prev, u_init = problem(b.cost_params.uref)
    key = jax.random.PRNGKey(4)
    noise = kernel_layout(j_draw_brownian(key, H, 4))
    _, seq_cost = xla_particle_oracle(b, x0, x_ref, u_prev, key, 4)
    kw = dict(use_linesearch=False, stepsize=1e-5, max_iter=10, max_no_improvement_iter=10)
    st_x = j_apg_solve(seq_cost, jnp.asarray(u_init), b.lb, b.ub, b.apg_config._replace(**kw))
    oracle = CO.cost_oracle(tb.model, tb.params, tb.cost_params, tb.time_steps, T(x0),
                            T(x_ref), T(u_prev), T(noise), 4, 4)
    with torch.no_grad():
        st_t = apg_solve(oracle, T(u_init), tb.lb, tb.ub, tb.apg_config._replace(**kw))
    assert_lockstep(st_x, st_t, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    assert float(st_t.opt_cost) < float(st_t.init_cost)


def _p8_config(repo_root):
    cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg.update(num_particles=8, antithetic=True)
    cfg["apg_mpc"].update(max_iter=6, max_no_improvement_iter=6)
    return cfg


def test_mpc_fn_p8_antithetic_lockstep_with_jax(repo_root):
    """Three chained traj solves at P=8 antithetic through both ``mpc_fn``s,
    the port fed the JAX ``mpc_fn``'s own draws; no launch on the CPU."""
    cfg = _p8_config(repo_root)
    jcfg, (j_reset, j_mpc), j_sft, jb = j_make(copy.deepcopy(cfg))
    tcfg, (t_reset, t_mpc), t_sft, tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    assert tb.num_particles == 8 and tb.precond is not None
    xj = j_enu2ned(j_sft(jnp.float32(3.0)))
    xt = T(np.array(xj))
    rng = jax.random.PRNGKey(0)
    draws = jax_brownian_draws(8, 3, antithetic=True)
    st_j, st_t = j_reset(xj, rng, xj), t_reset(xt, draws, xt)
    jm = jax.jit(j_mpc)
    counts = (AK.apg_solve_kernel.launches, CO.trajectory_kernel.launches)
    for k in range(3):
        t = np.float32(3.0 + 0.05 * k)
        u_j, st_j, rng, xe_j = jm(xj, rng, st_j, jnp.float32(t), xj)
        u_t, st_t, draws, xe_t = t_mpc(xt, draws, st_t, t, xt)
        assert int(st_t.num_steps) == int(st_j.num_steps)
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL)
        assert float(st_t.opt_cost) == pytest.approx(float(st_j.opt_cost), rel=SOLVE_RTOL)
        # x_evol: the mean rollout of the port's own plan, and as close to
        # the JAX one as the plans are to each other
        ref = j_rollout_mean(jb.model, jb.params, jnp.asarray(xt.numpy()),
                             jnp.asarray(u_t.numpy()), jb.time_steps)
        np.testing.assert_allclose(xe_t.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(xe_t.numpy(), np.asarray(xe_j), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL)
        xj, xt = xe_j[1], xe_t[1]
    assert counts == (AK.apg_solve_kernel.launches, CO.trajectory_kernel.launches)


def test_family_p512anti_replays_golden(repo_root):
    """The solver-family golden (P=512 antithetic, 4 solves of at most 6
    iterations along the lemniscate), with the JAX package's draws."""
    tr = G.replay_solver_family(repo_root, "p512anti", device="cpu",
                                draws=jax_brownian_draws(512, 4, antithetic=True))
    ref = np.load(os.path.join(G.golden_dir(repo_root), "family_p512anti_trace.npz"))["trace"]
    assert tr.shape == ref.shape
    np.testing.assert_array_equal(tr[:, -1], ref[:, -1])
    np.testing.assert_allclose(tr, ref, atol=5e-4, rtol=5e-4)


def test_controller_draws_once_per_solve(repo_root, tmp_path):
    """A P=8 traj config flown by the controller: each traj solve draws its
    block from ``rng_traj`` in one call (H * P/2 * 13 normals, antithetic)."""
    from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES, hover_state
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg.update(num_particles=8, antithetic=True)
    cfg["apg_mpc"].update(max_iter=2, max_no_improvement_iter=2)
    path = tmp_path / "iris_traj_p8.yaml"
    path.write_text(yaml.safe_dump({k: v for k, v in cfg.items() if not k.startswith("_")}))
    c = RecedingHorizonController(str(path),
                                  os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"),
                                  seed=0, now_fn=lambda: 0.0, device="cpu")
    ref = torch.Generator().manual_seed(0)
    x = hover_state().numpy()
    for k in range(2):
        rec = c.solve_once(x, CONTROL_STATES["traj"], 0.5 + 0.05 * k, x, 1e6 + k * 5e4)
        assert rec.num_steps == 2
        torch.randn(H * 4 * 13, generator=ref)           # one draw per solve
        assert torch.equal(c.rng_traj.get_state(), ref.get_state())
