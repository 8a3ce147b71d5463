"""Port parity, reduced matmul precision (``matmul_precision``), on the CPU
against the JAX package.

The JAX package's ``default``/``bf16``/``bfloat16`` precision is its TPU's
DEFAULT dot: bf16 inputs, fp32 sums, on the routes its loader sends to XLA
(``engine/mpc_loader.py:320-350``, ``:432-445``); its Pallas kernels run at
HIGHEST. On the CPU XLA ignores DEFAULT, so the JAX side here runs under a
test-side emulator of the TPU's DEFAULT (:func:`tpu_default`): a
monkeypatched ``jax.lax.dot_general`` that rounds both operands of a DEFAULT
dot to bf16 and, through a ``jax.custom_vjp``, those of its transposed
dots too. The JAX package itself is unchanged.

- ``resolve_precision`` accepts and refuses the JAX package's names, with
  its ``ValueError``;
- the port's bf16 trunk (``trunk_apply(..., bf16=True)``) and its VJP with
  respect to x and u against JAX's ``trunk_apply(precision=DEFAULT)`` on
  the shipped iris checkpoint at full width, within 2e-6 of each output's
  largest entry (the sums' order moves the last fp32 bits; no bf16 tie
  flips at these inputs), and each at least 10x that away from fp32;
- the routing table: per config, the port's ``trunk_bf16`` with
  ``default_rounds_to_bf16`` patched to the card's answer, and its first
  plain solve against the JAX package's first solve (``use_pallas=
  "interpret"``: the TPU's routes) on the same draws. Plans within 1e-6
  (MPPI's within 8e-6: its softmax weights amplify the costs' last fp32
  bits), ``x_evol`` within 1e-5 and costs within 1e-6 relative: tighter
  than the reference's fixed-budget 2e-4 / 2e-5, which is wider than the
  bf16 trunk's whole effect on a 3-iteration plan at H = 4 (~2e-5). The
  port's other precision (fp32 where the route is bf16, bf16 where it is
  fp32) lies outside a tolerance and more than 10x farther from the JAX
  solve than the port's own, so the check sees the rounding.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.core.types import hover_state as j_hover
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.models import sde_model as jsde
from sde4mbrl_px4_tpu.models.params_io import load_params as j_load_params
from sde4mbrl_px4_tpu_torch.engine import mpc_loader as tloader
from sde4mbrl_px4_tpu_torch.models import sde_model as tsde
from sde4mbrl_px4_tpu_torch.models.params_io import load_params, params_from_numpy
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig

from _torch_parity import jax_solve_draws

_DOT = jax.lax.dot_general
_DEFAULT, _HIGHEST = jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST
H = 4
# the routed first solves: plans (MPPI's: tests/test_torch_mppi.py's
# lockstep atol 1e-6 plus rtol 1e-5 of a 0.7 plan), x_evol, costs (module
# docstring)
U_ATOL, U_ATOL_MPPI, X_ATOL, COST_RTOL = 1e-6, 8e-6, 1e-5, 1e-6
# the trunk and its VJP: a share of each output's largest entry
TRUNK_TOL = 2e-6


def _rnd(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _dot(a, b, dims):
    return _DOT(a, b, dims, precision=_HIGHEST, preferred_element_type=jnp.float32)


@jax.custom_vjp
def _tpu_dot(h, w):
    """``h (..., k) @ w (k, n)`` as the TPU's DEFAULT computes it: both
    operands rounded to bf16, fp32 sums."""
    return _dot(_rnd(h), _rnd(w), (((h.ndim - 1,), (0,)), ((), ())))


def _tpu_dot_fwd(h, w):
    return _tpu_dot(h, w), (h, w)


def _tpu_dot_bwd(res, g):
    """The transposed dots at the forward's precision (JAX's transpose
    rule): their operands rounded too."""
    h, w = res
    g = _rnd(g)
    lead = tuple(range(h.ndim - 1))
    return (_dot(g, _rnd(w), (((g.ndim - 1,), (1,)), ((), ()))),
            _dot(_rnd(h), g, ((lead, lead), ((), ()))))


_tpu_dot.defvjp(_tpu_dot_fwd, _tpu_dot_bwd)


def _emulated_dot_general(lhs, rhs, dimension_numbers, precision=None,
                          preferred_element_type=None, **kw):
    if precision == _DEFAULT:
        (lc, rc), (lb, rb) = dimension_numbers
        assert tuple(lc) == (lhs.ndim - 1,) and tuple(rc) == (0,) and not lb and not rb
        return _tpu_dot(lhs, rhs)
    return _DOT(lhs, rhs, dimension_numbers, precision=precision,
                preferred_element_type=preferred_element_type, **kw)


@pytest.fixture
def tpu_default(monkeypatch):
    """The JAX package's DEFAULT dots computed as on its TPU."""
    monkeypatch.setattr(jax.lax, "dot_general", _emulated_dot_general)


@pytest.mark.parametrize("name", [None, "highest", "float32", "HIGHEST", "default", "bf16",
                                  "bfloat16", "BF16", "high", "fp16", "tf32", ""])
def test_resolve_precision_names_match_jax(name):
    """The port's copy of ``resolve_precision`` takes the JAX package's
    names (DEFAULT is True) and refuses the others with its ``ValueError``."""
    try:
        want = jsde.resolve_precision(name) == _DEFAULT
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsde.resolve_precision(name)
        assert str(got.value) == str(e)
        return
    assert tsde.resolve_precision(name) is want


@pytest.fixture(scope="module")
def iris_params(repo_root):
    path = os.path.join(repo_root, "configs/models/iris_sde.pkl")
    tree, _ = load_params(path)
    jtree, _ = j_load_params(path)
    return params_from_numpy(tree, "cpu"), jax.tree_util.tree_map(jnp.asarray, jtree)


def _trunk_inputs(P=256, seed=0):
    rs = np.random.default_rng(seed)
    x = (rs.normal(size=(P, 13)) * 0.5).astype(np.float32)
    q = rs.normal(size=(P, 4))
    x[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    u = rs.uniform(0.3, 0.8, size=(P, 4)).astype(np.float32)
    g = rs.normal(size=(2, P, 6)).astype(np.float32)
    return x, u, g


def _port_trunk(tparams, x, u, g, bf16):
    xt = torch.tensor(x, requires_grad=True)
    ut = torch.tensor(u, requires_grad=True)
    res, sig = tsde.trunk_apply(tparams, xt, ut, bf16=bf16)
    gx, gu = torch.autograd.grad([res, sig], [xt, ut], [torch.tensor(g[0]), torch.tensor(g[1])])
    return [t.detach().numpy() for t in (res, sig, gx, gu)]


def test_bf16_trunk_and_vjp_match_jax_default(iris_params, tpu_default):
    """The port's bf16 trunk forward and its VJP with respect to x and u
    against JAX's ``trunk_apply(precision=DEFAULT)`` under the emulator, on
    the shipped iris checkpoint (13 -> 64 -> 64 -> 12) at 256 random states;
    each differs from the fp32 trunk by more than 10x the tolerance."""
    tparams, jparams = iris_params
    x, u, g = _trunk_inputs()
    (res, sig), vjp = jax.vjp(
        lambda x, u: jsde.trunk_apply(jparams, x, u, precision=_DEFAULT), jnp.asarray(x),
        jnp.asarray(u))
    ref = [np.asarray(v) for v in (res, sig, *vjp((jnp.asarray(g[0]), jnp.asarray(g[1]))))]
    got = _port_trunk(tparams, x, u, g, bf16=True)
    f32 = _port_trunk(tparams, x, u, g, bf16=False)
    for name, r, a, b in zip(("res", "sig", "d/dx", "d/du"), ref, got, f32):
        tol = TRUNK_TOL * float(np.abs(r).max())
        np.testing.assert_allclose(a, r, rtol=0, atol=tol, err_msg=name)
        assert float(np.abs(b - r).max()) > 10 * tol, name


def test_bf16_trunk_backward_rounds_its_operands(iris_params):
    """``Bf16Matmul``'s backward is the TPU's transpose (rounded cotangent
    and weights), not autograd through the rounding (which would round the
    products' results), and it runs under ``torch.func.vmap``."""
    tparams, _ = iris_params
    rs = np.random.default_rng(1)
    h = torch.tensor(rs.normal(size=(5, 64)).astype(np.float32), requires_grad=True)
    w = tparams["net"]["w1"].clone().requires_grad_(True)
    g = torch.tensor(rs.normal(size=(5, 64)).astype(np.float32))
    out = tsde.Bf16Matmul.apply(h, w)
    gh, gw = torch.autograd.grad(out, [h, w], g)
    r = tsde.round_bf16
    torch.testing.assert_close(out, r(h) @ r(w), rtol=0, atol=0)
    torch.testing.assert_close(gh, r(g) @ r(w).T, rtol=0, atol=0)
    torch.testing.assert_close(gw, r(h).T @ r(g), rtol=0, atol=0)
    assert not torch.equal(gh, r(g @ r(w).T))
    batched = torch.func.vmap(lambda hh: tsde.Bf16Matmul.apply(hh, w))(h.detach()[:, None])
    torch.testing.assert_close(batched[:, 0], out.detach(), rtol=0, atol=0)


def _cfg(repo_root, name="iris_posctrl_mpc", **mut):
    """A shipped config at H = 4 and 3 iterations (the policy's at its
    checkpoint's H = 20), with ``mut``: top-level keys, ``cost.<key>`` into
    ``cost_params``."""
    cfg = j_load_yaml(os.path.join(repo_root, f"configs/{name}.yaml"))
    if mut.get("solver") != "policy":
        cfg.update(horizon=H, num_short_dt=H)
    cfg["apg_mpc"].update(max_iter=3, max_no_improvement_iter=3)
    for key, val in mut.items():
        if key.startswith("cost."):
            cfg["cost_params"][key[5:]] = val
        elif key == "linesearch":
            del cfg["apg_mpc"]["linesearch"]
            cfg["apg_mpc"]["stepsize"] = 1e-4
        else:
            cfg[key] = val
    return cfg


# MPPI at its default knobs and 8 rounds (over which the rounding's effect
# on the plan grows well past the fp32 order effects)
_MPPI8, _MPPI160 = {"samples": 8, "iters": 8}, {"samples": 160, "iters": 8}
# (case, mutation, the port's trunk_bf16 on the card), the section-1 table:
# the original's route on its TPU (engine/mpc_loader.py:320-350, :432-445)
ROUTES = [
    ("apg P=1 default: Pallas", dict(matmul_precision="default"), False),
    ("apg P=8 bf16: Pallas", dict(num_particles=8, antithetic=True,
                                  matmul_precision="bf16"), False),
    ("apg P=160: XLA, DEFAULT above 128", dict(num_particles=160, antithetic=True), True),
    ("apg P=160 highest: XLA, fp32", dict(num_particles=160, antithetic=True,
                                         matmul_precision="highest"), False),
    ("apg P=160 pallas_chunk: Pallas", dict(num_particles=160, antithetic=True,
                                            pallas_chunk=80), False),
    ("fixed step P=1 default: Pallas", dict(matmul_precision="default", linesearch=None), False),
    ("fixed step P=160: XLA", dict(num_particles=160, antithetic=True, linesearch=None), True),
    ("risk P=8: XLA, HIGHEST at P <= 128", {"num_particles": 8, "antithetic": True,
                                            "cost.risk_lambda": 1.0}, False),
    ("risk P=8 bf16: XLA", {"num_particles": 8, "antithetic": True, "cost.risk_lambda": 1.0,
                            "matmul_precision": "bf16"}, True),
    ("starts P=8 bfloat16: XLA", dict(num_particles=8, antithetic=True, initial_state_std=0.05,
                                      matmul_precision="bfloat16"), True),
    ("mppi P=1 K=8 bf16: Pallas", dict(solver="mppi", mppi=_MPPI8, matmul_precision="bf16"),
     False),
    ("mppi P=1 K=160 bf16: XLA", dict(solver="mppi", mppi=_MPPI160,
                                      matmul_precision="bf16"), True),
    ("mppi P=1 K=160: XLA, HIGHEST at P=1", dict(solver="mppi",
                                                 mppi=_MPPI160), False),
    ("mppi P=4 K=8 default: XLA", dict(solver="mppi", mppi=_MPPI8, num_particles=4,
                                       antithetic=True, matmul_precision="default"), True),
]


def _policy(repo_root, refine):
    return dict(solver="policy", matmul_precision="bf16",
                policy={"params_path": os.path.join(repo_root,
                                                    "configs/models/iris_posctrl_policy.pkl"),
                        "refine_iters": refine})


def _first_solves(cfg, card_bf16):
    """The JAX package's first solve (its TPU's routes, ``use_pallas=
    "interpret"``) and the port's plain one on the same draws, the port's
    ``default_rounds_to_bf16`` giving ``card_bf16``: (JAX's, the port's,
    the port's ``trunk_bf16``)."""
    P = int(cfg.get("num_particles", 1))
    mppi = cfg.get("solver") == "mppi"
    _, (j_reset, j_mpc), _, _ = j_make(copy.deepcopy(cfg), use_pallas="interpret")
    x = j_hover().at[0].set(0.5).at[2].set(-0.3)
    rng = jax.random.PRNGKey(0)
    sol_j = jax.jit(j_mpc)(x, rng, j_reset(x, rng, x), jnp.float32(0.0), x)
    draws = None
    if P > 1 or mppi:
        draws = jax_solve_draws(P, 1, bool(cfg.get("antithetic", False)),
                                spread=cfg.get("initial_state_std") is not None,
                                mppi_cfg=MPPIConfig.from_config(cfg) if mppi else None, H=H)
        if P == 1:                        # MPPI's (eps, c0), without a block
            draws = (d[:2] for d in draws)
    orig = tloader.default_rounds_to_bf16
    tloader.default_rounds_to_bf16 = lambda device: card_bf16
    try:
        _, _, pieces = tloader.build_mpc(copy.deepcopy(cfg), device="cpu")
        _, (t_reset, t_mpc), _, _ = tloader.make_mpc_from_config(copy.deepcopy(cfg),
                                                                 device="cpu")
        xt = torch.tensor(np.array(x))
        sol_t = t_mpc(xt, draws, t_reset(xt, draws, xt), 0.0, xt)
    finally:
        tloader.default_rounds_to_bf16 = orig
    return sol_j, sol_t, pieces.trunk_bf16


def _gap(sol_j, sol_t) -> tuple:
    """(max |du|, max |dx_evol|, the costs' largest relative gap)."""
    du = float(np.abs(sol_t.u_opt.numpy() - np.asarray(sol_j.u_opt)).max())
    dx = float(np.abs(sol_t.x_evol.numpy() - np.asarray(sol_j.x_evol)).max())
    dc = max(abs(float(getattr(sol_t.opt_state, f)) - float(getattr(sol_j.opt_state, f)))
             / abs(float(getattr(sol_j.opt_state, f))) for f in ("init_cost", "opt_cost"))
    return du, dx, dc


def _check_route(cfg, want, monkeypatch):
    monkeypatch.setattr(jax.lax, "dot_general", _emulated_dot_general)
    sol_j, sol_t, bf16 = _first_solves(cfg, card_bf16=True)
    assert bf16 is want
    # a CPU build never rounds (DEFAULT is fp32 there, as for the original)
    assert tloader.build_mpc(copy.deepcopy(cfg), device="cpu")[2].trunk_bf16 is False
    assert int(sol_t.opt_state.num_steps) == int(sol_j.opt_state.num_steps)
    tol = (U_ATOL_MPPI if cfg.get("solver") == "mppi" else U_ATOL, X_ATOL, COST_RTOL)
    same = _gap(sol_j, sol_t)
    assert all(g <= t for g, t in zip(same, tol)), (same, tol)
    # non-vacuity: the port's other precision is seen, in some metric
    # outside its tolerance and 10x farther from JAX than the port's own
    orig = tloader.trunk_bf16
    monkeypatch.setattr(tloader, "trunk_bf16", lambda *a: not orig(*a))
    _, other, flipped = _first_solves(cfg, card_bf16=True)
    assert flipped is not want
    far = _gap(sol_j, other)
    assert any(o > t and o > 10 * max(g, 1e-9) for o, g, t in zip(far, same, tol)), (far, same)


@pytest.mark.parametrize("case, mutation, want", ROUTES, ids=[r[0] for r in ROUTES])
def test_routes_take_the_trunk_precision_of_jax(repo_root, monkeypatch, case, mutation, want):
    """One row of the routing table: the port's ``trunk_bf16`` on the card
    and its first solve against the JAX package's on its TPU's route."""
    _check_route(_cfg(repo_root, **mutation), want, monkeypatch)


@pytest.mark.parametrize("refine, want", [(0, True), (3, False)])
def test_policy_routes_take_the_trunk_precision_of_jax(repo_root, monkeypatch, refine, want):
    """The pure policy (XLA: its telemetry cost on the bf16 trunk, the
    network in fp32) and the ``refine_iters`` hybrid (the whole-solve
    kernel at P=1, fp32) on the shipped iris posctrl checkpoint, H = 20."""
    _check_route(_cfg(repo_root, **_policy(repo_root, refine)), want, monkeypatch)


@pytest.mark.parametrize("name", ["high", "fp16"])
def test_unknown_precision_names_raise_value_error(repo_root, name):
    """A name the original does not know raises its ``ValueError`` when the
    solver is built, on any route (the port no longer refuses DEFAULT)."""
    cfg = _cfg(repo_root, matmul_precision=name)
    with pytest.raises(ValueError, match=f"matmul_precision {name!r} not recognized"):
        j_make(copy.deepcopy(cfg))
    with pytest.raises(ValueError, match=f"matmul_precision {name!r} not recognized"):
        tloader.make_mpc_from_config(copy.deepcopy(cfg), device="cpu")


def test_default_rounds_to_bf16_on_the_card_only():
    """DEFAULT is the TPU's bf16 on the card and fp32 on the CPU."""
    assert tloader.default_rounds_to_bf16(torch.device("cuda"))
    assert not tloader.default_rounds_to_bf16(torch.device("cpu"))
    assert not tloader.default_rounds_to_bf16("cpu")


# the bf16 forms on the card against their plain bf16 twins (chip_smoke.py's
# phase 28 tolerances, its BF16_TOL): the plan's largest |du|, the exit
# gradient's grad_sqr (relative), the particle costs (relative), the P=1
# costs (relative; a row's bf16 tie flips are not averaged over particles),
# value (relative) and gradient (over its largest entry); with risk the
# gradient at 1e-5: its particle weights 1 + lambda (tot_p - m) / std amplify
# the totals' last bits, and the fp32 options form itself reads up to 8.5e-6
# from its plain fp32 twin on an H100
CARD_TOL = {"du": 1e-6, "gsq": 5e-5, "cost": 5e-7, "value": 1e-6, "grad": 1e-6}
CARD_TOL_RISK = dict(CARD_TOL, grad=1e-5)
CARD_TOL_P1 = {"cost": 3e-6}
# examples/uncertainty_mpc.py's state-noise stds, the options' starts
_START_STD = [0.15] * 3 + [0.1] * 3 + [0.0] * 4 + [0.05] * 3


def _card_held(tag, k16: dict, p16: dict, k32: dict, tol: dict):
    """Each metric of a bf16 form within ``tol`` of its plain bf16 twin, and
    the form more than 10x that from its fp32 form in some metric."""
    def rel(a, b):
        return float(((a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-30)).max())

    fns = {"du": lambda a, b: float((a - b).abs().max()), "gsq": rel, "cost": rel, "value": rel,
           "grad": lambda a, b: float((a - b).abs().max() / b.abs().max())}
    err = {m: fns[m](k16[m].cpu(), p16[m].cpu()) for m in k16}
    gap = {m: fns[m](k16[m].cpu(), k32[m].cpu()) for m in k16}
    assert all(err[m] <= tol[m] for m in err), (tag, err, tol)
    assert any(gap[m] > 10 * tol[m] for m in gap), (tag, gap, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("P, chunk, options", [(64, 16, False), (512, 0, False),
                                               (512, 0, True), (1024, 0, True)])
def test_bf16_kernels_match_plain_on_cuda(repo_root, P, chunk, options):
    """The bf16 forms on the card against their plain bf16 twins on the
    same torch draws (antithetic, iris traj), at ``CARD_TOL`` (with risk
    ``value_and_grad`` at ``CARD_TOL_RISK``), and each
    more than 10x that from its fp32 form: the whole solve's particle form
    at max_iter 5 (equal steps; its cluster against one block within 1e-6,
    equal bits expected), the particle ``value_batch`` at K = 1 and 4 (both
    launches' costs held as one set) and ``value_and_grad``; with
    ``options`` their options forms (risk_lambda 2 and state-noise starts;
    P=1024 sweeps two chunks a block). Without them the P=1
    ``value_batch`` at K = 16 too (``CARD_TOL_P1``); the P=1 whole solve
    and ``value_and_grad`` refuse the bf16 trunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU mode")
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.rollout import (draw_brownian, draw_start_spread,
                                                    particle_starts)

    dev, Hf = torch.device("cuda"), 20
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg.update(num_particles=P, antithetic=True)
    b = tloader.make_mpc_from_config(cfg, device=dev)[3]
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    x0 = torch.zeros(13, device=dev)
    x0[6], x0[0], x0[3] = 1.0, 0.3, 0.2
    x_ref = x0.clone().expand(Hf + 1, 13).contiguous()
    x_ref[:, 0] = 0.0
    u_prev = b.cost_params.uref.clone()
    u_init = (u_prev.expand(Hf, 4) + 0.02).contiguous()
    z = draw_brownian(torch.Generator().manual_seed(P), Hf, P, True, dev).transpose(0, 1)
    cp, starts = b.cost_params, None
    if options:
        cp = cp._replace(risk_lambda=2.0)
        z0 = draw_start_spread(torch.Generator().manual_seed(P + 1), P, True, dev)
        starts = particle_starts(x0, torch.tensor(_START_STD, device=dev), z0).contiguous()
    args = (b.model, b.params, cp, apg, b.time_steps, x0, x_ref, u_prev, z, P, b.lb, b.ub,
            u_init)

    def solve(fn, bf16, **kw):
        return fn(*args, precond=b.precond, chunk=chunk, starts=starts, bf16=bf16, **kw)[0]

    n16 = AK.apg_solve_kernel.launches_bf16
    st_k = solve(AK.apg_solve_kernel, True)
    st_1 = solve(AK.apg_solve_kernel, True, cluster=1)
    torch.cuda.synchronize()
    assert AK.apg_solve_kernel.launches_bf16 == n16 + 2
    st_32 = solve(AK.apg_solve_kernel, False)
    st_p = solve(AK.apg_solve_plain, True)
    assert len({int(s.num_steps) for s in (st_k, st_1, st_32, st_p)}) == 1
    _card_held("apg_solve", *({"du": s.yk, "gsq": s.grad_sqr} for s in (st_k, st_p, st_32)),
               CARD_TOL)
    np.testing.assert_allclose(st_1.yk.cpu().numpy(), st_k.yk.cpu().numpy(), rtol=1e-6, atol=0)
    oargs = (b.model, b.params, cp, b.time_steps, x0, x_ref, u_prev, z, P, 4)
    trio = (CO.cost_oracle(*oargs, chunk=chunk, starts=starts, bf16=True),
            CO.cost_oracle_plain(*oargs, chunk=chunk, starts=starts, bf16=True),
            CO.cost_oracle(*oargs, chunk=chunk, starts=starts))
    U = (u_init + 0.05 * torch.rand((16, Hf, 4), generator=torch.Generator().manual_seed(1))
         .to(dev)).contiguous()
    _card_held("value_batch", *({"cost": torch.cat([o.value_batch(U[:1]), o.value_batch(U[:4])])}
                                for o in trio), CARD_TOL)
    _card_held("value_and_grad", *({"value": v, "grad": g}
                                   for v, g in (o.value_and_grad(u_init) for o in trio)),
               CARD_TOL_RISK if options else CARD_TOL)
    if options:
        return
    p1 = oargs[:7] + (None, 1, 4)
    _card_held("value_batch P=1", *({"cost": o.value_batch(U)} for o in (
        CO.cost_oracle(*p1, bf16=True), CO.cost_oracle_plain(*p1, bf16=True),
        CO.cost_oracle(*p1))), CARD_TOL_P1)
    with pytest.raises(ValueError, match="no bf16 trunk"):
        CO.cost_oracle(*p1, bf16=True).value_and_grad(u_init)
    with pytest.raises(ValueError, match="no bf16 trunk"):
        AK.apg_solve_kernel(*args[:8], None, 1, *args[10:], precond=b.precond, bf16=True)
