"""Cost oracle: the hand-written Hopper kernels and their plain version.

:func:`cost_oracle` is the counterpart of
``sde4mbrl_px4_tpu/ops/pallas/solve_kernels.py::pallas_cost_oracle``
(``:187-369``) and takes its inputs (``interpret`` aside, which has no
meaning here): one solve's cost, returned as a
:class:`~sde4mbrl_px4_tpu_torch.solver.apg.CostOracle` whose
``value_batch`` (K, H, n) -> (K,), ``value_and_grad`` (H, n) -> ((),
(H, n)) and ``trajectory`` (H, n) -> (H+1, 13) evaluate it; ``value(u)``
is ``value_batch(u[None])[0]``, as in the original (n: the decision width
nZ). On CUDA tensors the
entries launch ``csrc/cost_oracle.cu`` (on the current stream, no sync)
or raise; the consts buffer is packed once, when the oracle is built, and
every launch of the solve reuses it. On CPU tensors :func:`cost_oracle`
returns :func:`cost_oracle_plain`: ``vmap`` of the rollout + cost,
autograd for the gradient, ``rollout_mean`` for the trajectory.

Particles: with ``num_particles`` P > 1 (or ``deterministic=False``) the
cost is the mean over the P Monte-Carlo paths of the Brownian block
``noise`` (P, H, 13), the original kernels' layout; ``trajectory`` stays the
mean dynamics. ``chunk`` is taken and checked as in the original (it must
divide P; ``P <= chunk`` turns it off): the kernels sweep the particles in
chunks of that size, or, at 0, of the largest divisor of P that fits their
shared memory. Both particle kernels spread a plan's chunks over a
thread-block cluster of C = min(n_chunks, C_max) blocks (``cluster`` caps
C, for measurement; every C gives the same bits): ``value_and_grad`` is one
cluster, ``value_batch`` a grid of K clusters, one per candidate. The plain
version takes the unchunked mean, which the chunked one equals in exact
arithmetic.

The particle options (the JAX package runs them on XLA only,
``engine/mpc_loader.py:342-350``): ``cost_params.risk_lambda`` prices a plan
at the mean plus ``risk_lambda`` times the std of its particles' discounted
totals (the kernels' ``ApgArgs.risk`` branch, ``cost/cost.py`` in the plain
version), and ``starts`` (P, 13), the particles' initial states of
``initial_state_std`` (``ops/rollout.py::particle_starts``), replaces x0
for the particles (``trajectory`` keeps the unperturbed x0). Both need
P > 1 (a deterministic oracle ignores the starts).

State constraints (``state_constr``, either form): the plans are the
decision rows, nZ = n_u + m columns wide in the proximal form (the slack
targets past the controls, as ``engine/mpc_loader.py:765-773`` of the
original splits them), and the gradient is nZ wide; ``trajectory`` reads
the control columns. The kernels take the form as a compile-time branch
(``consts.py::sc_kind``). At P=1 the kernels run the form the trunk's
shape picks (``consts.py`` module docstring): the register chain on 64
hidden units and at most 16 inputs (8 ``value_batch`` candidates per
block), on any other trunk ``value_batch`` and ``trajectory`` the
shared-memory step (16 candidates per block) and ``value_and_grad`` the
whole solve's wide step (``csrc/sweeps.cuh::vg_wide``), the weights in
device memory where that kernel's block would not fit 227 KB with them (the
library chooses, ``oracle_p1_form`` reports it);
a block takes fewer candidates where wider rows would not fit its form's
budget (``consts.py::value_batch_grid``). :func:`value_batch_kernel`,
:func:`value_and_grad_kernel` and :func:`trajectory_kernel` each count
their launches in ``.launches``.

:func:`cost_oracle_batched` is the oracle of B solves that share the model
and the cost but not their initial state, reference, previous control or
Brownian block (the JAX package's vmap of the solve, ``parallel/batched.py``):
``value_batch`` (B, K, H, n) -> (B, K), ``value_and_grad`` (B, H, n) ->
((B,), (B, H, n)), ``trajectory`` (B, H, n) -> (B, H+1, 13). On CUDA tensors
each evaluation is ONE launch over the kernels' scenario axis
(``ApgArgs.batch``; the consts of B scenarios built on the device by
``consts.py::batch_consts``), whose scenario b has the bits of its solo
launch; on CPU tensors it is :func:`cost_oracle_plain` once per scenario.

``bf16`` (every oracle here): the trunk's three products on bf16-rounded
operands with fp32 sums, the JAX package's ``matmul_precision: default`` on
its TPU, which it runs on XLA only (``engine/mpc_loader.py:320-335``,
``models/sde_model.py:123-146``): ``value_batch`` (every form) and the
particle ``value_and_grad`` take it, as their bf16 instantiations
(``ApgArgs.bf16`` picks them); ``trajectory``
stays the fp32 mean rollout (the original's ``x_evol``, ``:815-819``), and
the P=1 ``value_and_grad`` has no bf16 form (the original runs it on its
kernels, at HIGHEST), so it raises. ``.launches_bf16`` counts the bf16
launches of each of the two kernels (``.launches`` counts all of them).

A risk cost at P > 1 (:func:`cost_oracle_batched` and the plain twins):
the oracle also gets the two evaluations a solve over a block of the
particles needs when the risk term's moments span every block
(``engine/mpc_loader.py``, the particle-sharded solve; ``cost/cost.py``'s
module docstring): ``value_batch_moments`` (B, K, H, n) -> (B, K, 3), each
plan's risk-free cost and the mean and centred second moment of its
particles' totals, one launch of ``value_batch``'s moments-out form
(``ApgArgs.risk_mode``); and ``value_and_grad_moments`` ((B, H, n), (B, 2))
-> ((B,), (B, H, n)), the risk-free cost and the gradient of the block's
share of the risk cost given each scenario's mean and std of the totals
over all particles, one launch of ``value_and_grad``'s moments-in form.
``.launches_moments`` counts the launches of those forms (in ``.launches``
too).

A particle trunk and chunk that fit no shared-memory form of a kernel (past
144 hidden units at P=512 on the iris configs; ``consts.py`` module
docstring) run that kernel's global-weight form: the trunk's weights read in
place from device memory (scenario 0's for a batched launch), no transposes.
Its instantiations are the options forms and their shared-moments forms
(risk and starts off unless the oracle has them), fp32 and bf16, in a
library of their own (``csrc/cost_oracle_gw.cu``;
:func:`load_oracle_library` with ``part_global``), picked per launch by
``oracle_part_form``; the two kernels share one chunk, planned in the
shared-memory forms first, and each takes its form by shape (``value_batch``
keeps its shared-memory form wherever its own block fits).
``.launches_global`` counts each kernel's global-weight launches (in
``.launches`` too). Both global-weight forms spread their chunks over
``ApgArgs.groups`` clusters' worth of blocks (``consts.plan_groups``: the
most the card holds at once, ``oracle_resident_blocks`` /
``value_batch_resident_blocks``), with the bits of one cluster:
``value_and_grad`` a scenario, ``value_batch`` each of its B x K plans
(planned per K at the first launch of that K: a K = 1 trial spreads, MPPI's
K = 64 grid fills the card at groups 1). Each kernel's launches keep their
own copy of the plan, and ``cluster``, when given, plans one cluster a
scenario (a plan). ``value_and_grad_kernel.launches_wide_inputs`` counts
its P=1 launches of the wide step's forms over more than 16 trunk inputs.
``.blocks_global`` on both wrappers counts their
global-weight launches by their blocks per scenario (per plan). The oracle
plans one chunk for both kernels; in the global-weight forms a chunk of at
most ``max(P // GW_ORACLE_BLOCKS, GW_MIN_ROWS)`` rows where ``value_batch``
spreads at the K its solver launches most (``plans``: MPPI's samples, 1 for
APG), else the largest chunk that fits (:func:`plan_oracle_particles`).

Three libraries: ``csrc/cost_oracle.cu`` (the cluster particle forms),
``csrc/cost_oracle_gw.cu`` (the particle global-weight forms) and
``csrc/cost_oracle_p1.cu`` (every P=1 form, ``trajectory`` among them),
built in parallel; :func:`load_oracle_library` loads each, and each answers
the shared-memory and ABI queries of every form.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sde4mbrl_px4_tpu_torch.cost.cost import (CostParams, make_cost_fn, make_risk_moments_fn,
                                               make_risk_surrogate_fn, scenario_cost)
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
from sde4mbrl_px4_tpu_torch.ops.cuda.build import load_library
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import (
    OPT_MOMENTS, ORACLE_TRAJECTORY, ORACLE_VALUE_AND_GRAD, ORACLE_VALUE_BATCH, P1_GLOBAL,
    RISK_MOMENTS_IN, RISK_MOMENTS_OUT, SMEM_LIMIT_PARTICLES, ApgArgs, batch_consts,
    build_consts, opt_form, p1_wide_inputs, p1_widths, plan_groups, plan_particles,
    scenario_weights)
from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean, rollout_sde
from sde4mbrl_px4_tpu_torch.solver.apg import CostOracle

__all__ = ["cost_oracle", "cost_oracle_plain", "cost_oracle_batched",
           "cost_oracle_plain_batched", "load_oracle_library",
           "value_batch_kernel", "value_and_grad_kernel", "trajectory_kernel",
           "resolve_particles", "SMEM_LIMIT", "SMEM_LIMIT_PARTICLES"]

SMEM_LIMIT = 49152   # bytes of shared memory a block of the register chain may use (48 KB)
# the oracle's global-weight chunk where value_batch spreads
# (plan_oracle_particles): at most P // GW_ORACLE_BLOCKS rows, so that a plan
# has that many chunks for the spread's blocks, but not below GW_MIN_ROWS rows
GW_ORACLE_BLOCKS, GW_MIN_ROWS = 64, 8
_P = ctypes.c_void_p
_A = ctypes.POINTER(ApgArgs)


@functools.lru_cache(maxsize=None)
def load_oracle_library(part_global: bool = False, p1: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/cost_oracle.cu`` (the cluster
    particle forms), with ``part_global`` ``csrc/cost_oracle_gw.cu`` (the
    particle global-weight forms), with ``p1`` ``csrc/cost_oracle_p1.cu``
    (every P=1 form and ``trajectory``). Each answers the shared-memory and
    ABI queries of every form."""
    lib = load_library("cost_oracle_gw" if part_global else
                       "cost_oracle_p1" if p1 else "cost_oracle")
    sig = {
        "cost_oracle_args_size": ([], ctypes.c_int),
        "cost_oracle_error_string": ([ctypes.c_int], ctypes.c_char_p),
        "cost_oracle_init": ([], ctypes.c_int),
        "value_batch_smem_bytes": ([_A, ctypes.c_int], ctypes.c_int),
        "trajectory_smem_bytes": ([_A], ctypes.c_int),
        "value_and_grad_smem_bytes": ([_A], ctypes.c_int),
        "oracle_p1_form": ([_A, ctypes.c_int], ctypes.c_int),
        "oracle_part_form": ([_A, ctypes.c_int], ctypes.c_int),
        "value_batch_launch": ([_A, ctypes.c_int] + [_P] * 7, ctypes.c_int),
        "trajectory_launch": ([_A] + [_P] * 4, ctypes.c_int),
        "value_and_grad_launch": ([_A] + [_P] * 9, ctypes.c_int),
        "value_batch_rows": ([_A, ctypes.c_int], ctypes.c_int),
        "oracle_cluster_max": ([ctypes.c_int] * 4, ctypes.c_int),
        "oracle_max_active_clusters": ([ctypes.c_int, _A, ctypes.POINTER(ctypes.c_int)],
                                       ctypes.c_int),
        "oracle_resident_blocks": ([_A, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
        "value_and_grad_scratch_floats": ([_A], ctypes.c_longlong),
        "value_batch_resident_blocks": ([_A, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
        "value_batch_scratch_floats": ([_A, ctypes.c_int], ctypes.c_longlong),
    }
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    if lib.cost_oracle_args_size() != ctypes.sizeof(ApgArgs):
        raise RuntimeError(
            f"ApgArgs ABI mismatch: library {lib.cost_oracle_args_size()} bytes, "
            f"Python {ctypes.sizeof(ApgArgs)} bytes")
    rc = lib.cost_oracle_init()
    if rc != 0:
        raise RuntimeError("cost_oracle_init failed: "
                           + lib.cost_oracle_error_string(rc).decode())
    return lib


def resolve_particles(noise: Optional[torch.Tensor], num_particles: int,
                      deterministic: Optional[bool], chunk: int, H: int,
                      dev: torch.device) -> Tuple[int, Optional[torch.Tensor], int]:
    """The particle set-up of a solve, checked as in the original
    (``solve_kernels.py:215-224``): ``(P, noise (H, P, 13) or None, chunk)``.
    ``deterministic`` defaults to ``P <= 1``; a deterministic solve runs the
    mean dynamics (its particles would all coincide) and ignores ``noise``;
    otherwise ``noise`` must be the float32 (P, H, 13) block on the
    solve's device. ``chunk`` must divide P, and ``P <= chunk`` turns it
    off (0)."""
    P = int(num_particles)
    if P < 1:
        raise ValueError(f"num_particles must be >= 1, got {P}")
    chunk = int(chunk or 0)
    if chunk < 0 or (chunk and P % chunk):
        raise ValueError(f"num_particles={P} must divide by chunk={chunk}")
    if chunk and P <= chunk:
        chunk = 0
    if deterministic is None:
        deterministic = P <= 1
    if deterministic:
        return P, None, chunk
    if noise is None:
        raise ValueError(f"a Monte-Carlo solve (num_particles={P}) needs its "
                         f"Brownian block: noise (P, H, 13), got None")
    _check("noise", noise, (P, H, 13), dev, contiguous=False)
    return P, noise.transpose(0, 1), chunk


def _check(name: str, t: torch.Tensor, shape: tuple, dev: torch.device,
           contiguous: bool = True) -> None:
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"cost_oracle: {name} must be float32 {shape} on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"cost_oracle: {name} must be contiguous")


def _check_inputs(model: NeuralSDE, time_steps, x0, x_ref, u_prev) -> None:
    H, n, dev = int(time_steps.shape[0]), model.n_u, x0.device
    for name, t, shape in (("x0", x0, (13,)), ("x_ref", x_ref, (H + 1, 13)),
                           ("time_steps", time_steps, (H,))):
        _check(name, t, shape, dev, contiguous=False)
    if u_prev.device != dev or u_prev.dtype != torch.float32 or u_prev.shape[0] < n:
        raise ValueError(f"cost_oracle: u_prev must be float32 with >= {n} "
                         f"entries on {dev}")


def _checked(H: int, n: int, dev: torch.device, value_batch, value_and_grad,
             trajectory, value_batch_moments=None, value_and_grad_moments=None
             ) -> CostOracle:
    """The oracle of the three evaluations (and the module docstring's two
    moment evaluations, where given), with shape/dtype/contiguity checks on
    the plans it is given (n = nZ columns: the controls and the proximal
    form's slack targets); ``value(u)`` is ``value_batch(u[None])[0]``."""

    def check_plan(u: torch.Tensor) -> None:
        if u.shape[-1] != n:
            raise ValueError(
                f"cost_oracle: plans must have nZ={n} columns (the controls "
                f"and the slack targets of a proximal state_constr block), got "
                f"{u.shape[-1]}")
        _check("u", u, (H, n), dev)

    def vb(U):
        if U.dim() != 3 or U.shape[0] < 1:
            raise ValueError(f"cost_oracle: value_batch takes (K, {H}, {n}), "
                             f"got {tuple(U.shape)}")
        check_plan(U[0])
        _check("U", U, (U.shape[0], H, n), dev)
        return value_batch(U)

    def vg(u):
        check_plan(u)
        return value_and_grad(u)

    def traj(u):
        check_plan(u)
        return trajectory(u)

    def vb_m(U):
        check_plan(U[0])
        return value_batch_moments(U)

    def vg_m(u, moments):
        check_plan(u)
        _check("moments", moments, (2,), dev, contiguous=False)
        return value_and_grad_moments(u, moments)

    return CostOracle(value=lambda u: vb(u[None])[0], value_batch=vb,
                      value_and_grad=vg, trajectory=traj,
                      value_batch_moments=vb_m if value_batch_moments else None,
                      value_and_grad_moments=vg_m if value_and_grad_moments else None)


def cost_oracle_plain(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                      time_steps: torch.Tensor, x0: torch.Tensor,
                      x_ref: torch.Tensor, u_prev: torch.Tensor, noise,
                      num_particles: int, maxls: int,
                      deterministic: Optional[bool] = None,
                      chunk: int = 0, starts: Optional[torch.Tensor] = None,
                      bf16: bool = False, plans: int = 1) -> CostOracle:
    """Plain PyTorch version of :func:`cost_oracle` (any device): the
    unchunked particle mean (with ``risk_lambda``, mean + lambda * std), the
    particles from ``starts`` (P, 13) where given; ``bf16`` the trunk's
    products on bf16-rounded operands (``trajectory`` stays fp32); ``plans``
    unused (no launch plan). With
    ``risk_lambda`` at P > 1 also the module docstring's two moment
    evaluations, one plan's (``value_batch_moments`` (K, H, n) -> (K, 3),
    ``value_and_grad_moments(u, moments (2,))``): ``make_risk_moments_fn``
    vmapped, and autograd of ``make_risk_surrogate_fn``."""
    _check_inputs(model, time_steps, x0, x_ref, u_prev)
    H, n = int(time_steps.shape[0]), model.n_u
    P, z, _ = resolve_particles(noise, num_particles, deterministic, chunk, H,
                                x0.device)
    x_p, risk = x0, z is not None and cp.risk_lambda is not None
    if z is None:
        z = torch.zeros((H, 1, 13), dtype=torch.float32, device=x0.device)
    elif starts is not None:
        _check("starts", starts, (P, 13), x0.device, contiguous=False)
        x_p = starts
    cost_fn = make_cost_fn(cp, time_steps)
    u_prev = u_prev[:n]
    m = cp.n_slack

    def seq(cost):
        def seq_cost(zr, *moments):
            u = zr[:, :n]
            xp, sg = rollout_sde(model, params, x_p, u, time_steps, z, bf16=bf16)
            return cost(xp, sg, u, x_ref, u_prev, zr[:, n:] if m else None, *moments)
        return seq_cost

    base = CostOracle.from_fn(seq(cost_fn))
    vb_m = vg_m = None
    if risk:
        vb_m = torch.func.vmap(seq(make_risk_moments_fn(cp, time_steps)))
        surrogate = seq(make_risk_surrogate_fn(cp, time_steps))

        def vg_m(zr, moments):
            with torch.enable_grad():
                z_ = zr.detach().requires_grad_(True)
                f = surrogate(z_, moments.detach())
                (g,) = torch.autograd.grad(f[1], z_)
            return f[0].detach(), g

    return _checked(H, n + m, x0.device, base.value_batch, base.value_and_grad,
                    lambda zr: rollout_mean(model, params, x0, zr[:, :n], time_steps),
                    vb_m, vg_m)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + load_oracle_library().cost_oracle_error_string(rc).decode())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _limit(args: ApgArgs, particles: bool = True) -> int:
    """A block's shared-memory budget: 48 KB on the register chain, 227 KB
    with particles (``particles``: the kernel has particle forms) and on the
    P=1 steps off the register chain (the wide and shared-memory steps)."""
    if (particles and args.has_noise) or not p1_widths(args.F, args.HID):
        return SMEM_LIMIT_PARTICLES
    return SMEM_LIMIT


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _library(args: ApgArgs, kind: int) -> Tuple[ctypes.CDLL, bool]:
    """The library a launch of ``kind`` takes (the P=1 forms' and
    ``trajectory``'s, the cluster particle forms' or the particle
    global-weight forms'), and whether its form is the particle global-weight
    form (``oracle_part_form``)."""
    if not args.has_noise or kind == ORACLE_TRAJECTORY:
        return load_oracle_library(p1=True), False
    lib = load_oracle_library()
    glob = lib.oracle_part_form(ctypes.byref(args), kind) == P1_GLOBAL
    return (load_oracle_library(True) if glob else lib), glob


def _check_batch(what: str, args: ApgArgs, consts: torch.Tensor, u: torch.Tensor,
                 per: int, noise: Optional[torch.Tensor] = None,
                 starts: Optional[torch.Tensor] = None) -> None:
    """The buffers of a launch over ``args.batch`` scenarios: contiguous,
    ``per`` plan floats and ``n_consts`` consts floats (and H*P*13 noise
    floats, P*13 float32 starts on the plans' device) a scenario."""
    B = args.batch
    bad = (u.numel() != B * per or consts.numel() != B * args.n_consts
           or not u.is_contiguous() or not consts.is_contiguous())
    if noise is not None:
        bad = bad or noise.numel() != B * args.H * args.P * 13 or not noise.is_contiguous()
    if starts is not None:
        if (not args.has_noise or starts.numel() != B * args.P * 13
                or starts.dtype != torch.float32 or starts.device != u.device
                or not starts.is_contiguous()):
            raise ValueError(f"{what}: the starts of {B} scenario(s) are contiguous float32 "
                             f"(P={args.P}, 13) blocks on {u.device} (particles only), got "
                             f"{starts.dtype} {tuple(starts.shape)} on {starts.device}")
    if bad:
        raise ValueError(f"{what}: {B} scenario(s) take contiguous plans of {per} floats and "
                         f"consts of {args.n_consts} floats each, got {tuple(u.shape)} and "
                         f"{tuple(consts.shape)}")


def value_batch_kernel(consts: torch.Tensor, args: ApgArgs, U: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K, H, nZ) plans -> (K,) costs: one launch of ``value_batch_kernel``
    (``noise``: the contiguous (H, P, 13) block when ``args.has_noise``,
    ``starts`` its particles' (P, 13) initial states or None; the grid is
    ``consts.value_batch_grid``). With ``args.batch`` B > 1 the plans of B
    scenarios, ``U`` (B, K, H, nZ), ``consts`` (B, n_consts), ``noise``
    (B, H, P, 13) and ``starts`` (B, P, 13), cost in the same launch into
    (B, K), scenario b on row b of the grid. ``args.risk_mode``
    ``RISK_MOMENTS_OUT`` (a risk launch with particles): the moments-out
    form, each plan's (risk-free cost, mean of the totals, their centred
    second moment) into (K, 3) (B, K, 3), counted in ``.launches_moments``
    too. Every scenario must hold the same trunk in its consts (as
    ``consts.batch_consts`` writes them): the forms with the weights in
    device memory (at P=1, and the particle global-weight forms) read
    scenario 0's for all. The global-weight form runs each plan on
    ``args.groups * args.cluster`` blocks (:func:`_batch_spread` plans it)."""
    lib, glob = _library(args, ORACLE_VALUE_BATCH)
    K = int(U.shape[-3])
    _check_batch("value_batch", args, consts, U, K * args.H * args.nZ, noise, starts)
    need = lib.value_batch_smem_bytes(ctypes.byref(args), K)
    if need > _limit(args):
        raise ValueError(f"value_batch needs {need} bytes of shared memory per "
                         f"block, above the {_limit(args)}-byte budget")
    moments = args.risk_mode == RISK_MOMENTS_OUT
    out = torch.empty(U.shape[:-2] + ((3,) if moments else ()), dtype=torch.float32,
                      device=U.device)
    # the spread's slots and counters (consts.plan_groups), zeroed by the launcher
    n_scratch = lib.value_batch_scratch_floats(ctypes.byref(args), K)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=U.device) if n_scratch
               else None)
    _raise_on(lib.value_batch_launch(ctypes.byref(args), K, consts.data_ptr(),
                                     U.data_ptr(), _ptr(noise), _ptr(starts),
                                     out.data_ptr(), _ptr(scratch), _stream(U)),
              "value_batch")
    value_batch_kernel.launches += 1
    value_batch_kernel.launches_bf16 += args.bf16
    value_batch_kernel.launches_global += glob
    value_batch_kernel.launches_moments += moments
    if glob:
        n, seen = args.groups * args.cluster, value_batch_kernel.blocks_global
        seen[n] = seen.get(n, 0) + 1
    return out


def value_and_grad_kernel(consts: torch.Tensor, args: ApgArgs, u: torch.Tensor,
                          noise: Optional[torch.Tensor] = None,
                          starts: Optional[torch.Tensor] = None,
                          moments: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, nZ) plan -> (cost (), gradient (H, nZ)): one launch. With
    ``args.batch`` B > 1 the plans of B scenarios, ``u`` (B, H, nZ) (and
    ``consts``, ``noise``, ``starts`` as in :func:`value_batch_kernel`), in
    the same launch into ((B,), (B, H, nZ)), scenario b on block (or
    cluster) b. ``args.risk_mode`` ``RISK_MOMENTS_IN`` (a risk launch with
    particles) takes ``moments`` (B, 2), each scenario's mean and std of
    the totals over all particles: the moments-in form, whose cost is the
    risk-free cost of these particles; counted in ``.launches_moments``
    too. The scenarios share one trunk, as in :func:`value_batch_kernel`."""
    want = args.risk_mode == RISK_MOMENTS_IN
    if want != (moments is not None):
        raise ValueError("value_and_grad: moments go with args.risk_mode RISK_MOMENTS_IN "
                         "and with it only")
    if want and (moments.dtype != torch.float32 or moments.device != u.device
                 or moments.numel() != 2 * args.batch or not moments.is_contiguous()):
        raise ValueError(f"value_and_grad: moments must be contiguous float32 ({args.batch}, "
                         f"2) on {u.device}, got {moments.dtype} {tuple(moments.shape)} on "
                         f"{moments.device}")
    if not args.has_noise and args.bf16:
        raise ValueError("value_and_grad: the P=1 form has no bf16 trunk (the JAX "
                         "package runs it on its kernel, at HIGHEST)")
    lib, glob = _library(args, ORACLE_VALUE_AND_GRAD)
    _check_batch("value_and_grad", args, consts, u, args.H * args.nZ, noise, starts)
    need = lib.value_and_grad_smem_bytes(ctypes.byref(args))
    if need > _limit(args):
        raise ValueError(f"value_and_grad needs {need} bytes of shared memory, "
                         f"above the {_limit(args)}-byte budget")
    val = torch.empty(u.shape[:-2], dtype=torch.float32, device=u.device)
    grad = torch.empty_like(u)
    # the spread's slots and counters (consts.plan_groups), zeroed by the
    # launcher, or the P=1 wide step's buffers past 227 KB
    n_scratch = lib.value_and_grad_scratch_floats(ctypes.byref(args))
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=u.device) if n_scratch
               else None)
    _raise_on(lib.value_and_grad_launch(ctypes.byref(args), consts.data_ptr(),
                                        u.data_ptr(), _ptr(noise), _ptr(starts),
                                        _ptr(moments), val.data_ptr(), grad.data_ptr(),
                                        _ptr(scratch), _stream(u)),
              "value_and_grad")
    value_and_grad_kernel.launches += 1
    value_and_grad_kernel.launches_bf16 += args.bf16
    value_and_grad_kernel.launches_global += glob
    value_and_grad_kernel.launches_moments += want
    # the wide step's forms over more than 16 inputs (P=1 off the register chain)
    value_and_grad_kernel.launches_wide_inputs += int(
        not args.has_noise and not p1_widths(args.F, args.HID) and p1_wide_inputs(args.F))
    if glob:
        n, seen = args.groups * args.cluster, value_and_grad_kernel.blocks_global
        seen[n] = seen.get(n, 0) + 1
    return val, grad


def _spread_args(args: ApgArgs, cluster: int = 0) -> ApgArgs:
    """``value_and_grad``'s copy of an oracle's planned ``args``: where its
    form is the global-weight form, the spread over the scenarios
    (``consts.plan_groups`` on ``oracle_resident_blocks``), unless
    ``cluster`` was given (one cluster a scenario); ``args`` itself keeps
    groups 1."""
    a = ApgArgs.from_buffer_copy(args)
    lib, glob = _library(a, ORACLE_VALUE_AND_GRAD)
    if glob and not cluster:
        n = ctypes.c_int(0)
        _raise_on(lib.oracle_resident_blocks(ctypes.byref(a), ctypes.byref(n)),
                  "oracle_resident_blocks")
        plan_groups(a, P1_GLOBAL, n.value)
    return a


def _batch_spread(args: ApgArgs, cluster: int = 0) -> Callable[[int], ApgArgs]:
    """``value_batch``'s plans of an oracle's planned ``args``, by K: where
    its form is the global-weight form, a copy with the spread over the
    B x K plans (``consts.plan_groups`` with ``plans`` = K on
    ``value_batch_resident_blocks``), planned at the first launch of each K,
    unless ``cluster`` was given (one cluster a plan); else ``args``."""
    lib, glob = _library(args, ORACLE_VALUE_BATCH)
    if not glob or cluster:
        return lambda K: args
    n = ctypes.c_int(0)
    _raise_on(lib.value_batch_resident_blocks(ctypes.byref(args), ctypes.byref(n)),
              "value_batch_resident_blocks")
    plans: Dict[int, ApgArgs] = {}

    def at(K: int) -> ApgArgs:
        if K not in plans:
            a = ApgArgs.from_buffer_copy(args)
            plan_groups(a, P1_GLOBAL, n.value, K)
            plans[K] = a
        return plans[K]

    return at


def _value_batch_spreads(args: ApgArgs, plans: int) -> bool:
    """Whether ``value_batch`` on the planned ``args`` runs its global-weight
    form over more than one cluster a plan at K = ``plans`` (the test of
    ``consts.plan_groups`` for G > 1 on ``value_batch_resident_blocks``,
    written out so that a pinned spread, ``p1_step_ab.grouped``, leaves the
    chunk, and so the bits, as planned)."""
    lib, glob = _library(args, ORACLE_VALUE_BATCH)
    if not glob:
        return False
    n = ctypes.c_int(0)
    _raise_on(lib.value_batch_resident_blocks(ctypes.byref(args), ctypes.byref(n)),
              "value_batch_resident_blocks")
    C, units = int(args.cluster), int(args.batch) * int(plans)
    return int(args.n_chunks) >= 2 * C and n.value >= 2 * units * C


def plan_oracle_particles(lib: ctypes.CDLL, args: ApgArgs, P: int, chunk: int,
                          cluster: int = 0, plans: int = 1) -> None:
    """The oracle's chunk: ``chunk``, or the largest divisor of P whose
    ``value_batch`` and ``value_and_grad`` blocks both fit (one chunk for
    both: the mean of chunk means depends on it), in the shared-memory forms
    at every chunk first and the global-weight forms only where none fits
    (``consts.plan_particles``); and the cluster of both kernels: C =
    min(n_chunks, C_max), C_max the smaller of their forms' largest
    (``oracle_cluster_max``, the options forms' where ``args`` has risk or
    starts, with risk their shared-moments forms' too, so that one plan
    serves both; the bf16 forms' with ``args.bf16``; with the global-weight
    forms the smaller over both libraries, since each kernel takes its form
    by its own bytes; that library is loaded only where they are planned) or
    ``cluster`` when given. In the global-weight forms the chunk is at most
    ``max(P // GW_ORACLE_BLOCKS, GW_MIN_ROWS)`` rows (``consts.
    plan_particles``' ``gw_max_chunk``), so that a K = 1 plan has
    GW_ORACLE_BLOCKS chunks for the spread, where ``value_batch`` at K =
    ``plans`` (the K its solver launches most: MPPI's samples; 1 for APG's
    gradient and value) spreads over the B x ``plans`` plans; where it stays
    at one cluster a plan, the largest chunk that fits (more chunks a block
    only cost it time there)."""
    def need(a):
        return max(lib.value_batch_smem_bytes(ctypes.byref(a), 1),
                   lib.value_and_grad_smem_bytes(ctypes.byref(a)))

    forms = (opt_form(args),) + ((OPT_MOMENTS,) if args.risk else ())

    def largest(l) -> int:
        return min(l.oracle_cluster_max(kind, args.sc_kind, form, args.bf16)
                   for kind in (ORACLE_VALUE_BATCH, ORACLE_VALUE_AND_GRAD) for form in forms)

    def c_max(step: int) -> int:
        most = largest(lib)
        if step == P1_GLOBAL:
            most = min(most, largest(load_oracle_library(True)))
        if cluster and not 1 <= cluster <= most:
            raise ValueError(f"cluster={cluster}: the oracle kernels take 1 to {most} blocks")
        return cluster or most

    plan_particles(args, P, chunk, need, SMEM_LIMIT_PARTICLES, c_max)
    widest = int(args.Pc)
    plan_particles(args, P, chunk, need, SMEM_LIMIT_PARTICLES, c_max,
                   max(int(P) // GW_ORACLE_BLOCKS, GW_MIN_ROWS))
    if args.Pc != widest and not _value_batch_spreads(args, plans):
        plan_particles(args, P, chunk, need, SMEM_LIMIT_PARTICLES, c_max)


def trajectory_kernel(consts: torch.Tensor, args: ApgArgs,
                      u: torch.Tensor) -> torch.Tensor:
    """(H, nZ) plan -> the mean rollout of its controls (H+1, 13): one launch.
    With ``args.batch`` B > 1 the plans of B scenarios, ``u`` (B, H, nZ) and
    ``consts`` (B, n_consts), roll out in the same launch, one block each,
    into (B, H+1, 13), the scenarios on one trunk as in
    :func:`value_batch_kernel`. Always fp32: the kernel reads no
    ``args.bf16``."""
    lib = load_oracle_library(p1=True)
    need = lib.trajectory_smem_bytes(ctypes.byref(args))
    if need > _limit(args, particles=False):
        raise ValueError(f"trajectory needs {need} bytes of shared memory, "
                         f"above the {_limit(args, particles=False)}-byte budget")
    _check_batch("trajectory", args, consts, u, args.H * args.nZ)
    out = torch.empty(u.shape[:-2] + (args.H + 1, 13), dtype=torch.float32, device=u.device)
    _raise_on(lib.trajectory_launch(ctypes.byref(args), consts.data_ptr(),
                                    u.data_ptr(), out.data_ptr(), _stream(u)),
              "trajectory")
    trajectory_kernel.launches += 1
    return out


value_batch_kernel.launches = value_batch_kernel.launches_bf16 = 0
value_and_grad_kernel.launches = value_and_grad_kernel.launches_bf16 = 0
value_batch_kernel.launches_moments = value_and_grad_kernel.launches_moments = 0
value_batch_kernel.launches_global = value_and_grad_kernel.launches_global = 0
value_batch_kernel.blocks_global, value_and_grad_kernel.blocks_global = {}, {}
value_and_grad_kernel.launches_wide_inputs = 0
trajectory_kernel.launches = 0


def cost_oracle(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                time_steps: torch.Tensor, x0: torch.Tensor, x_ref: torch.Tensor,
                u_prev: torch.Tensor, noise, num_particles: int, maxls: int,
                deterministic: Optional[bool] = None,
                chunk: int = 0, cluster: int = 0,
                starts: Optional[torch.Tensor] = None, bf16: bool = False,
                plans: int = 1) -> CostOracle:
    """The cost oracle of one solve. ``noise`` (P, H, 13) is the Brownian
    block of a Monte-Carlo solve (None for the mean dynamics of P=1),
    ``starts`` (P, 13) its particles' initial states or None (all at x0);
    ``maxls`` is unused, as in the original (``value_batch`` takes any K);
    ``cluster`` caps the particle kernels' clusters (0: the card's largest);
    ``bf16`` the module docstring's; ``plans`` the K of most of the solver's
    ``value_batch`` launches, which the particle chunk is planned for
    (:func:`plan_oracle_particles`). CPU tensors get :func:`cost_oracle_plain`."""
    dev = x0.device
    if dev.type == "cpu":
        return cost_oracle_plain(model, params, cp, time_steps, x0, x_ref, u_prev,
                                 noise, num_particles, maxls, deterministic, chunk, starts,
                                 bf16)
    if dev.type != "cuda":
        raise ValueError(f"cost_oracle: unsupported device {dev}")
    _check_inputs(model, time_steps, x0, x_ref, u_prev)
    H = int(time_steps.shape[0])
    P, z, chunk = resolve_particles(noise, num_particles, deterministic, chunk, H, dev)
    lib = load_oracle_library()
    consts, args = build_consts(model, params, cp, None, time_steps, x0, x_ref,
                                u_prev, particles=z is not None)
    if z is None:
        starts = None                 # the mean dynamics start at x0
    args.has_starts = int(starts is not None)
    args.bf16 = int(bf16)
    a_vg, a_vb = args, lambda K: args
    if z is not None:
        z = z.contiguous()
        plan_oracle_particles(lib, args, P, chunk, cluster, plans)
        a_vg, a_vb = _spread_args(args, cluster), _batch_spread(args, cluster)
    return _checked(H, args.nZ, dev,
                    lambda U: value_batch_kernel(consts, a_vb(int(U.shape[0])), U, z, starts),
                    lambda u: value_and_grad_kernel(consts, a_vg, u, z, starts),
                    functools.partial(trajectory_kernel, consts, args))


def _checked_batched(B: int, H: int, n: int, dev: torch.device, value_batch,
                     value_and_grad, trajectory, value_batch_moments=None,
                     value_and_grad_moments=None) -> CostOracle:
    """The batched oracle of the three evaluations (and the module
    docstring's two moment evaluations, where given), with shape/dtype/
    contiguity checks on the plans of its B scenarios; ``value(u)`` (B, H, n)
    -> (B,) is ``value_batch(u[:, None])[:, 0]``."""

    def check(name: str, U: torch.Tensor, shape: tuple) -> None:
        if U.shape[-1] != n:
            raise ValueError(
                f"cost_oracle_batched: plans must have nZ={n} columns (the controls "
                f"and the slack targets of a proximal state_constr block), got "
                f"{U.shape[-1]}")
        _check(name, U, shape, dev)

    def vb(U):
        if U.dim() != 4 or U.shape[1] < 1:
            raise ValueError(f"cost_oracle_batched: value_batch takes ({B}, K, {H}, {n}), "
                             f"got {tuple(U.shape)}")
        check("U", U, (B, U.shape[1], H, n))
        return value_batch(U)

    def vg(u):
        check("u", u, (B, H, n))
        return value_and_grad(u)

    def traj(u):
        check("u", u, (B, H, n))
        return trajectory(u)

    def vb_m(U):
        if U.dim() != 4 or U.shape[1] < 1:
            raise ValueError(f"cost_oracle_batched: value_batch_moments takes ({B}, K, {H}, "
                             f"{n}), got {tuple(U.shape)}")
        check("U", U, (B, U.shape[1], H, n))
        return value_batch_moments(U)

    def vg_m(u, moments):
        check("u", u, (B, H, n))
        _check("moments", moments, (B, 2), dev)
        return value_and_grad_moments(u, moments)

    return CostOracle(value=lambda u: vb(u[:, None])[:, 0], value_batch=vb,
                      value_and_grad=vg, trajectory=traj,
                      value_batch_moments=vb_m if value_batch_moments else None,
                      value_and_grad_moments=vg_m if value_and_grad_moments else None)


def cost_oracle_plain_batched(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                              time_steps: torch.Tensor, x0: torch.Tensor,
                              x_ref: torch.Tensor, u_prev: torch.Tensor, noise,
                              num_particles: int, maxls: int, chunk: int = 0,
                              starts: Optional[torch.Tensor] = None,
                              bf16: bool = False, plans: int = 1) -> CostOracle:
    """Plain version of :func:`cost_oracle_batched` (any device):
    :func:`cost_oracle_plain` once per scenario (with its own tracking
    weights where they carry a scenario axis), the results stacked."""
    B, H, n = int(x0.shape[0]), int(time_steps.shape[0]), model.n_u + cp.n_slack
    solo = [cost_oracle_plain(model, params, scenario_cost(cp, b), time_steps, x0[b],
                              x_ref[b], u_prev[b], None if noise is None else noise[b],
                              num_particles, maxls,
                              chunk=chunk, starts=None if starts is None else starts[b],
                              bf16=bf16)
            for b in range(B)]

    def each(fn):
        def run(U, *rest):
            outs = [getattr(o, fn)(U[b], *(r[b] for r in rest)) for b, o in enumerate(solo)]
            if isinstance(outs[0], tuple):
                return tuple(torch.stack(f) for f in zip(*outs))
            return torch.stack(outs)
        return run

    moments = (each("value_batch_moments"), each("value_and_grad_moments")) \
        if solo[0].value_batch_moments is not None else (None, None)
    return _checked_batched(B, H, n, x0.device, each("value_batch"),
                            each("value_and_grad"), each("trajectory"), *moments)


def cost_oracle_batched(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                        time_steps: torch.Tensor, x0: torch.Tensor, x_ref: torch.Tensor,
                        u_prev: torch.Tensor, noise, num_particles: int, maxls: int,
                        chunk: int = 0, cluster: int = 0,
                        starts: Optional[torch.Tensor] = None,
                        bf16: bool = False, plans: int = 1) -> CostOracle:
    """The cost oracle of B solves (module docstring): ``x0`` (B, 13),
    ``x_ref`` (B, H+1, 13), ``u_prev`` (B, n_u) or wider, ``noise`` (B, P, H,
    13) for a Monte-Carlo solve (None at P=1), ``starts`` (B, P, 13) its
    particles' initial states or None; the tracking weights of ``cp`` may
    carry a (B,) axis. With risk at P > 1 the module docstring's two moment
    evaluations too. On the card every evaluation is
    one launch over the B scenarios; ``plans`` as in :func:`cost_oracle`.
    CPU tensors get :func:`cost_oracle_plain_batched`."""
    dev = x0.device
    if dev.type == "cpu":
        return cost_oracle_plain_batched(model, params, cp, time_steps, x0, x_ref, u_prev,
                                         noise, num_particles, maxls, chunk, starts, bf16)
    if dev.type != "cuda":
        raise ValueError(f"cost_oracle_batched: unsupported device {dev}")
    B, H = int(x0.shape[0]), int(time_steps.shape[0])
    if B < 1:
        raise ValueError("cost_oracle_batched: no scenario (B = 0)")
    _check_inputs(model, time_steps, x0[0], x_ref[0], u_prev[0])
    for name, t, shape in (("x0", x0, (B, 13)), ("x_ref", x_ref, (B, H + 1, 13))):
        _check(name, t, shape, dev, contiguous=False)
    P, _, chunk = resolve_particles(None, num_particles, True, chunk, H, dev)
    z = None
    if P > 1:
        if noise is None:
            raise ValueError(f"a Monte-Carlo solve (num_particles={P}) needs its "
                             f"Brownian blocks: noise (B, P, H, 13), got None")
        _check("noise", noise, (B, P, H, 13), dev, contiguous=False)
        z = noise.transpose(1, 2).contiguous()          # (B, H, P, 13)
        if starts is not None:
            _check("starts", starts, (B, P, 13), dev)
    else:
        starts = None                 # the mean dynamics start at x0
    lib = load_oracle_library()
    consts, args = build_consts(model, params, cp, None, time_steps, x0[0], x_ref[0],
                                u_prev[0], particles=z is not None)
    weights = scenario_weights(cp, B)
    if B > 1:
        consts = batch_consts(consts, args, x0, x_ref, u_prev, weights)
    args.has_starts = int(starts is not None)
    args.bf16 = int(bf16)
    a_vg, a_vb = args, lambda K: args
    if z is not None:
        plan_oracle_particles(lib, args, P, chunk, cluster, plans)
        a_vg, a_vb = _spread_args(args, cluster), _batch_spread(args, cluster)
    moments = (None, None)
    if z is not None and args.risk:
        a_out, a_in = (ApgArgs.from_buffer_copy(args) for _ in range(2))
        a_out.risk_mode, a_in.risk_mode = RISK_MOMENTS_OUT, RISK_MOMENTS_IN
        a_in, a_out = _spread_args(a_in, cluster), _batch_spread(a_out, cluster)
        moments = (lambda U: value_batch_kernel(consts, a_out(int(U.shape[1])), U, z, starts),
                   lambda u, mom: value_and_grad_kernel(consts, a_in, u, z, starts, mom))
    return _checked_batched(B, H, args.nZ, dev,
                            lambda U: value_batch_kernel(consts, a_vb(int(U.shape[1])), U, z,
                                                         starts),
                            lambda u: value_and_grad_kernel(consts, a_vg, u, z, starts),
                            functools.partial(trajectory_kernel, consts, args), *moments)
