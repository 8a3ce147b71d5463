"""Whole-solve APG: the hand-written Hopper kernel and its plain version.

:func:`apg_solve_kernel` is the counterpart of
``sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py::pallas_apg_solve`` and takes
its inputs: one receding-horizon solve, returned as ``(APGState, x_evol)``
where ``x_evol`` (H+1, 13) is the mean trajectory of the best iterate. On
CUDA tensors it launches ``csrc/apg_solve.cu`` (one thread block, on the
current stream, no sync) or raises; on CPU tensors it runs
:func:`apg_solve_plain`, the same function in plain PyTorch
(``solver/apg.py::apg_solve`` over the plain cost oracle,
``ops/cuda/cost_oracle.py::cost_oracle_plain``: ``rollout_sde`` +
``cost_fn`` with autograd for the gradient, ``rollout_mean`` for
``x_evol``).

:func:`apg_solve_kernel_batched` solves B problems in one launch, the
kernel's scenario axis (one block, or one cluster, per scenario; the JAX
package's vmap of the solve, ``parallel/batched.py``); a solo solve is
that launch at B = 1.

A deterministic P=1 solve (the flight configs) is one launch, whose exit
sweep exports ``x_evol``. A Monte-Carlo solve (``num_particles`` P > 1,
``noise`` the (P, H, 13) Brownian block) minimises the particle-mean cost:
one launch of the kernel's particle form, which sweeps the particles in
chunks (``chunk``, or the largest divisor of P whose shared memory fits)
spread over a thread-block cluster of C = min(n_chunks, C_max) blocks, one
per SM (C_max 16 where the card schedules such a cluster, else 8;
``cluster`` caps C, for measurement), then one launch of the oracle's
``trajectory`` kernel for the mean-dynamics ``x_evol``, as in the original
(``engine/mpc_loader.py:745-751``). Every C gives the same bits: the
blocks sum the chunks' partials in chunk order.

The particle options, which the JAX package sends to XLA
(``engine/mpc_loader.py:342-350``), run in the same particle launch:
``cost_params.risk_lambda`` makes the solve minimise the mean plus
``risk_lambda`` times the std of the particles' discounted totals (the
kernel's ``ApgArgs.risk`` branch; its Armijo test prices every candidate
so), and ``starts`` (P, 13) gives each particle its initial state
(``initial_state_std``, ``ops/rollout.py::particle_starts``); ``x_evol``
stays the mean rollout from the unperturbed x0.

State constraints (``state_constr``, either form) are a compile-time branch
of the kernel (``consts.py::sc_kind``): the penalty form's box penalties
and the proximal form's slack coupling join the stage cost and the reverse
sweep. In the proximal form the decision rows (``u_init``, ``yk``, the box
``lb``/``ub``, ``precond``) are nZ = n_u + m wide; the kernel clips and
sums the Armijo terms over nZ columns and the control terms over n_u. Its
P=1 layout at nZ = 10 passes 48 KB, so the constrained forms take dynamic
shared memory above the default (set once per library load by
``apg_init``). ``apg_solve_kernel.launches`` counts the whole-solve
kernel's launches.

A P=1 solve runs the form its trunk's shape picks (``consts.py`` module
docstring): the register chain on 64 hidden units and at most 16 inputs,
the wide step on any other trunk (``csrc/sweeps.cuh::vg_wide``: the chain's
structure over a runtime width, layer 1 split over the block's warps; its
weights in the block's shared memory, or in device memory where they do
not fit 227 KB; the library chooses, ``apg_p1_form`` reports it; past
227 KB again its width-sized buffers go to the launch's scratch in device
memory, so any width runs). The wide step takes any number of trunk
inputs: past 16 (eight motors or more, ``consts.p1_wide_inputs``) in forms
whose layer 0 reads the inputs past the first 16 from the row's controls.
The wide step's forms are a library of their own (``csrc/apg_solve_p1.cu``,
:func:`load_apg_library` with ``p1_step``; those over more than 16 inputs
``csrc/apg_solve_p1x.cu``, with ``wide_inputs`` too), built in parallel
with the others.
:func:`apg_phase_split` runs the same solve without state constraints
(P=1 on the register chain or the wide step with its weights in shared
memory, or particles) through the kernel's
clock-stamped instantiation and returns the SM cycles of each of
:data:`PHASES` (P=1) or :data:`PART_PHASES` (particles), for
measurement.

``bf16`` (a Monte-Carlo solve only): the trunk's three products on
bf16-rounded operands with fp32 sums, the JAX package's ``matmul_precision:
default`` on its TPU, which it runs on XLA only (P > 128 without
``pallas_chunk``, or with the particle options: ``engine/mpc_loader.py:
320-350``). The particle form's bf16 instantiations are a library of their
own (``csrc/apg_solve_bf16.cu``, :func:`load_apg_library` with ``bf16``),
which a launch with ``ApgArgs.bf16`` takes; the mean-dynamics ``x_evol``
stays fp32 (``:815-819``). The P=1 form has no bf16 trunk (the original runs
P=1 on its kernel, at HIGHEST) and raises.
``apg_solve_kernel.launches_bf16`` counts the bf16 launches
(``.launches`` counts all of them).

A particle solve whose trunk and chunk fit no shared-memory form (past 144
hidden units at P=512 on the iris configs) runs the global-weight form
(``consts.py`` module docstring): the trunk's weights read in place from
device memory, scenario 0's for a batched launch. Its instantiations are the
options forms (risk and starts off unless the solve has them) in libraries
of their own (``csrc/apg_solve_gw.cu``, ``csrc/apg_solve_gw_bf16.cu``;
:func:`load_apg_library` with ``part_global``), picked by ``apg_part_form``
after the chunk is planned; ``apg_solve_kernel.launches_global`` counts
their launches (in ``.launches`` too), ``.launches_wide_inputs`` the P=1
launches of the wide step's forms over more than 16 trunk inputs. The global-weight form spreads a
scenario's chunks over ``ApgArgs.groups`` clusters' worth of blocks
(``consts.py`` module docstring, ``consts.plan_groups``: the most the card
holds at once for the launch's B scenarios, from the library's
``apg_resident_blocks``), with the bits of one cluster; a launch the card
refuses raises, with no retry on fewer blocks. ``cluster``, when given,
plans one cluster a scenario (groups 1). ``apg_solve_kernel.blocks_global``
counts the global-weight launches by their blocks per scenario
(``{groups * cluster: launches}``).

The P=1 register chain's forms are a library of their own
(``csrc/apg_solve_chain.cu``, :func:`load_apg_library` with ``chain``);
``csrc/apg_solve.cu`` holds the fp32 particle forms. Both build in parallel
with the others.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from sde4mbrl_px4_tpu_torch.cost.cost import CostParams, scenario_cost
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
from sde4mbrl_px4_tpu_torch.ops.cuda.build import load_library
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import (
    P1_GLOBAL, SC_NONE, SMEM_LIMIT_PARTICLES, ApgArgs, batch_consts, build_consts,
    has_options, p1_wide_inputs, p1_widths, plan_groups, plan_particles, sc_kind,
    scenario_weights)
from sde4mbrl_px4_tpu_torch.ops.cuda.cost_oracle import (
    cost_oracle_plain, resolve_particles, trajectory_kernel)
from sde4mbrl_px4_tpu_torch.solver.apg import (
    APGConfig, APGState, apg_solve, resolve_t_init)

__all__ = ["apg_solve_kernel", "apg_solve_kernel_batched", "apg_solve_plain",
           "apg_solve_plain_batched", "apg_phase_split", "load_apg_library",
           "plan_solve_particles", "PHASES", "PART_PHASES", "SMEM_LIMIT",
           "SMEM_LIMIT_PARTICLES"]

SMEM_LIMIT = 49152   # bytes of shared memory the unconstrained register chain may use (48 KB)
# the clock64 phases of apg_phase_split, in the order of its cycle sums
# (csrc/apg_solve.cu, PH_*)
PHASES = ("forward trunk", "forward scalar step", "reverse scalar", "reverse trunk",
          "candidate rollout", "loop bookkeeping")
# ... of a particle solve (csrc/sweeps.cuh, PP_*): the reductions include the
# wait at their cluster barriers
PART_PHASES = ("vg forward sweep", "vg reverse sweep", "candidate rollout",
               "cluster reduction", "loop bookkeeping")
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def load_apg_library(bf16: bool = False, p1_step: bool = False,
                     part_global: bool = False, chain: bool = False,
                     wide_inputs: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/apg_solve.cu`` (the fp32
    particle forms), with ``chain`` ``csrc/apg_solve_chain.cu`` (the P=1
    register chain), with ``bf16`` ``csrc/apg_solve_bf16.cu`` (the
    bf16-trunk particle forms), with ``p1_step`` ``csrc/apg_solve_p1.cu``
    (the P=1 wide step; with ``wide_inputs`` too ``csrc/apg_solve_p1x.cu``,
    its forms over more than 16 trunk inputs), with ``part_global``
    ``csrc/apg_solve_gw.cu`` (``csrc/apg_solve_gw_bf16.cu`` with ``bf16``:
    the particle global-weight forms). Each answers the shared-memory and ABI
    queries of every form."""
    if part_global:
        name = "apg_solve_gw_bf16" if bf16 else "apg_solve_gw"
    elif chain:
        name = "apg_solve_chain"
    elif p1_step and wide_inputs:
        name = "apg_solve_p1x"
    else:
        name = "apg_solve_bf16" if bf16 else "apg_solve_p1" if p1_step else "apg_solve"
    lib = load_library(name)
    lib.apg_args_size.argtypes = []
    lib.apg_args_size.restype = ctypes.c_int
    lib.apg_smem_bytes.argtypes = [ctypes.POINTER(ApgArgs)]
    lib.apg_smem_bytes.restype = ctypes.c_int
    lib.apg_p1_form.argtypes = [ctypes.POINTER(ApgArgs)]
    lib.apg_p1_form.restype = ctypes.c_int
    lib.apg_part_form.argtypes = [ctypes.POINTER(ApgArgs)]
    lib.apg_part_form.restype = ctypes.c_int
    lib.apg_error_string.argtypes = [ctypes.c_int]
    lib.apg_error_string.restype = ctypes.c_char_p
    lib.apg_init.argtypes = []
    lib.apg_init.restype = ctypes.c_int
    lib.apg_solve_launch.argtypes = [ctypes.POINTER(ApgArgs)] + [_P] * 11
    lib.apg_solve_launch.restype = ctypes.c_int
    lib.apg_solve_prof_launch.argtypes = [ctypes.POINTER(ApgArgs)] + [_P] * 11
    lib.apg_solve_prof_launch.restype = ctypes.c_int
    lib.apg_cluster_max.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.apg_cluster_max.restype = ctypes.c_int
    lib.apg_max_active_clusters.argtypes = [ctypes.POINTER(ApgArgs),
                                            ctypes.POINTER(ctypes.c_int)]
    lib.apg_max_active_clusters.restype = ctypes.c_int
    lib.apg_resident_blocks.argtypes = [ctypes.POINTER(ApgArgs), ctypes.POINTER(ctypes.c_int)]
    lib.apg_resident_blocks.restype = ctypes.c_int
    lib.apg_scratch_floats.argtypes = [ctypes.POINTER(ApgArgs)]
    lib.apg_scratch_floats.restype = ctypes.c_longlong
    if lib.apg_args_size() != ctypes.sizeof(ApgArgs):
        raise RuntimeError(
            f"ApgArgs ABI mismatch: library {lib.apg_args_size()} bytes, "
            f"Python {ctypes.sizeof(ApgArgs)} bytes")
    rc = lib.apg_init()
    if rc != 0:
        raise RuntimeError("apg_init failed: " + lib.apg_error_string(rc).decode())
    return lib


def plan_solve_particles(args: ApgArgs, num_particles: int, chunk: int,
                         cluster: int = 0, prof: bool = False) -> None:
    """Fill the particle and cluster fields of a solve's ``args``: ``chunk``,
    or the largest divisor of P whose shared memory (``apg_smem_bytes``)
    fits the 227 KB budget of the particle form, the shared-memory form at
    every chunk first and the global-weight form only where none fits
    (``consts.plan_particles``); C = min(n_chunks, C_max) blocks, C_max the
    form's largest cluster (``apg_cluster_max``; the clock-stamped form's
    with ``prof``, the options form's where ``args`` has risk or starts; the
    bf16 library's with ``args.bf16``; the global-weight library's for that
    form) or ``cluster`` when it is given."""
    lib = load_apg_library(bool(args.bf16))

    def c_max(form: int) -> int:
        if form == P1_GLOBAL:
            if prof:
                raise ValueError("apg_phase_split: the clock-stamped build has no "
                                 "global-weight form (a trunk past the particle form's "
                                 "shared memory)")
            most = load_apg_library(bool(args.bf16), part_global=True).apg_cluster_max(
                args.sc_kind, 0, 1)
        else:
            most = lib.apg_cluster_max(args.sc_kind, int(prof), has_options(args))
        if cluster and not 1 <= cluster <= most:
            raise ValueError(f"cluster={cluster}: the particle form takes 1 to {most} blocks")
        return cluster or most

    plan_particles(args, num_particles, chunk,
                   lambda a: lib.apg_smem_bytes(ctypes.byref(a)), SMEM_LIMIT_PARTICLES,
                   c_max)


def _check_scope(model: NeuralSDE, cp: CostParams, apg: APGConfig,
                 lb: torch.Tensor) -> None:
    """What the kernel takes."""
    nZ = model.n_u + cp.n_slack
    if lb.shape[-1] != nZ:
        raise ValueError(
            f"apg_solve_kernel: the box must have nZ={nZ} columns (n_u={model.n_u} "
            f"controls and {cp.n_slack} slack targets), got {lb.shape[-1]}")
    if not apg.use_linesearch:
        raise ValueError(
            "apg_solve_kernel runs the linesearch APG; a config without "
            "apg_mpc.linesearch is the fixed-step solver, which runs "
            "solver/apg.py::apg_solve over the cost oracle (engine/mpc_loader.py)")


def apg_solve_plain(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                    apg: APGConfig, time_steps: torch.Tensor, x0: torch.Tensor,
                    x_ref: torch.Tensor, u_prev: torch.Tensor, noise,
                    num_particles: int, lb: torch.Tensor, ub: torch.Tensor,
                    u_init: torch.Tensor, t_init: Optional[torch.Tensor] = None,
                    precond: Optional[torch.Tensor] = None,
                    iter_budget: Optional[int] = None,
                    chunk: int = 0, cluster: int = 0,
                    starts: Optional[torch.Tensor] = None,
                    bf16: bool = False) -> Tuple[APGState, torch.Tensor]:
    """Plain PyTorch version of :func:`apg_solve_kernel` (any device); the
    particle mean is unchunked, so ``cluster`` (a launch detail) is
    unused."""
    _check_scope(model, cp, apg, lb)
    oracle = cost_oracle_plain(model, params, cp, time_steps, x0, x_ref, u_prev,
                               noise, num_particles, apg.maxls, chunk=chunk, starts=starts,
                               bf16=bf16)
    with torch.no_grad():
        st = apg_solve(oracle, u_init, lb, ub, apg, t_init=t_init,
                       precond=precond, iter_budget=iter_budget)
        x_evol = oracle.trajectory(st.yk)
    return st, x_evol


def _launch(lib: ctypes.CDLL, args: ApgArgs, consts: torch.Tensor,
            u_init: torch.Tensor, t0: torch.Tensor,
            precond: Optional[torch.Tensor], noise: Optional[torch.Tensor],
            starts: Optional[torch.Tensor], stream: int,
            prof: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Allocate the outputs and launch ``args.batch`` solves; returns (yk
    (B, H, nZ), stats (B, 8), x_evol (B, H+1, 13)), x_evol None for the
    particle form. With ``prof`` (int64 (2, 8)) the clock-stamped
    instantiation runs (one scenario) and writes its cycle sums there."""
    limit = (SMEM_LIMIT_PARTICLES
             if args.has_noise or args.sc_kind != SC_NONE or not p1_widths(args.F, args.HID)
             else SMEM_LIMIT)
    need = lib.apg_smem_bytes(ctypes.byref(args))
    if need > limit:
        raise ValueError(f"apg_solve_kernel needs {need} bytes of shared "
                         f"memory, above the {limit}-byte budget")
    B, H, nZ = args.batch, args.H, args.nZ
    kw = dict(dtype=torch.float32, device=u_init.device)
    yk = torch.empty((B, H, nZ), **kw)
    stats = torch.empty((B, 8), **kw)
    x_evol = None if args.has_noise else torch.empty((B, H + 1, 13), **kw)
    # the spread's slots and counters (consts.plan_groups), zeroed by the
    # launcher, or the P=1 wide step's buffers past 227 KB
    n_scratch = lib.apg_scratch_floats(ctypes.byref(args))
    scratch = torch.empty(n_scratch, **kw) if n_scratch else None
    ptr = lambda t: None if t is None else t.data_ptr()
    common = (ctypes.byref(args), consts.data_ptr(), u_init.data_ptr(), t0.data_ptr(),
              ptr(precond), ptr(noise), ptr(starts), yk.data_ptr(), stats.data_ptr(),
              ptr(x_evol))
    rc = (lib.apg_solve_launch(*common, ptr(scratch), stream) if prof is None
          else lib.apg_solve_prof_launch(*common, prof.data_ptr(), stream))
    if rc != 0:
        raise RuntimeError("apg_solve_kernel launch failed: "
                           + lib.apg_error_string(rc).decode())
    return yk, stats, x_evol


def apg_solve_kernel(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                     apg: APGConfig, time_steps: torch.Tensor, x0: torch.Tensor,
                     x_ref: torch.Tensor, u_prev: torch.Tensor, noise,
                     num_particles: int, lb: torch.Tensor, ub: torch.Tensor,
                     u_init: torch.Tensor, t_init: Optional[torch.Tensor] = None,
                     precond: Optional[torch.Tensor] = None,
                     iter_budget: Optional[int] = None,
                     chunk: int = 0, cluster: int = 0,
                     starts: Optional[torch.Tensor] = None,
                     bf16: bool = False) -> Tuple[APGState, torch.Tensor]:
    """One fused APG solve -> ``(APGState, x_evol)``.

    Inputs as ``pallas_apg_solve``: ``noise`` the (P, H, 13) Brownian block
    of a Monte-Carlo solve (None for the mean dynamics of P=1), ``u_init``
    (H, nZ) the warm start, ``lb``/``ub`` the (nZ,) box, ``t_init`` the
    carried stepsize (non-positive -> ``init_stepsize``), ``precond`` an
    optional (H, nZ) diagonal metric,
    ``iter_budget`` an optional host-side iteration cap, ``chunk`` the
    particle chunk (0: the largest divisor of P that fits), ``cluster`` the
    most blocks of the particle form's cluster (0: the card's largest, and
    the global-weight form's spread; given: one cluster a scenario, so 1
    sweeps every chunk in one block, the same bits), ``starts`` the (P, 13)
    particles' initial states of a Monte-Carlo solve (None: all at
    ``x0``; the cost's ``risk_lambda`` is read from ``cp``), ``bf16`` the
    module docstring's. CPU tensors run :func:`apg_solve_plain`. On the card
    this is the launch of :func:`apg_solve_kernel_batched` at B = 1.
    """
    dev = x0.device
    if dev.type == "cpu":
        return apg_solve_plain(model, params, cp, apg, time_steps, x0, x_ref,
                               u_prev, noise, num_particles, lb, ub, u_init,
                               t_init, precond, iter_budget, chunk, cluster, starts, bf16)
    out = _solo_on_card(model, params, cp, apg, time_steps, x0, x_ref, u_prev, noise,
                        num_particles, lb, ub, u_init, t_init, precond, iter_budget, chunk,
                        cluster, starts, bf16)
    _count(bf16)
    return out


def apg_solve_plain_batched(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                            apg: APGConfig, time_steps: torch.Tensor, x0: torch.Tensor,
                            x_ref: torch.Tensor, u_prev: torch.Tensor, noise,
                            num_particles: int, lb: torch.Tensor, ub: torch.Tensor,
                            u_init: torch.Tensor, t_init: Optional[torch.Tensor] = None,
                            precond: Optional[torch.Tensor] = None,
                            iter_budget: Optional[int] = None, chunk: int = 0,
                            cluster: int = 0, starts: Optional[torch.Tensor] = None,
                            bf16: bool = False) -> Tuple[APGState, torch.Tensor]:
    """Plain version of :func:`apg_solve_kernel_batched` (any device):
    :func:`apg_solve_plain` once per scenario (with its own tracking weights
    where they carry a scenario axis), the results stacked."""
    sols = [apg_solve_plain(model, params, scenario_cost(cp, b), apg, time_steps, x0[b],
                            x_ref[b], u_prev[b], None if noise is None else noise[b],
                            num_particles, lb, ub,
                            u_init[b], None if t_init is None else t_init[b], precond,
                            iter_budget, chunk, cluster,
                            None if starts is None else starts[b], bf16)
            for b in range(int(x0.shape[0]))]
    st = APGState(*(torch.stack(f) for f in zip(*(s for s, _ in sols))))
    return st, torch.stack([x for _, x in sols])


def apg_solve_kernel_batched(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                             apg: APGConfig, time_steps: torch.Tensor, x0: torch.Tensor,
                             x_ref: torch.Tensor, u_prev: torch.Tensor, noise,
                             num_particles: int, lb: torch.Tensor, ub: torch.Tensor,
                             u_init: torch.Tensor, t_init: Optional[torch.Tensor] = None,
                             precond: Optional[torch.Tensor] = None,
                             iter_budget: Optional[int] = None, chunk: int = 0,
                             cluster: int = 0, starts: Optional[torch.Tensor] = None,
                             bf16: bool = False) -> Tuple[APGState, torch.Tensor]:
    """B independent solves of one problem family -> ``(APGState, x_evol)``,
    every field with a leading B and ``x_evol`` (B, H+1, 13): the
    counterpart of the JAX package's vmap of the solve
    (``parallel/batched.py:60-70``).

    Per scenario: ``x0`` (B, 13), ``x_ref`` (B, H+1, 13), ``u_prev`` (B, n_u)
    (or wider: the first n_u columns are read), ``noise`` (B, P, H, 13) or
    None at P=1, ``starts`` (B, P, 13) or None, ``u_init`` (B, H, nZ),
    ``t_init`` (B,) or None, and the tracking weights of ``cp`` where they
    carry a (B,) axis (``cost/cost.py``); ``bf16`` the module docstring's. The box,
    ``params`` (the trunk, which the P=1 form with its weights in device
    memory and the particle global-weight form read once, scenario 0's, for
    every scenario), ``precond``, ``iter_budget`` and
    the particle plan are shared. On the card
    one launch of the whole-solve kernel over a grid of B scenarios (one
    block, or one cluster of C blocks, each, with its own loop and early
    exit), counted as one launch, then at P>1 one batched ``trajectory``
    launch; the consts are the (B, n_consts) buffer of
    :func:`~sde4mbrl_px4_tpu_torch.ops.cuda.consts.batch_consts`. Scenario
    b's bits are those of its solo :func:`apg_solve_kernel`. CPU tensors run
    :func:`apg_solve_plain_batched`.
    """
    if x0.device.type == "cpu":
        return apg_solve_plain_batched(model, params, cp, apg, time_steps, x0, x_ref,
                                       u_prev, noise, num_particles, lb, ub, u_init, t_init,
                                       precond, iter_budget, chunk, cluster, starts, bf16)
    out = _solve_on_card(model, params, cp, apg, time_steps, x0, x_ref, u_prev, noise,
                         num_particles, lb, ub, u_init, t_init, precond, iter_budget, chunk,
                         cluster, starts, bf16)
    _count(bf16)
    return out


def _count(bf16: bool) -> None:
    apg_solve_kernel.launches += 1
    apg_solve_kernel.launches_bf16 += int(bool(bf16))


def _solo_on_card(model, params, cp, apg, time_steps, x0, x_ref, u_prev, noise,
                  num_particles, lb, ub, u_init, t_init, precond, iter_budget, chunk,
                  cluster, starts, bf16, prof: Optional[torch.Tensor] = None
                  ) -> Tuple[APGState, torch.Tensor]:
    """One solve as the batched launch at B = 1."""
    one = lambda t: None if t is None else t[None]
    st, x_evol = _solve_on_card(model, params, cp, apg, time_steps, one(x0), one(x_ref),
                                one(u_prev), one(noise), num_particles, lb, ub, one(u_init),
                                t_init, precond, iter_budget, chunk, cluster, one(starts),
                                bf16, prof)
    return APGState(*(f[0] for f in st)), x_evol[0]


def _solve_on_card(model, params, cp, apg, time_steps, x0, x_ref, u_prev, noise,
                   num_particles, lb, ub, u_init, t_init, precond, iter_budget, chunk,
                   cluster, starts, bf16, prof: Optional[torch.Tensor] = None
                   ) -> Tuple[APGState, torch.Tensor]:
    """B solves on the card (the inputs' leading axis), in one launch."""
    dev = x0.device
    if dev.type != "cuda":
        raise ValueError(f"apg_solve_kernel: unsupported device {dev}")
    B, H, n = int(x0.shape[0]), int(time_steps.shape[0]), model.n_u + cp.n_slack
    if B < 1:
        raise ValueError("apg_solve_kernel_batched: no scenario (B = 0)")
    P, _, chunk = resolve_particles(None, num_particles, True, chunk, H, dev)
    z = None
    if P > 1:
        if noise is None:
            raise ValueError(f"a Monte-Carlo solve (num_particles={P}) needs its "
                             f"Brownian block: noise (P, H, 13), got None")
        if (noise.device != dev or noise.dtype != torch.float32
                or tuple(noise.shape) != (B, P, H, 13)):
            raise ValueError(f"apg_solve_kernel: noise must be float32 {(B, P, H, 13)} on "
                             f"{dev}, got {noise.dtype} {tuple(noise.shape)} on "
                             f"{noise.device}")
        z = noise.transpose(1, 2).contiguous()          # (B, H, P, 13)
    else:
        starts = None                 # the mean dynamics start at x0
        if bf16:
            raise ValueError("apg_solve_kernel: the P=1 form has no bf16 trunk (the JAX "
                             "package runs P=1 on its kernel, at HIGHEST)")
    _check_scope(model, cp, apg, lb)
    for name, t, shape in (("x0", x0, (B, 13)), ("x_ref", x_ref, (B, H + 1, 13)),
                           ("starts", starts, (B, P, 13)),
                           ("u_init", u_init, (B, H, n)), ("lb", lb, (n,)),
                           ("ub", ub, (n,)), ("time_steps", time_steps, (H,)),
                           ("precond", precond, (H, n))):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"apg_solve_kernel: {name} must be float32 {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if u_prev.device != dev or u_prev.dim() != 2 or u_prev.shape[0] != B:
        raise ValueError(f"apg_solve_kernel: u_prev must be (B={B}, n_u) on {dev}, "
                         f"got {tuple(u_prev.shape)} on {u_prev.device}")
    for name, t in (("u_init", u_init), ("precond", precond), ("starts", starts)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"apg_solve_kernel: {name} must be contiguous")
    if bf16 and prof is not None:
        raise ValueError("apg_phase_split: the clock-stamped build has no bf16 trunk")
    consts, args = build_consts(model, params, cp, apg, time_steps, x0[0], x_ref[0],
                                u_prev[0], lb, ub, has_pre=precond is not None,
                                iter_budget=iter_budget, particles=z is not None)
    chain = z is None and p1_widths(args.F, args.HID)
    wide = z is None and not chain
    lib = load_apg_library(bool(bf16), wide, chain=chain,
                           wide_inputs=wide and p1_wide_inputs(args.F))
    weights = scenario_weights(cp, B)
    if B > 1:
        consts = batch_consts(consts, args, x0, x_ref, u_prev, weights)
    args.has_starts = int(starts is not None)
    args.bf16 = int(bool(bf16))
    glob = False
    if z is not None:
        plan_solve_particles(args, P, chunk, cluster, prof is not None)
        glob = lib.apg_part_form(ctypes.byref(args)) == P1_GLOBAL
        if glob:
            lib = load_apg_library(bool(bf16), part_global=True)
            if not cluster:
                n = ctypes.c_int(0)
                rc = lib.apg_resident_blocks(ctypes.byref(args), ctypes.byref(n))
                if rc != 0:
                    raise RuntimeError("apg_resident_blocks failed: "
                                       + lib.apg_error_string(rc).decode())
                plan_groups(args, P1_GLOBAL, n.value)
    t0 = resolve_t_init(apg, t_init, dev).expand(B).contiguous()
    yk, stats, x_evol = _launch(lib, args, consts, u_init, t0, precond, z, starts,
                                torch.cuda.current_stream(dev).cuda_stream, prof)
    apg_solve_kernel.launches_global += int(glob)
    # the wide step's forms over more than 16 inputs (apg_solve_p1x.cu)
    apg_solve_kernel.launches_wide_inputs += int(wide and p1_wide_inputs(args.F)
                                                 and prof is None)
    if glob:
        n = args.groups * args.cluster
        apg_solve_kernel.blocks_global[n] = apg_solve_kernel.blocks_global.get(n, 0) + 1
    if x_evol is None:
        x_evol = trajectory_kernel(consts, args, yk)        # fp32 whatever args.bf16
    st = APGState(yk=yk, num_steps=stats[:, 0], stepsize=stats[:, 1],
                  avg_stepsize=stats[:, 2], avg_linesearch=stats[:, 3],
                  grad_sqr=stats[:, 4], init_cost=stats[:, 5], opt_cost=stats[:, 6])
    return st, x_evol


def apg_phase_split(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                    apg: APGConfig, time_steps: torch.Tensor, x0: torch.Tensor,
                    x_ref: torch.Tensor, u_prev: torch.Tensor, noise,
                    num_particles: int, lb: torch.Tensor, ub: torch.Tensor,
                    u_init: torch.Tensor, t_init: Optional[torch.Tensor] = None,
                    precond: Optional[torch.Tensor] = None,
                    iter_budget: Optional[int] = None,
                    chunk: int = 0, cluster: int = 0,
                    bf16: bool = False) -> Tuple[APGState, torch.Tensor]:
    """Measurement twin of :func:`apg_solve_kernel` (same arguments and
    result) for a solve without state constraints: it runs the
    clock-stamped instantiation of the kernel, whose thread 0 sums the SM
    cycles of each phase over the solve into ``apg_phase_split.cycles``, an
    int64 tensor on the card. P=1: (8,), the sums of :data:`PHASES`, then
    the cycles of the whole solve, then 0. Particles: (2, 8), a row for
    cluster rank 0 and one for the last rank, each the sums of
    :data:`PART_PHASES` (and an unused 0), the cycles of the whole solve,
    then the rank. Not counted in ``apg_solve_kernel.launches``; CUDA
    tensors only."""
    if sc_kind(cp) != SC_NONE:
        raise ValueError("apg_phase_split times a solve without state constraints")
    prof = torch.zeros((2, 8), dtype=torch.int64, device=x0.device)
    out = _solo_on_card(model, params, cp, apg, time_steps, x0, x_ref, u_prev, noise,
                        num_particles, lb, ub, u_init, t_init, precond, iter_budget,
                        chunk, cluster, None, bf16, prof)
    apg_phase_split.cycles = prof if int(num_particles) > 1 else prof[0]
    return out


apg_solve_kernel.launches = apg_solve_kernel.launches_bf16 = 0
apg_solve_kernel.launches_global = apg_solve_kernel.launches_wide_inputs = 0
apg_solve_kernel.blocks_global = {}
