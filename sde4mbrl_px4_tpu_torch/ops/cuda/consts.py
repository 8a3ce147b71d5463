"""The whole-solve kernel's ABI: one flat fp32 consts buffer plus an
argument struct of dimensions, options, offsets and config scalars.

Port of ``sde4mbrl_px4_tpu/ops/pallas/solve_kernels.py::build_consts``
(``:71-184``, K7): the constants every sweep of the solve reads (initial
state, the horizon of reference states, the previous control, the effective
mixer, inertia, per-step dt and discount, cost weights and scalars, the
decision box, the ``state_constr`` block of either form, and last the trunk
weights). :class:`ApgArgs` mirrors
``csrc/apg_solve.cuh::ApgArgs`` field for field; each library's
``*_args_size()`` is checked against it when it is loaded. One layout
serves all four kernels: the whole-solve kernel and the three cost-oracle
kernels (``csrc/cost_oracle.cu``), which read the same buffer and ignore
the solver fields. The Monte-Carlo particles' Brownian block is not part of
the buffer (at P=512 it is 532 KB, more than a block's shared memory): the
kernels read it from device memory, and :func:`plan_particles` fills the
particle fields (P, the chunk Pc, the number of chunks) and the cluster
fields (:func:`plan_cluster`): the particle forms of the whole solve and of
``value_and_grad`` run one thread-block cluster of ``cluster`` blocks per
launch, ``value_batch`` one per candidate (:func:`value_batch_grid`), block
``rank`` of a cluster sweeping chunks ``rank, rank + cluster, ...``.

State constraints (``solve_kernels.py:119-174``): ``sc_kind`` selects the
kernels' compile-time form (:data:`SC_NONE`, :data:`SC_PENALTY`,
:data:`SC_PROX`). The penalty block is ``pen13'`` (``constr_pen`` folded
in, as the TPU kernel ships it), ``lo13``, ``hi13``, ``inv13``; the
proximal block is ``penm``, ``invm`` and the m state ids (as floats), and
the decision row widens to ``nZ = n_u + m`` with the box ``lb``/``ub``
nZ wide. ``u_prev`` is packed ``n_u`` wide: only the control columns carry
effort and slew terms.

The particle options: ``cost_params.risk_lambda`` rides at the end of the
config scalars (``csrc/apg_solve.cuh`` ``SC_RISK``) and sets ``ApgArgs.risk``
on a particle solve (``build_consts(..., particles=True)``); the starts of
``initial_state_std`` are not part of the buffer: the kernels read them from
an optional (B, P, 13) device array beside the Brownian block, and the
wrappers set ``ApgArgs.has_starts`` when they pass one. A particle launch
with either option runs the kernels' options form (:func:`has_options`).
``ApgArgs.risk_mode`` (0 unless a wrapper sets it) is where the oracle's
risk launches take the moments of the particles' totals: the
particle-sharded solve's ``value_batch`` writes each plan's risk-free cost
and the moments of its block of particles out (:data:`RISK_MOMENTS_OUT`),
its ``value_and_grad`` reads the moments over all particles in
(:data:`RISK_MOMENTS_IN`); those are the oracle's shared-moments forms.

``ApgArgs.bf16`` (set by the wrappers, not by :func:`build_consts`): the
trunk's three products on bf16-rounded operands, the JAX package's
``matmul_precision: default`` on its TPU. The kernels round the weights in
their shared-memory copy of the consts; the buffer itself stays fp32, so the
``trajectory`` launch of the same solve reads the fp32 weights.

The P=1 forms: a trunk of the register chain's widths (64 hidden units, at
most 16 inputs, :func:`p1_widths`) runs the chain (:data:`P1_CHAIN`); any
other runs a step on any width (the whole solve and ``value_and_grad`` the
wide step, ``value_batch`` and ``trajectory`` the shared-memory step), with
the weights in the block's copy of the consts (:data:`P1_SMEM`) where that
kernel's block fits 227 KB with them, else read from device memory
(:data:`P1_GLOBAL`), for which the
buffer ends with the trunk (``w0, b0, w1, b1, w2, b2``): the kernels copy
the ``o_w0`` floats before it. Each library picks the form of each launch
from its dimensions (``csrc/apg_solve.cuh::p1_form``; ``apg_p1_form`` and
``oracle_p1_form`` report it); :func:`build_consts` leaves
``ApgArgs.step`` at :data:`P1_BY_SHAPE`, which asks for that choice. A
launch given a form by name (``step``, for measurement) takes it or is
refused. Past 227 KB with the weights in device memory (624 units on the
iris traj config in the whole solve, 896 in ``value_and_grad``) the wide
step keeps its width-sized buffers in the launch's scratch in device
memory, so it takes any width. It takes any number of trunk inputs: past
:data:`P1_FMAX` (eight motors or more) in forms of their own
(:func:`p1_wide_inputs`), whose layer 0 reads the inputs past the first 16
from the row's controls, in libraries of their own (the whole solve's
``csrc/apg_solve_p1x.cu``; ``value_and_grad``'s with every other P=1 form of
the oracle in ``csrc/cost_oracle_p1.cu``).

The particle forms' trunk: the weights, and their transposes for the
reverse sweep, in the block's copy of the consts (:data:`P1_SMEM`, every
trunk up to 144 units at P=512 on the iris configs), or read in place from
device memory with only the consts before them copied
(:data:`P1_GLOBAL`, the global-weight forms: any width). Each library picks
the form of a launch from its dimensions and chunk
(``csrc/apg_solve.cuh::part_form``; ``apg_part_form`` and
``oracle_part_form`` report it), and :func:`plan_particles` plans the chunk
in the shared-memory form first, so the global-weight form runs only where
no chunk of the other fits. A form named in ``ApgArgs.step`` (for
measurement) is planned alone and taken or refused at launch.

The spread (``ApgArgs.groups``): the global-weight forms of the whole
solve, ``value_and_grad`` and ``value_batch`` run a scenario (for
``value_batch`` each of a scenario's K plans) on ``groups * cluster``
blocks, block j sweeping chunks ``j, j + groups * cluster, ...``
(:func:`scenario_chunks`); past one cluster the blocks are plain blocks of
a cooperative grid, their chunk partials summed in chunk order through
slots in device memory (``csrc/sweeps.cuh``, the spread note; the launch's
scratch, :func:`spread_floats`), so the bits are those of one cluster.
:func:`plan_groups` picks ``groups`` after the form: 1 for every other form,
and for those the most that keep every block of the launch resident at
once on the card.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from sde4mbrl_px4_tpu_torch.cost.cost import CostParams, discount_vector, tracking_weights
from sde4mbrl_px4_tpu_torch.device import host_values
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
from sde4mbrl_px4_tpu_torch.solver.apg import APGConfig, df_powers

__all__ = ["APG_MAXK", "OPT_MOMENTS", "ORACLE_P1_ROWS", "ORACLE_TILE", "ORACLE_TRAJECTORY",
           "ORACLE_VALUE_AND_GRAD", "ORACLE_VALUE_BATCH", "P1_BY_SHAPE", "P1_CHAIN", "P1_FMAX",
           "P1_GLOBAL", "P1_HID", "P1_SMEM", "RISK_IN_CLUSTER", "RISK_MOMENTS_IN",
           "RISK_MOMENTS_OUT", "SMEM_LIMIT_PARTICLES", "SC_NONE", "SC_PENALTY", "SC_PROX",
           "SPREAD_CTR", "ApgArgs", "batch_consts", "build_consts", "has_options", "opt_form",
           "p1_wide_inputs", "p1_widths", "plan_cluster", "plan_groups", "plan_particles",
           "sc_kind", "scenario_chunks", "scenario_weights", "spread_floats",
           "value_batch_grid"]

APG_MAXK = 8  # csrc/apg_solve.cuh
# the P=1 register chain holds the trunk in registers at these widths: hidden
# units, and the most inputs 9 + n_u (csrc/apg_solve.cuh P1_HID, P1_FMAX)
P1_HID, P1_FMAX = 64, 16
# the trunk's forms (csrc/apg_solve.cuh P1_*, ApgArgs.step): the libraries'
# choice by shape, the register chain, a step on any width with the weights
# in shared memory (the whole solve and value_and_grad the wide step,
# value_batch and trajectory the shared-memory step), and that step with the
# weights in device memory (the particle forms: the last two)
P1_BY_SHAPE, P1_CHAIN, P1_SMEM, P1_GLOBAL = -1, 0, 1, 2
# the spread's scratch: each unit's arrival counter SPREAD_CTR 4-byte words
# apart (csrc/apg_solve.cuh SPREAD_CTR, spread_floats)
SPREAD_CTR = 32
# shared memory a block of a particle form may take: 227 KB, all of an sm_90
# block's (csrc/apg_solve.cuh APG_SMEM_LIMIT_PARTICLES)
SMEM_LIMIT_PARTICLES = 232448
# the kernels' state-constraint forms (csrc/apg_solve.cuh CONSTR_*)
SC_NONE, SC_PENALTY, SC_PROX = 0, 1, 2
# the cost-oracle kernels (csrc/cost_oracle.cuh): which kernel a query is
# for, and the candidate rows of a P=1 value_batch block on the register
# chain and on the shared-memory step
ORACLE_VALUE_BATCH, ORACLE_TRAJECTORY, ORACLE_VALUE_AND_GRAD = 0, 1, 2
ORACLE_P1_ROWS, ORACLE_TILE = APG_MAXK, 16
# where a risk launch of the oracle kernels takes the moments of its
# particles' totals (csrc/apg_solve.cuh RISK_*, ApgArgs.risk_mode): from its
# own cluster; written out (value_batch); read in (value_and_grad)
RISK_IN_CLUSTER, RISK_MOMENTS_OUT, RISK_MOMENTS_IN = 0, 1, 2
# the shared-moments forms' `opt` in a query of the oracle's largest cluster
# (oracle_cluster_max; 0 and 1 are has_options's)
OPT_MOMENTS = 2

_INT_FIELDS = (
    "H", "n_u", "nZ", "K", "F", "HID", "OUT",
    "P", "Pc", "n_chunks", "has_noise",
    "max_iter", "max_no_imp", "budget", "has_budget", "has_pre", "has_slew",
    "reset_opt", "mom_restart", "has_moment_scale",
    "o_x0", "o_xref", "o_uprev", "o_w0", "o_b0", "o_w1", "o_b1", "o_w2",
    "o_b2", "o_mix", "o_inertia", "o_ts", "o_disc", "o_wstate", "o_uref",
    "o_slo", "o_shi", "o_scal", "o_lb", "o_ub", "n_consts",
)
_FLOAT_FIELDS = ("inc", "one_m_coef", "tmax", "beta_init", "moment_scale",
                 "atol", "rtol")
_SC_FIELDS = ("sc_kind", "m", "o_penm", "o_invm", "o_sid", "o_pen13", "o_lo13",
              "o_hi13", "o_inv13")
_RISK_FIELDS = ("risk", "has_starts", "risk_mode")
_BATCH_FIELDS = ("batch",)
_PRECISION_FIELDS = ("bf16",)
_CLUSTER_FIELDS = ("cluster", "chunks_per_block", "groups")
_STEP_FIELDS = ("step",)
_RESET = {"increase": 0, "conservative": 1, "bb": 2}


class ApgArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in _INT_FIELDS]
                + [(n, ctypes.c_float) for n in _FLOAT_FIELDS]
                + [("dfp", ctypes.c_float * (APG_MAXK + 1))]
                + [(n, ctypes.c_int)
                   for n in _SC_FIELDS + _RISK_FIELDS + _BATCH_FIELDS + _PRECISION_FIELDS
                   + _STEP_FIELDS + _CLUSTER_FIELDS])


def has_options(a: ApgArgs) -> int:
    """Whether a launch takes the kernels' particle-options form (1 with risk
    or starts, ``csrc/apg_solve.cuh::options``)."""
    return int(bool(a.risk or a.has_starts))


def opt_form(a: ApgArgs) -> int:
    """The oracle's particle form of a launch for ``oracle_cluster_max``:
    :data:`OPT_MOMENTS` where ``a.risk_mode`` shares the risk moments,
    else :func:`has_options`."""
    return OPT_MOMENTS if a.risk_mode else has_options(a)


def sc_kind(cp: CostParams) -> int:
    """The kernels' state-constraint form of a cost."""
    if cp.slack_sel is not None:
        return SC_PROX
    return SC_NONE if cp.state_pen13 is None else SC_PENALTY


def _constraint_pieces(cp: CostParams) -> tuple:
    """The consts of the state-constraint block (``solve_kernels.py:157-172``)."""
    kind = sc_kind(cp)
    if kind == SC_PROX:
        ids = torch.argmax(cp.slack_sel, dim=1).to(torch.float32)
        return (("penm", cp.slack_pen), ("invm", cp.slack_inv_scale), ("sid", ids))
    if kind == SC_PENALTY:
        pen = host_values(cp.constr_pen, cp.state_pen13.device) * cp.state_pen13
        return (("pen13", pen), ("lo13", cp.state_lo13), ("hi13", cp.state_hi13),
                ("inv13", cp.state_inv_scale13))
    return ()


def p1_widths(F: int, HID: int) -> bool:
    """Whether the P=1 register chain takes a (F, HID) trunk."""
    return HID == P1_HID and F <= P1_FMAX


def p1_wide_inputs(F: int) -> bool:
    """Whether a P=1 whole solve or ``value_and_grad`` on the wide step takes
    its forms over more than :data:`P1_FMAX` trunk inputs (9 + n_u, n_u > 7
    motors; ``csrc/sweeps.cuh::wide_rollout``'s FX): the forms of up to 16
    hold a row's features in registers, these read the rest from the row's
    controls. The register chain takes at most 16 (:func:`p1_widths`);
    ``value_batch``, ``trajectory`` and the particle forms take any number in
    one form."""
    return int(F) > P1_FMAX


def build_consts(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                 apg: Optional[APGConfig], time_steps: torch.Tensor,
                 x0: torch.Tensor, x_ref: torch.Tensor, u_prev: torch.Tensor,
                 lb: Optional[torch.Tensor] = None,
                 ub: Optional[torch.Tensor] = None, has_pre: bool = False,
                 iter_budget: Optional[int] = None,
                 particles: bool = False) -> Tuple[torch.Tensor, ApgArgs]:
    """Pack the consts buffer on the tensors' device (one ``torch.cat``, no
    host sync) and fill the argument struct. Without an ``apg`` config (the
    cost oracle) the solver fields are zero; without a box the ``lb``/``ub``
    blocks hold -inf/+inf. Tracking weights with a scenario axis put
    scenario 0's in the buffer (:func:`batch_consts` writes the others).
    The box is nZ wide (``n_u`` plus the proximal form's slack columns). ``particles`` (a Monte-Carlo solve) turns on the
    risk reduction where the cost has ``risk_lambda``; at P=1 the cost is
    the mean dynamics' and the risk term is 0, as in the original. The
    trunk's weights close the buffer; ``step`` asks the libraries for
    the trunk's form by shape (module docstring)."""
    if apg is not None and apg.maxls > APG_MAXK:
        raise ValueError(f"maxls={apg.maxls} exceeds the kernel's {APG_MAXK}")
    f32 = torch.float32
    H = int(time_steps.shape[0])
    n = model.n_u
    nZ = n + cp.n_slack
    net = params["net"]
    HID, OUT = int(net["w1"].shape[0]), int(net["w2"].shape[1])
    mix_eff = model.mixing * torch.exp(params["motor"]["log_gain"])[:, None]
    # per-scenario weights (B, 12): scenario 0's here, the rest by batch_consts
    wstate = tracking_weights(cp).reshape(-1, 12)[0]
    if cp.u_slew_constr is not None:
        slo, shi = cp.u_slew_constr[:, 0], cp.u_slew_constr[:, 1]
    else:
        slo = shi = torch.zeros(n, dtype=f32, device=x0.device)
    host = host_values([model.mass, cp.uerr, cp.u_slew_coeff, cp.u_slew_constr_coeff,
                        cp.res_mult, cp.risk_lambda or 0.0], x0.device)
    scal = torch.cat([host[:1], torch.exp(params["diffusion_log_scale"]).reshape(1),
                      host[1:]])
    if lb is None:
        lb = torch.full((nZ,), -float("inf"), dtype=f32, device=x0.device)
        ub = -lb
    pieces = (
        ("x0", x0), ("xref", x_ref), ("uprev", u_prev[:n]),
        ("mix", mix_eff), ("inertia", model.inertia), ("ts", time_steps),
        ("disc", discount_vector(cp, H, x0.device)), ("wstate", wstate),
        ("uref", cp.uref), ("slo", slo), ("shi", shi), ("scal", scal),
        ("lb", lb), ("ub", ub),
    ) + _constraint_pieces(cp) + (
        ("w0", net["w0"]), ("b0", net["b0"]), ("w1", net["w1"]),
        ("b1", net["b1"]), ("w2", net["w2"]), ("b2", net["b2"]))
    a = ApgArgs()
    off = 0
    flat = []
    for name, t in pieces:
        setattr(a, f"o_{name}", off)
        t = t.reshape(-1).to(f32)
        flat.append(t)
        off += t.numel()
    a.n_consts = off
    buf = torch.cat(flat)

    a.H, a.n_u, a.nZ = H, n, nZ
    a.sc_kind, a.m = sc_kind(cp), nZ - n
    a.risk = int(particles and cp.risk_lambda is not None)
    a.P = a.Pc = a.n_chunks = a.cluster = a.chunks_per_block = a.batch = a.groups = 1
    a.F, a.HID, a.OUT = int(net["w0"].shape[0]), HID, OUT
    a.has_slew = int(cp.u_slew_constr is not None)
    a.step = P1_BY_SHAPE
    if apg is None:
        return buf, a
    a.K = int(apg.maxls)
    a.max_iter = int(apg.max_iter)
    a.max_no_imp = int(apg.max_no_improvement_iter)
    a.has_budget = int(iter_budget is not None)
    a.budget = 0 if iter_budget is None else int(iter_budget)
    a.has_pre = int(has_pre)
    a.reset_opt = _RESET.get(apg.reset_option, 1)   # unknown -> conservative
    a.mom_restart = int(apg.momentum_restart)
    a.has_moment_scale = int(apg.moment_scale is not None)
    a.inc = apg.increase_factor
    a.one_m_coef = 1.0 - apg.coef
    a.tmax = apg.max_stepsize
    a.beta_init = apg.beta_init
    a.moment_scale = 0.0 if apg.moment_scale is None else apg.moment_scale
    a.atol, a.rtol = apg.atol, apg.rtol
    for k, v in enumerate(df_powers(apg)):
        a.dfp[k] = v
    return buf, a


def batch_consts(template: torch.Tensor, a: ApgArgs, x0: torch.Tensor,
                 x_ref: torch.Tensor, u_prev: torch.Tensor,
                 wstate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B, n_consts) consts of B scenarios that differ only in their
    initial state, reference, previous control and, with ``wstate`` (B,
    12), their tracking weights: ``template`` (one scenario's buffer from
    :func:`build_consts`) repeated on the device, with scenario b's ``x0``
    (13), ``xref`` (H+1, 13), ``uprev`` (the first n_u columns of
    ``u_prev[b]``) and ``wstate`` blocks written in. No Python loop over B,
    no host sync; sets ``a.batch = B``. Every kernel takes the result: the
    whole solve, and the oracle's ``value_batch``, ``value_and_grad`` and
    ``trajectory`` (``cost_oracle.py::cost_oracle_batched``)."""
    B, n = int(x0.shape[0]), a.n_u
    buf = template.reshape(1, -1).repeat(B, 1)
    buf[:, a.o_x0:a.o_x0 + 13] = x0
    buf[:, a.o_xref:a.o_xref + (a.H + 1) * 13] = x_ref.reshape(B, -1)
    buf[:, a.o_uprev:a.o_uprev + n] = u_prev[:, :n]
    if wstate is not None:
        if tuple(wstate.shape) != (B, 12):
            raise ValueError(f"batch_consts: per-scenario tracking weights must be ({B}, 12), "
                             f"got {tuple(wstate.shape)}")
        buf[:, a.o_wstate:a.o_wstate + 12] = wstate
    a.batch = B
    return buf


def scenario_weights(cp: CostParams, B: int) -> Optional[torch.Tensor]:
    """The (B, 12) per-scenario tracking weights of a batch of B for
    :func:`batch_consts`, or None where the weights are shared."""
    w = tracking_weights(cp)
    if w.dim() == 1:
        return None
    if int(w.shape[0]) != B:
        raise ValueError(f"per-scenario tracking weights for {int(w.shape[0])} scenarios, "
                         f"the batch has {B}")
    return w


def plan_cluster(n_chunks: int, c_max: int) -> Tuple[int, int]:
    """The cluster of a particle launch over ``n_chunks`` chunks: ``(C,
    chunks_per_block)``, C = min(n_chunks, c_max) blocks per cluster and the
    most chunks a block sweeps."""
    C = min(int(n_chunks), int(c_max))
    if C < 1:
        raise ValueError(f"a cluster of {n_chunks} chunks and at most {c_max} blocks")
    return C, -(-int(n_chunks) // C)


def plan_groups(a: ApgArgs, form: int, resident: int, plans: int = 1) -> None:
    """The spread of a particle launch whose chunk and cluster are planned
    (:func:`plan_particles`), for its form ``form`` (``ApgArgs.step`` or the
    library's ``*_part_form``): ``a.groups`` G, the clusters' worth of blocks
    each of the launch's ``a.batch * plans`` units runs on (``plans``: the
    plans of a scenario that each spread on their own, ``value_batch``'s K;
    1 for the whole solve and ``value_and_grad``, a unit a scenario), and
    ``a.chunks_per_block`` over a unit's G * C blocks. G = 1 but for the
    global-weight form (:data:`P1_GLOBAL`) of a particle launch, where G is
    the most groups with G * C <= n_chunks (every block a chunk) and units *
    G * C <= ``resident`` (every block of the launch on the card at once:
    the cooperative launch's bound, ``apg_resident_blocks``,
    ``oracle_resident_blocks``, ``value_batch_resident_blocks``), at least
    1."""
    C, units = int(a.cluster), int(a.batch) * int(plans)
    a.groups = 1
    if a.has_noise and form == P1_GLOBAL:
        a.groups = max(1, min(int(a.n_chunks) // C, int(resident) // (units * C)))
    a.chunks_per_block = -(-int(a.n_chunks) // (a.groups * C))


def spread_floats(a: ApgArgs, plans: int = 1) -> int:
    """Floats of a spread launch's scratch (``csrc/apg_solve.cuh::
    spread_floats``; ``value_batch_scratch_floats`` with ``plans`` = K): 0
    at ``groups`` 1; else per unit (``a.batch * plans`` of them) an arrival
    counter :data:`SPREAD_CTR` words wide and two regions of ``n_chunks``
    slots, each slot as wide as the widest chunk partial (H * nZ + 3, or
    3K for the whole solve's K candidates)."""
    if int(a.groups) <= 1:
        return 0
    width = max(int(a.H) * int(a.nZ) + 3, 3 * int(a.K))
    return int(a.batch) * int(plans) * (SPREAD_CTR + 2 * int(a.n_chunks) * width)


def scenario_chunks(a: ApgArgs) -> list:
    """The chunks each of a scenario's ``groups * cluster`` blocks sweeps, as
    the particle kernels assign them: block j the chunks j, j + N, ... below
    ``n_chunks`` (N = groups * cluster)."""
    n = int(a.groups) * int(a.cluster)
    return [list(range(j, int(a.n_chunks), n)) for j in range(n)]


def value_batch_grid(K: int, a: ApgArgs,
                     fits: Callable[[int], bool] = lambda rows: True) -> Tuple[int, int]:
    """The grid of one ``value_batch`` launch over K plans, as
    ``csrc/cost_oracle.cu::value_batch_launch`` builds it: ``(blocks,
    rows)``, one scenario's blocks and the candidates per block; a launch
    over ``a.batch`` scenarios B repeats them B times (at P=1 on the grid's
    y rows, scenario b's on row b; with particles as B x K clusters in
    one flat grid, cluster i plan i of the (B, K) plans). With particles K clusters of
    ``a.cluster`` blocks, one candidate each (block b sweeps candidate
    b // cluster's chunks rank, rank + cluster, ..., rank = b % cluster). At
    P=1 ceil(K / rows) blocks (block b takes candidates b*rows ..), rows at
    most ``ORACLE_P1_ROWS`` (one warp each) on a trunk of the register layout
    and ``ORACLE_TILE`` (one thread each) on others, and at most K; one less
    while ``fits(rows)`` (the block's shared memory within its form's
    budget: 48 KB on the register chain, 227 KB on the shared-memory step)
    is false."""
    if a.has_noise:
        return K * a.cluster, 1
    rows = min(int(K), ORACLE_P1_ROWS if p1_widths(a.F, a.HID) else ORACLE_TILE)
    while rows > 1 and not fits(rows):
        rows -= 1
    return -(-int(K) // rows), rows


# the particle forms by their ApgArgs.step, as plan_particles names them
_FORM_NAMES = {P1_SMEM: "the shared-memory form", P1_GLOBAL: "the global-weight form"}


def plan_particles(a: ApgArgs, num_particles: int, chunk: int,
                   need: Callable[[ApgArgs], int], limit: int,
                   c_max: Union[int, Callable[[int], int]] = 1, gw_max_chunk: int = 0) -> None:
    """Fill the particle fields of ``a`` for a Monte-Carlo solve: P paths
    swept in ``n_chunks`` passes of ``Pc`` rows, over a cluster of at most
    ``c_max`` blocks (:func:`plan_cluster`; a function of the particle form
    where the forms' largest clusters differ). ``chunk`` is the one
    ``cost_oracle.resolve_particles`` checked: a divisor of P below P, or 0,
    which takes the largest divisor of P whose shared-memory ``need(a)``
    (bytes, the block's chunk partials included; the library's count for the
    form ``a.step`` names) fits ``limit``. The shared-memory form
    (:data:`P1_SMEM`) is tried at every chunk first and the global-weight
    form (:data:`P1_GLOBAL`) only where none fits (module docstring); a
    form named in ``a.step`` is tried alone. ``gw_max_chunk`` (the oracle's
    global-weight plan, ``cost_oracle.plan_oracle_particles``): the
    global-weight form tries no chunk larger (0: every chunk), so that a
    plan has chunks enough for the spread's blocks. ``a.step`` is left as
    it came: the libraries take the planned form by shape. Raises ValueError,
    naming the width and the bytes, when nothing fits."""
    P = int(num_particles)
    a.P, a.has_noise = P, 1
    sizes = [chunk] if chunk else [d for d in range(P, 0, -1) if P % d == 0]
    named = a.step
    forms = (P1_SMEM, P1_GLOBAL) if named == P1_BY_SHAPE else (named,)
    cmax = c_max if callable(c_max) else (lambda form: c_max)
    tried = []
    try:
        for form in forms:
            a.step = form
            small = [d for d in sizes if d <= gw_max_chunk]
            for pc in (small or sizes[-1:]) if form == P1_GLOBAL and gw_max_chunk else sizes:
                a.Pc, a.n_chunks = pc, P // pc
                a.cluster, a.chunks_per_block = plan_cluster(a.n_chunks, cmax(form))
                a.groups = 1
                if need(a) <= limit:
                    return
            tried.append(f"{need(a)} bytes ({_FORM_NAMES.get(form, f'form {form}')})")
    finally:
        a.step = named
    raise ValueError(f"P={P} on a {a.HID}-unit trunk (F={a.F}) in chunks of {a.Pc} needs "
                     f"{' or '.join(tried)} of shared memory per block, above the "
                     f"{limit}-byte budget")
