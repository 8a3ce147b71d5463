"""Whole-solve APG: the hand-written Hopper kernel and its plain version.

:func:`apg_solve_kernel` is the counterpart of
``sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py::pallas_apg_solve`` and takes
its inputs: one receding-horizon solve, returned as ``(APGState, x_evol)``
where ``x_evol`` (H+1, 13) is the mean trajectory of the best iterate. On
CUDA tensors it launches ``csrc/apg_solve.cu`` (one thread block, on the
current stream, no sync) or raises; on CPU tensors it runs
:func:`apg_solve_plain`, the same function in plain PyTorch
(``solver/apg.py::apg_solve`` over ``rollout_sde`` + ``cost_fn`` with
autograd for the gradient, ``rollout_mean`` for ``x_evol``).

Scope (the flight configs): deterministic P=1, no state constraints, no
slack columns, no particle chunks; anything else raises.
``apg_solve_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from sde4mbrl_px4_tpu_torch.cost.cost import CostParams, make_cost_fn
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
from sde4mbrl_px4_tpu_torch.ops.cuda.build import load_library
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import ApgArgs, build_consts
from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean, rollout_sde
from sde4mbrl_px4_tpu_torch.solver.apg import (
    APGConfig, APGState, apg_solve, resolve_t_init)

__all__ = ["apg_solve_kernel", "apg_solve_plain", "load_apg_library",
           "SMEM_LIMIT"]

SMEM_LIMIT = 49152   # bytes of shared memory the kernel may use (48 KB)
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def load_apg_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/apg_solve.cu``."""
    lib = load_library("apg_solve")
    lib.apg_args_size.argtypes = []
    lib.apg_args_size.restype = ctypes.c_int
    lib.apg_smem_bytes.argtypes = [ctypes.POINTER(ApgArgs)]
    lib.apg_smem_bytes.restype = ctypes.c_int
    lib.apg_error_string.argtypes = [ctypes.c_int]
    lib.apg_error_string.restype = ctypes.c_char_p
    lib.apg_solve_launch.argtypes = [ctypes.POINTER(ApgArgs)] + [_P] * 8
    lib.apg_solve_launch.restype = ctypes.c_int
    if lib.apg_args_size() != ctypes.sizeof(ApgArgs):
        raise RuntimeError(
            f"ApgArgs ABI mismatch: library {lib.apg_args_size()} bytes, "
            f"Python {ctypes.sizeof(ApgArgs)} bytes")
    return lib


def _check_scope(model: NeuralSDE, apg: APGConfig, noise, num_particles: int,
                 chunk: int, lb: torch.Tensor) -> None:
    if noise is not None or int(num_particles) != 1:
        raise NotImplementedError(
            "apg_solve_kernel: only the deterministic P=1 solve is ported "
            f"(num_particles={num_particles}, noise "
            f"{'given' if noise is not None else 'None'}); ROADMAP.md §1 'Particles' "
            "brings the rest")
    if chunk:
        raise NotImplementedError(
            "apg_solve_kernel: particle chunks (K11) are not ported; "
            "ROADMAP.md §1 'Particles' brings them")
    if lb.shape[-1] != model.n_u:
        raise NotImplementedError(
            "apg_solve_kernel: slack decision columns (slack_proximal state "
            "constraints) are not ported; ROADMAP.md §1 'State constraints "
            "and slack' brings them")
    if not apg.use_linesearch:
        raise NotImplementedError("apg_solve_kernel needs the linesearch block")


def apg_solve_plain(model: NeuralSDE, params: Dict[str, Any], cp: CostParams,
                    apg: APGConfig, time_steps: torch.Tensor, x0: torch.Tensor,
                    x_ref: torch.Tensor, u_prev: torch.Tensor, noise,
                    num_particles: int, lb: torch.Tensor, ub: torch.Tensor,
                    u_init: torch.Tensor, t_init: Optional[torch.Tensor] = None,
                    precond: Optional[torch.Tensor] = None,
                    iter_budget: Optional[int] = None,
                    chunk: int = 0) -> Tuple[APGState, torch.Tensor]:
    """Plain PyTorch version of :func:`apg_solve_kernel` (any device)."""
    _check_scope(model, apg, noise, num_particles, chunk, lb)
    H = int(time_steps.shape[0])
    zeros = torch.zeros((H, 1, 13), dtype=torch.float32, device=x0.device)
    cost_fn = make_cost_fn(cp, time_steps)
    u_prev = u_prev[: model.n_u]

    def seq_cost(u):
        xp, sg = rollout_sde(model, params, x0, u, time_steps, zeros)
        return cost_fn(xp, sg, u, x_ref, u_prev)

    def value_and_grad(u):
        with torch.enable_grad():
            u_ = u.detach().requires_grad_(True)
            f = seq_cost(u_)
            (g,) = torch.autograd.grad(f, u_)
        return f.detach(), g

    value_batch = torch.func.vmap(seq_cost)
    with torch.no_grad():
        st = apg_solve(value_and_grad, value_batch, u_init, lb, ub, apg,
                       t_init=t_init, precond=precond, iter_budget=iter_budget)
        x_evol = rollout_mean(model, params, x0, st.yk, time_steps)
    return st, x_evol


def _launch(lib: ctypes.CDLL, args: ApgArgs, consts: torch.Tensor,
            u_init: torch.Tensor, t0: torch.Tensor,
            precond: Optional[torch.Tensor], stream: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Allocate the outputs and launch one solve; returns (yk, stats, x_evol)."""
    need = lib.apg_smem_bytes(ctypes.byref(args))
    if need > SMEM_LIMIT:
        raise ValueError(f"apg_solve_kernel needs {need} bytes of shared "
                         f"memory, above the {SMEM_LIMIT}-byte budget")
    H, nZ = args.H, args.nZ
    kw = dict(dtype=torch.float32, device=u_init.device)
    yk = torch.empty((H, nZ), **kw)
    stats = torch.empty(8, **kw)
    x_evol = torch.empty((H + 1, 13), **kw)
    rc = lib.apg_solve_launch(
        ctypes.byref(args), consts.data_ptr(), u_init.data_ptr(), t0.data_ptr(),
        None if precond is None else precond.data_ptr(), yk.data_ptr(),
        stats.data_ptr(), x_evol.data_ptr(), stream)
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
                     chunk: int = 0) -> Tuple[APGState, torch.Tensor]:
    """One fused APG solve -> ``(APGState, x_evol)``.

    Inputs as ``pallas_apg_solve``: ``noise`` must be None (P=1 runs the
    mean dynamics), ``u_init`` (H, n_u) is the warm start, ``t_init`` the carried
    stepsize (non-positive -> ``init_stepsize``), ``precond`` an optional
    (H, n_u) diagonal metric, ``iter_budget`` an optional host-side
    iteration cap. CPU tensors run :func:`apg_solve_plain`.
    """
    dev = x0.device
    if dev.type == "cpu":
        return apg_solve_plain(model, params, cp, apg, time_steps, x0, x_ref,
                               u_prev, noise, num_particles, lb, ub, u_init,
                               t_init, precond, iter_budget, chunk)
    if dev.type != "cuda":
        raise ValueError(f"apg_solve_kernel: unsupported device {dev}")
    _check_scope(model, apg, noise, num_particles, chunk, lb)
    H, n = int(time_steps.shape[0]), model.n_u
    for name, t, shape in (("x0", x0, (13,)), ("x_ref", x_ref, (H + 1, 13)),
                           ("u_init", u_init, (H, n)), ("lb", lb, (n,)),
                           ("ub", ub, (n,)), ("time_steps", time_steps, (H,)),
                           ("precond", precond, (H, n))):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"apg_solve_kernel: {name} must be float32 {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("u_init", u_init), ("precond", precond)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"apg_solve_kernel: {name} must be contiguous")
    lib = load_apg_library()
    consts, args = build_consts(model, params, cp, apg, time_steps, x0, x_ref,
                                u_prev, lb, ub, has_pre=precond is not None,
                                iter_budget=iter_budget)
    t0 = resolve_t_init(apg, t_init, dev)
    yk, stats, x_evol = _launch(lib, args, consts, u_init, t0, precond,
                                torch.cuda.current_stream(dev).cuda_stream)
    apg_solve_kernel.launches += 1
    st = APGState(yk=yk, num_steps=stats[0], stepsize=stats[1],
                  avg_stepsize=stats[2], avg_linesearch=stats[3],
                  grad_sqr=stats[4], init_cost=stats[5], opt_cost=stats[6])
    return st, x_evol


apg_solve_kernel.launches = 0
