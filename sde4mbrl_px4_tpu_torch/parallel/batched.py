"""Batched scenario solves on one card (L6).

PyTorch counterpart of ``sde4mbrl_px4_tpu/parallel/batched.py``
(``make_batched_mpc`` ``:32-133``, ``make_batch_inputs`` ``:136-156``): B
independent receding-horizon solves of one config per call, with the JAX
package's call signatures::

    batched_reset, batched_mpc, bundle = make_batched_mpc(cfg)
    opt_states = batched_reset(xs, rngs, xdes)           # APGState, fields (B, ...)
    sol = batched_mpc(xs, rngs, opt_states, curr_ts, xdes)
    # sol.u_opt (B, H, n_u), sol.opt_state [B], sol.rng, sol.x_evol (B, H+1, 13)

The JAX package vmaps the solve over the batch and shards it over the mesh's
``dp`` axis, on XLA. Here the batch is the scenario axis of the whole-solve
kernel (``ops/cuda/apg_kernel.py::apg_solve_kernel_batched``): one launch of
B blocks (P=1) or B thread-block clusters (particles, then one batched
``trajectory`` launch for ``x_evol``), each scenario with its own loop and
early exit, so each scenario's plan is its solo solve's, as the JAX package
holds its vmapped solves to theirs (``tests/test_sharding.py:44-88``). The
per-scenario pieces (the tilt-scaled warm start, the reference, the ENU
targets, the warm-start shift, the stepsize carry) are
``engine/mpc_loader.py``'s (:class:`~sde4mbrl_px4_tpu_torch.engine.mpc_loader.MPCPieces`)
over a leading B. The JAX package donates the warm starts; here they stay
on the device from call to call and PyTorch's caching allocator recycles
their blocks (no host round trip, no input mutated). ``device=None`` is the
card (without one this raises); ``device="cpu"`` runs the plain version,
one solve per scenario.

``rngs``: at P=1 they are unused and passed through; at P>1 a
``torch.Generator`` (each call draws the (B, H, P, 13) Brownian block in
one call) or an iterator of (B, P, H, 13) blocks, which is how tests hand in
the JAX package's per-scenario draws.

Refused, naming the ROADMAP.md item that brings them: ``solver: mppi`` and
configs without an ``apg_mpc.linesearch`` block ('Batched oracle routes':
their solves run on the cost-oracle kernels, which have no scenario axis
yet) and ``solver: policy`` ('Policy solver family'). Not ported:
``make_particle_sharded_mpc``, ``mesh.py`` and ``distributed.py``, which
shard one solve or the batch over several devices; they wait for more than
one GPU (ROADMAP.md item 9).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.types import MPCSolution, hover_state
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import MPCBundle, build_mpc, not_in_slice
from sde4mbrl_px4_tpu_torch.ops.cuda.apg_kernel import apg_solve_kernel_batched
from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian
from sde4mbrl_px4_tpu_torch.solver.apg import APGState

__all__ = ["make_batched_mpc", "make_batch_inputs"]

BATCHED_ORACLE_ROUTES = "Batched oracle routes"


def make_batched_mpc(cfg: Dict[str, Any], convert_to_enu: bool = True,
                     device: Optional[torch.device | str] = None
                     ) -> Tuple[Callable, Callable, MPCBundle]:
    """Build ``(batched_reset, batched_mpc, bundle)`` for ``cfg`` on one
    device (module docstring). Inputs may be numpy arrays or tensors; tensors
    already on the device are used as they are (no copy, no sync)."""
    cfg = dict(cfg)
    if str(cfg.get("solver", "apg")) == "mppi":
        raise not_in_slice("batched solver: mppi", BATCHED_ORACLE_ROUTES)
    cfg, bundle, pieces = build_mpc(cfg, convert_to_enu, device)
    if not bundle.apg_config.use_linesearch:
        raise not_in_slice("batched fixed-step APG (no apg_mpc.linesearch)",
                           BATCHED_ORACLE_ROUTES)
    dev, f32 = bundle.device, torch.float32
    H, P, n_u = int(bundle.time_steps.shape[0]), bundle.num_particles, bundle.model.n_u

    def batched_reset(xs, rngs, xdes) -> APGState:
        """Each scenario's warm start from its state: fields (B, ...)."""
        return pieces.reset(torch.as_tensor(xs, dtype=f32, device=dev), rngs, xdes)

    def brownian(rngs, B: int) -> torch.Tensor:
        """The call's (B, P, H, 13) Brownian block on the device: one draw of
        (B, H, P, 13) from a generator (the view transposed), or the next
        block an iterator hands in."""
        if isinstance(rngs, torch.Generator):
            z = draw_brownian(rngs, B * H, P, pieces.antithetic, dev)
            return z.reshape(B, H, P, 13).transpose(1, 2)
        if rngs is None:
            raise ValueError("num_particles > 1 needs rngs: a torch.Generator or an "
                             "iterator of (B, P, H, 13) Brownian blocks")
        return next(rngs).to(dev, f32)

    def batched_mpc(xs, rngs, opt_states: APGState, curr_ts, xdes=None) -> MPCSolution:
        """B solves in one launch; ``xdes`` (B, 13) in the config's frame
        (None: hold ``xs``), ``curr_ts`` (B,) the scenarios' times on the
        trajectory."""
        xs = torch.as_tensor(xs, dtype=f32, device=dev)
        B = int(xs.shape[0])
        xdes = xs if xdes is None else torch.as_tensor(xdes, dtype=f32, device=dev)
        curr_ts = torch.as_tensor(curr_ts, dtype=f32, device=dev)
        x_ref = pieces.build_ref(curr_ts, pieces.targets(xdes))
        noise = brownian(rngs, B) if P > 1 else None
        st, x_evol = apg_solve_kernel_batched(
            bundle.model, bundle.params, bundle.cost_params, bundle.apg_config,
            bundle.time_steps, xs, x_ref, opt_states.yk[:, 0], noise, P, bundle.lb_z,
            bundle.ub_z, opt_states.yk,
            t_init=opt_states.stepsize if pieces.carry_t else None,
            precond=bundle.precond, chunk=pieces.chunk)
        return MPCSolution(u_opt=st.yk[..., :n_u], opt_state=st._replace(yk=pieces.shift(st.yk)),
                           rng=rngs, x_evol=x_evol)

    return batched_reset, batched_mpc, bundle


def make_batch_inputs(n_scenarios: int, seed: int = 0, base_state=None,
                      spread: float = 1.0, device: Optional[torch.device | str] = None
                      ) -> Tuple[torch.Tensor, torch.Generator]:
    """``(xs (B, 13), rng)``: hover states (or ``base_state``) perturbed by
    the JAX package's ``np.random.RandomState(seed)`` draws (positions by
    ``spread``, velocities by ``0.1 * spread``; ``batched.py:136-156``), so
    both packages get the same ``xs``, on ``device`` (None: the card), and a
    CPU generator seeded with ``seed`` for the particle draws (the JAX
    package's per-scenario keys have no torch twin)."""
    from sde4mbrl_px4_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    base = np.asarray(hover_state() if base_state is None else base_state, np.float32)
    rs = np.random.RandomState(seed)
    xs = np.tile(base, (n_scenarios, 1)).astype(np.float32)
    xs[:, 0:3] += spread * rs.randn(n_scenarios, 3).astype(np.float32)
    xs[:, 3:6] += 0.1 * spread * rs.randn(n_scenarios, 3).astype(np.float32)
    return torch.from_numpy(xs).to(dev), torch.Generator().manual_seed(seed)
