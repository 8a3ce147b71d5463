"""Batched scenario solves on one card and over a mesh of ranks (L6).

PyTorch counterpart of ``sde4mbrl_px4_tpu/parallel/batched.py``
(``make_batched_mpc`` ``:32-133``, ``make_batch_inputs`` ``:136-156``,
``make_particle_sharded_mpc`` ``:161-171``): B
independent receding-horizon solves of one config per call, with the JAX
package's call signatures::

    batched_reset, batched_mpc, bundle = make_batched_mpc(cfg)
    opt_states = batched_reset(xs, rngs, xdes)           # APGState, fields (B, ...)
    sol = batched_mpc(xs, rngs, opt_states, curr_ts, xdes)
    # sol.u_opt (B, H, n_u), sol.opt_state [B], sol.rng, sol.x_evol (B, H+1, 13)

The JAX package vmaps the solve over the batch and shards it over the mesh's
``dp`` axis, on XLA. Here ``batched_mpc`` is the loader's solve
(``engine/mpc_loader.py::build_mpc``, ``MPCPieces.solve``), whose B = 1
is the solo ``mpc_fn``: the same route choice and pieces, with the batch
on the scenario axis of the kernels (the loader's docstring lists the
routes). On the card every kernel call is one launch over the B scenarios
(the whole solve one launch of B blocks or B thread-block clusters; an
MPPI round one ``value_batch`` of B x K plans), each scenario with its own
loop, stop tests, softmax and temperature. The network of ``solver:
policy`` runs once over (B, feat), and the hybrid's cold-start select is
on the device.

So each scenario's plan is its solo solve's, as the JAX package holds its
vmapped solves to theirs (``tests/test_sharding.py:44-88``): bit for bit
on the kernels (the network's plans to fp32 rounding: a batched matrix
product takes another order than a single row's). The JAX package donates
the warm starts; here they stay on the device from call to call and
PyTorch's caching allocator recycles their blocks (no host round trip, no
input mutated). ``device=None`` is the card (without one this raises);
``device="cpu"`` runs the plain version (the linesearch route one solo
plain solve per scenario; the oracle routes the batched solvers over the
plain oracle of each scenario).

``rngs``: at P=1 the APG and policy routes draw nothing and pass them
through; at P>1 a ``torch.Generator`` (each call draws the (B, H, P, 13)
Brownian block in one call) or an iterator of (B, P, H, 13) blocks, which
is how tests hand in the JAX package's per-scenario draws. ``solver:
mppi`` draws each call's (B, iters, K, H, nZ) and (B, iters, K, nZ)
exploration noise from the generator in one call, or takes the next
``(eps, c0)`` pair of such an iterator. The particle options ride the same
scenario axis: with ``initial_state_std`` each call also draws the (B, P,
13) ``z0`` of every scenario's starts (after the block; an iterator hands
``(noise, z0)``, MPPI ``(eps, c0, noise[, z0])``), the starts go to the
kernels as one (B, P, 13) array, and ``risk_lambda`` is one of the cost's
scalars, the same for every scenario (the loader's docstring has the
order). The tuner (``tuning/tuner.py``) serves its candidates on the same
axis: each scenario its own MPPI knobs or tracking weights.

Over a mesh (``parallel/mesh.py``, the ranks of a gloo process group):

- ``make_batched_mpc(cfg, mesh)``: each rank solves its B/dp rows
  (``mesh.rows``) on its own device through the same ``MPCPieces.solve``,
  one launch of the kernels over its rows, with no collective inside a
  solve: a rank stops when its own scenarios converge (the counterpart of
  the original's ``local_loop`` ``shard_map``, ``:46-58``, ``:84-116``).
  Inputs and results are the rank's rows; ``parallel/distributed.py::
  gather_to_host`` assembles them. A scenario's draws are its rows of the
  global batch's draws (``build_mpc``'s ``shard``), so they do not depend
  on the mesh shape.
- ``make_particle_sharded_mpc(cfg, mesh)`` (the original's ``:161-171``):
  one solve whose P particles are split over the mc axis. Every rank draws
  the same (P, H, 13) block and evaluates its P/mc particles (the
  particle forms of ``value_and_grad`` and ``value_batch`` on the card);
  the ranks' partial means are summed in rank order every evaluation, so
  every rank takes the same steps and stops on the same test of the
  linesearch loop, which runs on the host (``solver/apg.py::
  apg_solve_batched``, as the original leaves its kernels for XLA when the
  particle axis is sharded, ``engine/mpc_loader.py:312-313``). ``x_evol``
  is rank 0's ``trajectory`` launch, broadcast. With ``risk_lambda`` the
  risk term's moments span every rank's particles: each evaluation first
  gathers every rank's ``(f, m, v)`` (the oracle's moments-out
  ``value_batch``) in rank order and combines them (Chan's formula,
  ``cost/cost.py::combine_risk_moments``), and a gradient then weighs each
  rank's rows with the combined mean and std (the moments-in
  ``value_and_grad``) before its partials are summed: the JAX package's
  function over all P particles, whose moments XLA lowers to ``psum``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.types import MPCSolution, hover_state
from sde4mbrl_px4_tpu_torch.cost.cost import CostParams
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import MPCBundle, _one, build_mpc
from sde4mbrl_px4_tpu_torch.parallel.mesh import Mesh
from sde4mbrl_px4_tpu_torch.solver.apg import APGState
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig

__all__ = ["make_batched_mpc", "make_batch_inputs", "make_particle_sharded_mpc"]


def make_batched_mpc(cfg: Dict[str, Any], mesh: Optional[Mesh] = None,
                     convert_to_enu: bool = True,
                     device: Optional[torch.device | str] = None,
                     mppi_params: Optional[MPPIConfig] = None,
                     state_from_traj: Optional[Callable] = None,
                     cost_params_override: Optional[CostParams] = None
                     ) -> Tuple[Callable, Callable, MPCBundle]:
    """Build ``(batched_reset, batched_mpc, bundle)`` for ``cfg`` on one
    device, or on this rank's rows of a ``mesh``'s dp axis, on the mesh's
    device (module docstring). Inputs may be numpy arrays or tensors;
    tensors already on the device are used as they are (no copy, no sync).
    The loader's tuner hooks give each scenario its own MPPI knobs
    (``mppi_params`` with (B,) tensors) or tracking weights
    (``cost_params_override`` with (B, 3) rows; ``engine/mpc_loader.py``),
    a rank's rows of them over a mesh."""
    shard = (0, 1)
    if mesh is not None:
        device, shard = mesh.device, (mesh.dp_index, mesh.dp)
    cfg, bundle, pieces = build_mpc(dict(cfg), convert_to_enu, device, mppi_params,
                                    state_from_traj, cost_params_override, shard=shard)
    dev = bundle.device

    def batched_reset(xs, rngs, xdes) -> APGState:
        """Each scenario's warm start from its state: fields (B, ...)."""
        return pieces.reset(torch.as_tensor(xs, dtype=torch.float32, device=dev), rngs, xdes)

    def batched_mpc(xs, rngs, opt_states: APGState, curr_ts, xdes=None) -> MPCSolution:
        """B solves, each evaluation one launch over them; ``xdes`` (B, 13)
        in the config's frame (None: hold ``xs``), ``curr_ts`` (B,) the
        scenarios' times on the trajectory."""
        return pieces.solve(xs, rngs, opt_states, curr_ts, xdes)

    return batched_reset, batched_mpc, bundle


def make_batch_inputs(n_scenarios: int, seed: int = 0, base_state=None,
                      spread: float = 1.0, device: Optional[torch.device | str] = None,
                      mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Generator]:
    """``(xs (B, 13), rng)``: hover states (or ``base_state``) perturbed by
    the JAX package's ``np.random.RandomState(seed)`` draws (positions by
    ``spread``, velocities by ``0.1 * spread``; ``batched.py:136-156``), so
    both packages get the same ``xs``, on ``device`` (None: the card), and a
    CPU generator seeded with ``seed`` for the particle draws (the JAX
    package's per-scenario keys have no torch twin). With a ``mesh``: this
    rank's rows of those ``xs``, on the mesh's device."""
    from sde4mbrl_px4_tpu_torch.device import resolve_device

    dev = resolve_device(mesh.device if mesh is not None else device)
    base = np.asarray(hover_state() if base_state is None else base_state, np.float32)
    rs = np.random.RandomState(seed)
    xs = np.tile(base, (n_scenarios, 1)).astype(np.float32)
    xs[:, 0:3] += spread * rs.randn(n_scenarios, 3).astype(np.float32)
    xs[:, 3:6] += 0.1 * spread * rs.randn(n_scenarios, 3).astype(np.float32)
    if mesh is not None:
        xs = xs[mesh.rows(n_scenarios)]
    return torch.from_numpy(xs).to(dev), torch.Generator().manual_seed(seed)


def make_particle_sharded_mpc(cfg: Dict[str, Any], mesh: Mesh, convert_to_enu: bool = True
                              ) -> Tuple[Callable, Callable, MPCBundle]:
    """``(reset_fn, mpc_fn, bundle)`` of one solve whose particles are split
    over ``mesh``'s mc axis (module docstring), on the mesh's device, with
    the solo ``mpc_fn``'s signature (the loader's). Every rank of an mc
    line calls ``mpc_fn`` with the same inputs and the same generator (or
    iterator of the whole (P, H, 13) blocks) and gets the same solution."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import ParticleShard
    from sde4mbrl_px4_tpu_torch.parallel.distributed import broadcast, ordered_sum

    dev = mesh.device
    mesh.group("mc")                     # every rank builds the groups here
    shard = ParticleShard(
        index=mesh.mc_index, count=mesh.mc,
        reduce=lambda t: ordered_sum(t, mesh, "mc"),
        broadcast=lambda t, shape: broadcast(t, shape, mesh, "mc", device=dev))
    cfg, bundle, pieces = build_mpc(dict(cfg), convert_to_enu, dev, particle_shard=shard)
    f32 = torch.float32

    def mpc_fn(x, rng, opt_state: APGState, curr_t=0.0, xdes=None,
               iter_budget: Optional[int] = None) -> MPCSolution:
        x = torch.as_tensor(x, dtype=f32, device=dev)[None]
        xdes = None if xdes is None else torch.as_tensor(xdes, dtype=f32, device=dev)[None]
        curr_t = torch.as_tensor(curr_t, dtype=f32, device=dev).reshape(1)
        draws = rng if rng is None or isinstance(rng, torch.Generator) else map(_one, rng)
        sol = pieces.solve(x, draws, APGState(*(f[None] for f in opt_state)), curr_t, xdes,
                           iter_budget)
        return MPCSolution(u_opt=sol.u_opt[0],
                           opt_state=APGState(*(f[0] for f in sol.opt_state)),
                           rng=rng, x_evol=sol.x_evol[0])

    return pieces.reset, mpc_fn, bundle
