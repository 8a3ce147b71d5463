"""Multi-process execution over ``torch.distributed`` (L6).

PyTorch counterpart of ``sde4mbrl_px4_tpu/parallel/distributed.py``
(``:45-152``). The JAX package joins its processes with
``jax.distributed`` and lets GSPMD insert the collectives; here the
processes form one gloo process group and the port's code makes its few
collectives itself, on CPU tensors (gloo takes no CUDA ``all_gather``):

- :func:`initialize_distributed` brings the group up from arguments or the
  environment (used by ``launch.py``, ``sim/tune_mppi.py``,
  ``sim/bench_scaling.py`` and :func:`spawn_ranks`' workers);
- :func:`global_mesh` is ``parallel/mesh.py::make_mesh`` over every rank;
- :func:`make_global_batch` / :func:`global_batch_inputs` give each rank
  its rows of a scenario batch that every rank derives alike;
- :func:`gather_to_host` all-gathers each rank's rows to every rank, in
  rank order; :func:`ordered_sum` sums a tensor over a mesh axis in rank
  order, so every rank holds the same bits; :func:`broadcast` sends one
  rank's tensor to its line.

NCCL is not used: it refuses two ranks on one device, and on one card
every rank shares ``cuda:0``, so collectives are staged through the host.

:func:`spawn_ranks` runs a function on N fresh processes, one rank each, on
a ``file://`` store in a temporary directory (no port to race for), and
returns each rank's result: the tests, ``chip_smoke.py`` and the tools
start their rank pairs with it. Ranks are always fresh interpreters
(``subprocess``), never forks of a process that has initialised CUDA.
"""
from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.parallel.mesh import Mesh, make_mesh, world

__all__ = ["broadcast", "gather_to_host", "global_batch_inputs", "global_mesh",
           "initialize_distributed", "is_multiprocess", "make_global_batch",
           "ordered_sum", "spawn_ranks", "world"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _init_method(address: str) -> str:
    """``host:port`` as a TCP rendezvous; a URL (``tcp://``, ``file://``,
    ``env://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: float = 300.0) -> bool:
    """Bring up the gloo process group when multi-process execution is
    asked for (the original's ``:45-87``). Each field resolves as there:
    the argument, then ``SDE4MBRL_COORDINATOR`` / ``SDE4MBRL_NUM_PROCESSES``
    / ``SDE4MBRL_PROCESS_ID``, then ``SDE4MBRL_AUTO_DISTRIBUTED=1`` (torch's
    ``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    as ``torchrun`` sets them). Returns False only when nothing asked for a
    group; True once one is up (idempotent). A world that was asked for and
    does not form within ``timeout_s`` raises: this never carries on as a
    single process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("SDE4MBRL_COORDINATOR")
    if num_processes is None and "SDE4MBRL_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SDE4MBRL_NUM_PROCESSES"])
    if process_id is None and "SDE4MBRL_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SDE4MBRL_PROCESS_ID"])
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None and num_processes is None:
        if os.environ.get("SDE4MBRL_AUTO_DISTRIBUTED") in ("1", "true"):
            dist.init_process_group("gloo", init_method="env://", timeout=timeout)
            return True
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process world needs its coordinator address, its number of "
            f"processes and this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process id {process_id} outside a world of {num_processes}")
    dist.init_process_group("gloo", init_method=_init_method(coordinator_address),
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout)
    if dist.get_world_size() != int(num_processes):
        raise RuntimeError(f"the group formed with {dist.get_world_size()} ranks, "
                           f"{num_processes} were asked for")
    return True


def is_multiprocess() -> bool:
    return world()[1] > 1


def global_mesh(shape: Optional[Tuple[int, int]] = None,
                axis_names: Sequence[str] = ("dp", "mc"), devices=None) -> Mesh:
    """The (dp, mc) mesh over every rank of the group (``make_mesh``'s
    contract; explicit about spanning the processes, as the original)."""
    return make_mesh(shape=shape, axis_names=axis_names, devices=devices)


def make_global_batch(mesh: Mesh, xs_local, rngs_local=None):
    """A rank's rows of a dp-sharded scenario batch (the original's
    ``:98-113``): each rank passes ITS rows (the global batch is their
    concatenation in rank order) and keeps them, on its device; the rows
    stay rank-local until :func:`gather_to_host`. ``rngs_local`` passes
    through (a generator draws the global batch's noise inside the solve,
    ``engine/mpc_loader.py::build_mpc``'s ``shard``)."""
    xs = torch.as_tensor(np.asarray(xs_local, np.float32)).to(mesh.device)
    return xs, rngs_local


def global_batch_inputs(mesh: Mesh, n_scenarios: int, seed: int = 0,
                        spread: float = 1.0):
    """Multi-process twin of ``parallel/batched.py::make_batch_inputs``
    (the original's ``:116-145``): every rank derives the same global batch
    from ``np.random.RandomState(seed)`` (positions by ``spread``,
    velocities by ``0.1 * spread``) and keeps its own rows. Returns
    ``(xs (B/dp, 13), rng, ts (B/dp,))`` on the rank's device; ``rng`` a
    ``torch.Generator`` seeded with ``seed``."""
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batch_inputs

    xs, gen = make_batch_inputs(n_scenarios, seed=seed, spread=spread, mesh=mesh)
    return xs, gen, torch.zeros(int(xs.shape[0]), dtype=torch.float32, device=mesh.device)


def _gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every member's ``t`` (same shape everywhere), in rank order, on the
    CPU: gloo's ``all_gather`` takes CPU tensors."""
    import torch.distributed as dist

    host = t.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return parts


def gather_to_host(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Each rank's rows of ``x`` (a tensor or array, the same shape on every
    rank), all-gathered to every rank and concatenated in rank order (the
    original's ``:148-152``); with an mc axis, the rows of each dp line
    once. Without a group: ``x`` on the host."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    if not is_multiprocess():
        return t.detach().cpu().numpy()
    parts = _gather(t)
    if mesh is not None and mesh.mc > 1:
        parts = parts[::mesh.mc]
    return torch.cat(parts).numpy()


def ordered_sum(t: torch.Tensor, mesh: Mesh, axis: str = "mc") -> torch.Tensor:
    """The sum of ``t`` over this rank's line along ``axis``, in rank order,
    on ``t``'s device: every member computes the same additions in the same
    order, so every member holds the same bits (the mesh's members stay in
    lockstep through a solve's stop tests). ``t`` itself on a line of one.
    ``ordered_sum.seconds`` / ``.calls`` count the host time spent here
    (the copy to the host included), for the collective's share."""
    if len(mesh.axis_members(axis)) == 1:
        return t
    t0 = time.perf_counter()
    parts = _gather(t, mesh.group(axis))
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    out = acc.to(t.device)
    ordered_sum.seconds += time.perf_counter() - t0
    ordered_sum.calls += 1
    return out


ordered_sum.seconds = 0.0
ordered_sum.calls = 0


def broadcast(t: Optional[torch.Tensor], shape: tuple, mesh: Mesh, axis: str = "mc",
              device=None) -> torch.Tensor:
    """The tensor of the first member of this rank's line along ``axis``
    (``t`` there, ignored elsewhere), float32 of ``shape``, on every
    member's ``device`` (through the host)."""
    import torch.distributed as dist

    members = mesh.axis_members(axis)
    if len(members) == 1:
        return t
    t0 = time.perf_counter()
    host = (t.detach().to("cpu").contiguous() if mesh.rank == members[0]
            else torch.empty(shape, dtype=torch.float32))
    dist.broadcast(host, src=members[0], group=mesh.group(axis))
    out = host.to(device if device is not None else mesh.device)
    ordered_sum.seconds += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------- rank pairs

def spawn_ranks(target: str, world_size: int, kwargs: Optional[Dict[str, Any]] = None,
                timeout: float = 300.0, threads: Optional[int] = 1,
                group: bool = True) -> List[Any]:
    """Run ``target`` (``"module:function"``) in ``world_size`` fresh
    processes, one rank each, and return each rank's return value (pickled
    back) in rank order. With ``group`` the processes form one gloo group
    on a ``file://`` store in a temporary directory before the call and
    tear it down after it (``destroy_process_group`` in a ``finally``);
    without it each runs alone (a world of one). ``threads`` caps each
    rank's intra-op threads (CPU ranks otherwise oversubscribe the host).
    A rank that fails, or a world that runs past ``timeout`` seconds, kills
    every rank and raises with the ranks' output."""
    with tempfile.TemporaryDirectory(prefix="sde4mbrl_ranks_") as td:
        with open(os.path.join(td, "kwargs.pkl"), "wb") as f:
            pickle.dump(kwargs or {}, f)
        run_env = dict(os.environ)
        run_env["PYTHONPATH"] = _ROOT + os.pathsep + run_env.get("PYTHONPATH", "")
        if threads:
            run_env["OMP_NUM_THREADS"] = str(threads)
        procs = []
        for r in range(world_size):
            cmd = [sys.executable, "-m", "sde4mbrl_px4_tpu_torch.parallel.distributed",
                   target, td, str(r), str(world_size), str(threads or 0),
                   "group" if group else "solo"]
            out = open(os.path.join(td, f"rank{r}.log"), "w+")
            procs.append((subprocess.Popen(cmd, cwd=_ROOT, env=run_env, stdout=out,
                                           stderr=subprocess.STDOUT), out))
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            for p, _ in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    timed_out = True
                    break
                if p.returncode != 0:
                    break
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = []
        for _, out in procs:
            out.seek(0)
            logs.append(out.read())
            out.close()
        failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
        if timed_out or failed:
            tails = "\n".join(f"--- rank {r} (rc {procs[r][0].returncode}) ---\n{lg[-3000:]}"
                              for r, lg in enumerate(logs))
            what = f"ran past {timeout:.0f} s" if timed_out else f"rank(s) {failed} failed"
            raise RuntimeError(f"spawn_ranks({target}, {world_size}): {what}\n{tails}")
        results = []
        for r in range(world_size):
            with open(os.path.join(td, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_main(argv: List[str]) -> int:
    """One rank of :func:`spawn_ranks`: ``target dir rank world threads
    group|solo``."""
    target, td, rank, world_size, threads, mode = argv
    rank, world_size, threads = int(rank), int(world_size), int(threads)
    if threads:
        torch.set_num_threads(threads)
    with open(os.path.join(td, "kwargs.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    module, fn = target.split(":")
    func = getattr(importlib.import_module(module), fn)
    grouped = mode == "group"
    if grouped:
        initialize_distributed(f"file://{os.path.join(td, 'store')}", world_size, rank)
    try:
        result = func(**kwargs)
    finally:
        if grouped:
            import torch.distributed as dist

            dist.destroy_process_group()
    with open(os.path.join(td, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    # the package's copy of this module, so a rank's counters are the ones
    # its target imports
    from sde4mbrl_px4_tpu_torch.parallel import distributed as _self

    sys.exit(_self._rank_main(sys.argv[1:]))
