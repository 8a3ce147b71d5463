"""The scenario-DP process sweep over 1..N gloo ranks.

The port's counterpart of ``tools/bench_scaling.py --process-sweep`` and
its worker ``tools/_scaling_worker.py``: for each process count N it runs
a fixed number of scenarios per rank of a batched solve (iris posctrl at an
``--iters`` budget) twice,

- ``dist``: N ranks of one gloo process group
  (``parallel/distributed.py::spawn_ranks``), each solving its rows of one
  batch over a (N, 1) mesh (``parallel/rank_tasks.py::scaling``);
- ``solo``: N independent processes with no group, each the same rows;

and prints each count's solves/s, the dispatch overhead of the group
against the independent processes at the same count (``1 - dist /
solo``), and the seconds from spawn to a ready mesh::

    python -m sde4mbrl_px4_tpu_torch.sim.bench_scaling --process-sweep 1,2,4 --cpu
    python -m sde4mbrl_px4_tpu_torch.sim.bench_scaling --process-sweep 1,2

Ranks run on the CPU with ``--cpu`` (one intra-op thread each), else on
``cuda:(rank % device_count)``. On one card every rank shares the one
device, so the figures measure multi-process dispatch and the sharing of
one card, not scaling: scaling figures wait for a second card (ROADMAP.md
§1, the second-card line). The result goes to ``build/scaling/scaling.json`` (``--out``);
the JAX package's committed ``SCALING.json`` is never written.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

__all__ = ["main", "process_sweep"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def process_sweep(counts, b_per_rank: int, iters: int, steps: int, cpu: bool,
                  out: Optional[str] = None, timeout: float = 900.0) -> dict:
    """Run the sweep (module docstring); returns the result it writes to
    ``out``."""
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.parallel.distributed import spawn_ranks

    out = out or os.path.join(_ROOT, "build", "scaling", "scaling.json")
    if os.path.abspath(out) == os.path.join(_ROOT, "SCALING.json"):
        raise ValueError("SCALING.json is the JAX package's committed artifact; write "
                         "elsewhere (--out)")
    cfg = load_yaml_config(os.path.join(_ROOT, "configs", "iris_posctrl_mpc.yaml"))
    cfg["apg_mpc"]["max_iter"] = iters
    cfg["apg_mpc"]["max_no_improvement_iter"] = iters
    devices = "cpu" if cpu else None

    def run(n: int, group: bool) -> list:
        kw = dict(cfg=cfg, b_per_rank=b_per_rank, steps=steps, devices=devices,
                  spawned=time.time())
        return spawn_ranks("sde4mbrl_px4_tpu_torch.parallel.rank_tasks:scaling", n, kw,
                           timeout=timeout, group=group)

    rows = []
    for n in counts:
        dist, solo = run(n, True), run(n, False)
        row = {"processes": n, "B_total": b_per_rank * n,
               "solves_per_sec": sum(r["solves_per_sec"] for r in dist),
               "solo_solves_per_sec": sum(r["solves_per_sec"] for r in solo),
               "ms_per_step": max(r["ms_per_step"] for r in dist),
               "device_ms_per_step": [r["device_ms_per_step"] for r in dist],
               "steps_per_solve": [r["steps_per_solve"] for r in dist],
               "ready_s": max(r["ready_s"] for r in dist)}
        row["dispatch_overhead_vs_solo"] = 1.0 - row["solves_per_sec"] / row["solo_solves_per_sec"]
        rows.append(row)
        print(f"processes={n}: dist {row['solves_per_sec']:.1f} vs solo "
              f"{row['solo_solves_per_sec']:.1f} solves/s (dispatch overhead "
              f"{row['dispatch_overhead_vs_solo']:.1%}), ready {row['ready_s']:.2f} s",
              flush=True)
    base = rows[0]["solves_per_sec"] / rows[0]["processes"]
    for r in rows:
        r["weak_scaling_efficiency"] = r["solves_per_sec"] / r["processes"] / base
        r["weak_scaling_efficiency_vs_solo"] = r["solves_per_sec"] / r["solo_solves_per_sec"]
    import torch

    result = {
        "workload": f"iris_posctrl batched solves, {b_per_rank} scenarios/rank, {iters} APG "
                    f"iters",
        "transport": "torch.distributed gloo over localhost, "
                     + ("CPU ranks" if cpu else "ranks sharing the visible cards"),
        "device": "cpu" if cpu else torch.cuda.get_device_name(0),
        "host_cores": os.cpu_count(),
        "note": "on one card every rank shares the device: multi-process dispatch, not "
                "scaling",
        "sweep": rows,
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.bench_scaling",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--process-sweep", default="1,2",
                    help="comma list of process counts (e.g. 1,2,4)")
    ap.add_argument("--b-per-dev", type=int, default=32, help="scenarios per rank")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--steps", type=int, default=5, help="timed warm steps")
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU")
    ap.add_argument("--out", default=None,
                    help="result file (default build/scaling/scaling.json)")
    args = ap.parse_args(argv)
    counts = [int(c) for c in args.process_sweep.split(",") if c]
    process_sweep(counts, args.b_per_dev, args.iters, args.steps, args.cpu, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
