"""Preflight check of the port: verify a deployment host before flight.

PyTorch-port counterpart of ``tools/preflight.py``. The reference's
operational discipline is a manual preflight (parameter pushes, graduated
engagement, the safety box; ``basic_control.py``); this tool checks the
companion computer's side in one command and says what is missing.

    python -m sde4mbrl_px4_tpu_torch.sim.preflight [--config-dir configs] [--solve]
                                                   [--ports] [--cpu]

Checks (each prints ok or FAIL; the exit code is the number of failures):

  deps      torch, numpy and yaml import (JAX is not needed)
  native    csrc/libmpc_native.so is built and exports the codec, geometric
            controller, mailbox and router symbols (``make -C csrc``)
  configs   every ``*_mpc.yaml`` parses and its model checkpoint loads
  trajs     the trajectory CSVs load and sample
  device    the card as ``nvidia-smi`` names it, with its power limit; FAIL
            without a card unless ``--cpu``
  solve     (``--solve``) one solve of ``iris_traj_mpc.yaml`` through
            ``mpc_fn``: on the card one launch of the whole-solve kernel
            (``apg_solve``), with ``--cpu`` the plain version
  ports     (``--ports``) the SITL stack's UDP ports are free

The JAX tool's check of committed AOT artifacts has no counterpart: the
port builds its kernels with ``nvcc`` on first use (ROADMAP.md item 17),
and the output says so.
"""
from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time
from typing import Callable, Optional

__all__ = ["NATIVE_SYMBOLS", "SITL_PORTS", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SYMBOLS = ("mav_frame_decode", "geo_control_update", "mbx_open", "router_new",
                  "router_add_uart", "router_set_log")
SITL_PORTS = (14550, 14996, 14997, 14998, 14999)


def _check(name: str, fn: Callable[[], Optional[str]]) -> bool:
    try:
        detail = fn() or ""
    except Exception as e:  # noqa: BLE001 — a preflight reports every failure
        print(f"  FAIL  {name:28s} {type(e).__name__}: {e}", flush=True)
        return False
    print(f"  ok    {name:28s} {detail}", flush=True)
    return True


def _deps() -> str:
    import numpy
    import torch
    import yaml  # noqa: F401

    return f"torch {torch.__version__} (CUDA {torch.version.cuda}), numpy {numpy.__version__}"


def _native() -> str:
    from sde4mbrl_px4_tpu_torch.io.mavlink import load_native

    lib = load_native()
    if lib is None:
        raise FileNotFoundError("csrc/libmpc_native.so missing: run `make -C csrc`")
    missing = [s for s in NATIVE_SYMBOLS if not hasattr(lib, s)]
    if missing:
        raise RuntimeError(f"stale library, missing {missing}: rebuild with `make -C csrc`")
    return "codec + geometric + mailbox + router (UDP, UART, flight log)"


def _configs(yamls: list, cfg_dir: str) -> str:
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params

    if not yamls:
        raise FileNotFoundError(f"no *_mpc.yaml under {cfg_dir}")
    seen = set()
    for y in yamls:
        pkl = load_yaml_config(y).get("learned_model_params")
        if pkl and pkl not in seen:
            seen.add(pkl)
            load_params(pkl)
    return f"{len(yamls)} configs, {len(seen)} checkpoints"


def _trajs(cfg_dir: str) -> str:
    from sde4mbrl_px4_tpu_torch.models.trajectory import (
        load_trajectory_csv, make_state_from_traj)

    csvs = sorted(glob.glob(os.path.join(cfg_dir, "trajs", "*.csv")))
    for c in csvs:
        x = make_state_from_traj(load_trajectory_csv(c))(0.0)
        if tuple(x.shape) != (13,):
            raise ValueError(f"{c}: a sample has shape {tuple(x.shape)}, not (13,)")
    return f"{len(csvs)} trajectories sample cleanly"


def _device(cpu: bool) -> str:
    import torch

    if cpu:
        return "cpu (asked for with --cpu; the card is not checked)"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is false); pass --cpu "
                           "to check the host without one")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return (f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)} "
            f"({r.stdout.strip().splitlines()[0]})")


def _solve(cfg_dir: str, cpu: bool) -> str:
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    t0 = time.perf_counter()
    _, (reset_fn, mpc_fn), sft, _ = load_mpc_from_cfgfile(
        os.path.join(cfg_dir, "iris_traj_mpc.yaml"), device="cpu" if cpu else None)
    t_build = time.perf_counter() - t0
    x = enu2ned(sft(0.0))
    st = reset_fn(x, None, x)
    n0 = AK.apg_solve_kernel.launches
    t0 = time.perf_counter()
    sol = mpc_fn(x, None, st, 0.0, x)
    if x.is_cuda:
        torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = AK.apg_solve_kernel.launches - n0
    if not bool(torch.isfinite(sol.u_opt).all()):
        raise FloatingPointError("the plan is not finite")
    if x.is_cuda and launches != 1:
        raise RuntimeError(f"the solve made {launches} apg_solve launches, not 1")
    return (f"iris_traj_mpc.yaml on {x.device}: built in {t_build:.1f} s, solved in "
            f"{t_solve:.2f} s at {int(sol.opt_state.num_steps)} iterations, "
            f"{launches} apg_solve launch{'' if launches == 1 else 'es'}")


def _ports() -> str:
    import socket

    busy = []
    for port in SITL_PORTS:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                busy.append(port)
    if busy:
        raise OSError(f"ports in use: {busy}")
    return "/".join(str(p) for p in SITL_PORTS) + " free"


def main(argv: Optional[list] = None) -> int:
    """Run the checks; returns the number of failures."""
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.preflight",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-dir", default=os.path.join(_ROOT, "configs"))
    ap.add_argument("--solve", action="store_true",
                    help="also build and run one solve of iris_traj_mpc.yaml")
    ap.add_argument("--ports", action="store_true",
                    help="check the SITL stack's UDP ports are free")
    ap.add_argument("--cpu", action="store_true",
                    help="check the host without a card; --solve runs on the CPU")
    args = ap.parse_args(argv)
    cfg_dir = args.config_dir
    yamls = sorted(glob.glob(os.path.join(cfg_dir, "*_mpc.yaml")))
    checks = [("python deps", _deps), ("native runtime", _native),
              ("MPC configs + checkpoints", lambda: _configs(yamls, cfg_dir)),
              ("trajectories", lambda: _trajs(cfg_dir)),
              ("device", lambda: _device(args.cpu))]
    if args.solve:
        checks.append(("end-to-end solve", lambda: _solve(cfg_dir, args.cpu)))
    if args.ports:
        checks.append(("UDP ports", _ports))
    fails = sum(not _check(name, fn) for name, fn in checks)
    print(f"  --    {'committed AOT artifacts':28s} not checked: the port builds its "
          f"kernels with nvcc on first use (ROADMAP.md item 17)", flush=True)
    print("PREFLIGHT PASS" if fails == 0 else f"PREFLIGHT: {fails} FAILURE(S)", flush=True)
    return fails


if __name__ == "__main__":
    sys.exit(main())
