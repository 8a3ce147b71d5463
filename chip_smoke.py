"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — config -> ``mpc_fn`` -> the hand-written
whole-solve CUDA kernel -> time-indexed plan pickup — through
``RecedingHorizonController`` on the card, for both iris flight configs,
and checks it. Phases (each prints a line; any failure raises and the
script exits non-zero without a result):

1. needs ``torch.cuda.is_available()``; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. builds the kernel from ``sde4mbrl_px4_tpu_torch/csrc`` (nvcc) and
   prints the build seconds and the compiler's register/spill summary;
3. holds the kernel against its plain PyTorch version on the card: the
   fixed-budget solves of the CPU tests (traj max_iter=10 at rtol 2e-4 /
   atol 2e-5, posctrl max_iter=8 at rtol 5e-4 / atol 5e-5, plus the traj
   solve as it flies with its hover_diag metric), equal iteration counts,
   and ``x_evol`` against the mean rollout of the kernel's plan (rtol 1e-5);
4. runs the slice: a controller per replay on ``cuda`` replays
   ``replay_pos``, ``replay_traj`` and the 42-tick ``replay_engagement``
   against the committed iris goldens at the gates of ``bench.py:250``
   (the engagement's cost is printed, not gated: see ``phase_slice``);
   the kernel's launch count, set to 0 just before, must equal the number
   of solves, and JAX must never be imported;
5. times the chained pos and traj replays per solve (p50 over ticks 2-6,
   wall clock from dispatch to the plan on the host) for the kernel and
   for the plain version on the same card, with the iteration counts.

The second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOLS = {"iris_traj_mpc": (10, 2e-4, 2e-5), "iris_posctrl_mpc": (8, 5e-4, 5e-5)}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def problem(b, dev):
    """The fixed-budget problem of the CPU parity tests."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.types import hover_state

    x0 = hover_state(dev)
    x0[0], x0[3] = 0.3, 0.2
    x_ref = hover_state(dev).expand(21, 13).contiguous()
    u_prev = b.cost_params.uref.clone()
    u_init = (u_prev.expand(20, b.model.n_u) + torch.tensor(0.02, device=dev)).contiguous()
    return x0, x_ref, u_prev, u_init


def phase_parity(dev) -> tuple:
    """Kernel vs plain on the card. Returns (max |du|, kernel ms, plain ms)
    of the fixed-budget traj solve."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

    worst = 0.0
    timing = None
    for name, (max_iter, rtol, atol) in TOLS.items():
        b = load_mpc_from_cfgfile(os.path.join(ROOT, f"configs/{name}.yaml"), device=dev)[3]
        pres = [None] + ([b.precond] if b.precond is not None else [])
        for pre in pres:
            apg = b.apg_config._replace(max_iter=max_iter, max_no_improvement_iter=max_iter)
            x0, x_ref, u_prev, u_init = problem(b, dev)
            args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref,
                    u_prev, None, 1, b.lb, b.ub, u_init)
            st_k, xe_k = AK.apg_solve_kernel(*args, precond=pre)
            torch.cuda.synchronize()
            st_p, _ = AK.apg_solve_plain(*args, precond=pre)
            nk, np_ = int(st_k.num_steps), int(st_p.num_steps)
            du = float((st_k.yk - st_p.yk).abs().max())
            ok_u = bool(torch.allclose(st_k.yk, st_p.yk, rtol=rtol, atol=atol))
            dc = abs(float(st_k.opt_cost) - float(st_p.opt_cost)) / abs(float(st_p.opt_cost))
            ref = rollout_mean(b.model, b.params, x0, st_k.yk, b.time_steps)
            ok_x = bool(torch.allclose(xe_k, ref, rtol=1e-5, atol=1e-6))
            dx = float((xe_k - ref).abs().max())
            tag = f"{name}{' +hover_diag' if pre is not None else ''}"
            log(f"parity {tag}: steps kernel {nk} plain {np_}; max|du| {du:.3e} "
                f"(rtol {rtol}, atol {atol}); cost rel {dc:.3e}; x_evol max|dx| {dx:.3e}")
            if not (nk == np_ and ok_u and dc <= rtol and ok_x
                    and np.isfinite(st_k.yk.cpu().numpy()).all()):
                raise AssertionError(f"kernel disagrees with its plain version on {tag}")
            worst = max(worst, du)
            if timing is None:
                timing = time_fixed(AK, args, pre)
                log(f"fixed {max_iter}-iteration {tag} solve: kernel "
                    f"{timing[0]:.4f} ms (CUDA events, mean of 20), plain "
                    f"{timing[1]:.3f} ms (wall, mean of 3)")
    return worst, timing


def time_fixed(AK, args, pre, n_kernel=20, n_plain=3):
    import torch

    for _ in range(3):
        AK.apg_solve_kernel(*args, precond=pre)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n_kernel):
        AK.apg_solve_kernel(*args, precond=pre)
    e1.record()
    torch.cuda.synchronize()
    k_ms = e0.elapsed_time(e1) / n_kernel
    t = time.perf_counter()
    for _ in range(n_plain):
        AK.apg_solve_plain(*args, precond=pre)[0].yk.cpu()
    return k_ms, (time.perf_counter() - t) * 1e3 / n_plain


def controller(dev):
    from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController

    return RecedingHorizonController(
        os.path.join(ROOT, "configs/iris_traj_mpc.yaml"),
        os.path.join(ROOT, "configs/iris_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0, device=dev)


def recording(c) -> list:
    """Collect every OptMPCStateRecord the controller publishes."""
    records = []
    solve_once = c.solve_once

    def wrapped(*a):
        rec = solve_once(*a)
        records.append(rec)
        return rec

    c.solve_once = wrapped
    return records


def phase_slice(dev) -> int:
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine import goldens as G
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    ctrls = [controller(dev) for _ in range(3)]         # one per replay
    solves0 = sum(c.traj.solves + c.pos.solves for c in ctrls)
    AK.apg_solve_kernel.launches = 0
    modes, *engagement = G.replay_engagement(ctrls[2])
    results = {"pos_flagship": G.replay_pos(ctrls[0]),
               "traj_flagship": G.replay_traj(ctrls[1]),
               "engagement": engagement}
    torch.cuda.synchronize()
    launches = AK.apg_solve_kernel.launches
    solves = sum(c.traj.solves + c.pos.solves for c in ctrls) - solves0
    for name, (tr, costs) in results.items():
        path = os.path.join(G.golden_dir(ROOT), f"iris_{name}_trace.npz")
        res = G.compare_to_golden(tr, costs, path)
        if name == "engagement":
            # The reference gates only the flagship replays on a device
            # (bench.py:231-282). Most engagement ticks stop at max_iter
            # before converging, so their cost follows the fp rounding of
            # the chained warm starts: on an H100 the plain version and the
            # kernel both drift ~2e-3 from the CPU golden on the first
            # hold ticks, and the kernel reached 2.2e-2 on one (PERF.md).
            # Commands, modes and pickup indices are gated; the cost is
            # printed.
            res["ok"] = (res["du"] <= G.GATES["u"] and res["dw"] <= G.GATES["w"]
                         and res["idx_exact"] and bool(np.array_equal(
                             modes.astype(np.float32), np.load(path)["modes"])))
        log(f"golden iris_{name} ({len(tr)} ticks): max|du| {res['du']:.3e} "
            f"max|dw| {res['dw']:.3e} cost_rel {res['cost_rel']:.3e} idx "
            f"{'exact' if res['idx_exact'] else 'MISMATCH'} -> {'PASS' if res['ok'] else 'FAIL'}")
        if not res["ok"]:
            raise AssertionError(f"golden gate failed for iris_{name}: {res}")
    log(f"kernel launches in the slice run: {launches} for {solves} solves")
    if launches != solves or launches == 0:
        raise AssertionError("the slice did not run every solve through the kernel")
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    return launches


@contextlib.contextmanager
def routed(solve):
    """Route the loader's solves through ``solve`` (measurement only)."""
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    mpc_loader.apg_solve_kernel = solve
    try:
        yield
    finally:
        mpc_loader.apg_solve_kernel = AK.apg_solve_kernel


def event_timed(events: list):
    """The kernel's wrapper with CUDA events recorded around each call: the
    device span of one solve (consts packing plus the kernel)."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    def solve(*args, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = AK.apg_solve_kernel(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    return solve


def chained(dev, mode: str, n: int, warm: int):
    """(p50 wall ms, mean iterations) per solve over ticks ``warm+1..n``."""
    from sde4mbrl_px4_tpu_torch.engine import goldens as G

    c = controller(dev)
    records = recording(c)
    (G.replay_pos if mode == "pos" else G.replay_traj)(c, n=n)
    tail = records[warm:]
    return (statistics.median(r.solve_time for r in tail) * 1e3,
            statistics.mean(r.num_steps for r in tail))


def phase_timing(dev, card: str) -> dict:
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    out = {}
    n, warm = 6, 1
    for mode in ("pos", "traj"):
        events = []
        with routed(event_timed(events)):
            k_ms, k_steps = chained(dev, mode, n, warm)
        torch.cuda.synchronize()
        dev_ms = statistics.median(a.elapsed_time(b) for a, b in events[-(n - warm):])
        with routed(AK.apg_solve_plain):
            p_ms, p_steps = chained(dev, mode, n, warm)
        out[mode] = (k_ms, p_ms, dev_ms)
        log(f"chained iris/{mode} replay, per solve p50 over ticks {warm + 1}-{n} ({card}): "
            f"kernel {k_ms:.3f} ms wall ({dev_ms:.3f} ms device span) at {k_steps:.1f} "
            f"iterations, plain {p_ms:.3f} ms wall at {p_steps:.1f} iterations")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import build

    apply_fp32_policy()
    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 1: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t = time.perf_counter()
    lib_path = build.build_library("apg_solve")
    build_s = build.build_library.last_seconds
    AK.load_apg_library()
    log(f"phase 2: built {os.path.relpath(lib_path, ROOT)} in {build_s:.1f} s "
        f"(with load {time.perf_counter() - t:.1f} s)")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    max_err, fixed = phase_parity(dev)
    log(f"phase 3: kernel matches its plain version (max|du| {max_err:.3e})")
    launches = phase_slice(dev)
    log("phase 4: slice replays pass the golden gates through the kernel")
    timing = phase_timing(dev, card)
    log("phase 5: timed")

    print(json.dumps({"kernels": [{
        "name": "apg_solve",
        "route": "cuda",
        "source": "sde4mbrl_px4_tpu_torch/csrc/apg_solve.cu",
        "replaces": "sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py:420",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["traj"][0],
        "plain_ms": timing["traj"][1],
        "device_ms": timing["traj"][2],
        "fixed_budget_ms": fixed[0],
        "fixed_budget_plain_ms": fixed[1],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
