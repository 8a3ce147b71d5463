"""MPC distillation: amortize the APG solver into a one-shot policy (L6).

PyTorch counterpart of ``sde4mbrl_px4_tpu/learning/distill.py``
(``:59-465``): distill converged APG solves into the policy network of
``models/policy.py``.

1. **Sample** training states by perturbing the reference trajectory (or
   the pos-control envelope) — :func:`sample_states`. The draws come from
   a ``torch.Generator``, or are handed in (:class:`StateDraws`, or an
   iterator of them), which is how the tests pass the original's draws:
   the map from draws to states is the original's.
2. **Label** every state with a converged APG solve — :func:`label_states`:
   ``parallel/batched.py::make_batched_mpc`` of the expert config over all
   n scenarios, so on the card one launch of the whole-solve kernel over n
   blocks (the original labels on XLA, ``use_pallas=False``). Each
   scenario's previous command seeds row 0 of its warm start on the device.
3. **Train** the network supervised — :func:`train_policy`: AdamW under the
   original's warmup-cosine schedule (:func:`warmup_cosine`), minibatch
   indices from a generator or handed in.
4. Optional **DAgger rounds** — :func:`_dagger_states` flies the current
   policy on the mean dynamics (a plain batched rollout on the device, as
   the original's ``lax.scan`` on XLA) and the visited states are labelled
   and added.

Serving: :func:`save_policy` writes the original's checkpoint schema, so a
``solver: policy`` config of either package serves it
(``models/policy.py::policy_from_numpy``); :func:`load_policy` reads either
package's. A policy here is a :class:`models.policy.PolicyNet`.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.models.params_io import load_params, save_params
from sde4mbrl_px4_tpu_torch.models.policy import (
    POLICY_KIND, PolicyNet, featurize, init_policy, policy_apply, policy_from_numpy)

__all__ = ["DistillConfig", "DaggerDraws", "StateDraws", "build_features", "distill_policy",
           "label_states", "load_policy", "policy_to_numpy", "sample_states", "save_policy",
           "train_policy", "warmup_cosine"]


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    n_states: int = 4096
    pos_std: float = 0.5          # m, NED (fine noise around the anchor)
    target_std: float = 2.0       # m, pos-control start<->target separation
                                  # (starts and targets drawn independently)
    vel_std: float = 1.0          # m/s
    tilt_std: float = 0.25        # rad (roll/pitch perturbation)
    yaw_std: float = 0.3          # rad
    rate_std: float = 0.5         # rad/s
    expert_max_iter: int = 300    # labeling budget (labels converged, not real-time)
    hidden: Tuple[int, ...] = (256, 256)
    batch_size: int = 256
    steps: int = 3000
    lr: float = 1e-3
    weight_decay: float = 1e-5
    horizon_tau: float = 0.5      # loss weight exp(-k/(tau*H)) along the horizon
    dagger_rounds: int = 0
    dagger_rollouts: int = 32     # parallel policy rollouts per DAgger round
    dagger_steps: int = 100       # closed-loop plant steps per rollout
    seed: int = 0


class StateDraws(NamedTuple):
    """The draws behind :func:`sample_states`, in the units the original
    uses them: ``t`` (n,) times on the table in [0, t_max) (trajectory
    configs, else None); for position configs ``target`` and ``start`` (n,
    3) standard normals and ``target_yaw`` (n,) uniform in [-pi, pi); then
    standard normals ``pos``, ``vel`` (n, 3), ``tilt`` (n, 2), ``yaw`` (n,
    1), ``rate`` (n, 3) and ``u`` (n, n_u)."""

    t: Optional[torch.Tensor]
    target: Optional[torch.Tensor]
    start: Optional[torch.Tensor]
    target_yaw: Optional[torch.Tensor]
    pos: torch.Tensor
    vel: torch.Tensor
    tilt: torch.Tensor
    yaw: torch.Tensor
    rate: torch.Tensor
    u: torch.Tensor


class DaggerDraws(NamedTuple):
    """The draws behind :func:`_dagger_states`: ``t0`` (B,) start times in
    [0, max(t_max - T dt, 1e-3)) (trajectory configs, else None); for
    position configs ``start`` and ``target`` (B, 3) standard normals and
    ``target_yaw`` (B,) uniform in [-pi, pi)."""

    t0: Optional[torch.Tensor]
    start: Optional[torch.Tensor]
    target: Optional[torch.Tensor]
    target_yaw: Optional[torch.Tensor]


def _next_draws(rng, make):
    """A generator's draws (``make(gen)``), a draws tuple as it is, or the
    next item of an iterator of them."""
    if isinstance(rng, torch.Generator):
        return make(rng)
    if isinstance(rng, (StateDraws, DaggerDraws)):
        return rng
    return next(rng)


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32,
                                       device=gen.device)


def _normal(gen, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


def _to(t, dev):
    return None if t is None else torch.as_tensor(np.array(t, np.float32)).to(dev)


# ---------------------------------------------------------------------------
# dataset


def _expert_cfg(cfg: Dict[str, Any], dcfg: DistillConfig) -> Dict[str, Any]:
    """The labeling expert: same problem, APG solver, converged budget."""
    ecfg = dict(cfg)
    ecfg.pop("solver", None)
    ecfg.pop("policy", None)
    apg = dict(ecfg.get("apg_mpc", {}))
    apg["max_iter"] = int(max(apg.get("max_iter", 200), dcfg.expert_max_iter))
    apg["max_no_improvement_iter"] = apg["max_iter"]
    ecfg["apg_mpc"] = apg
    return ecfg


def sample_states(bundle, n: int, rng, dcfg: DistillConfig = DistillConfig()
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> ``(xs (n, 13) NED, ts (n,), xdes (n, 13) ENU, u_prevs (n, n_u))`` on
    the bundle's device (the original's ``:101-166``). Trajectory configs
    anchor at ``state_from_traj(t)`` for uniform ``t`` over the table;
    position configs at a hover start offset from an independent hover
    target of uniform yaw. Then position, velocity, attitude and rate
    noise; ``u_prevs`` is ``uref`` plus noise, inside the box. ``rng``: a
    ``torch.Generator``, :class:`StateDraws`, or an iterator of them."""
    dev = bundle.device
    sft = bundle.state_from_traj
    n_u = bundle.model.n_u
    T = float(getattr(sft, "t_max", 10.0)) if sft is not None else 0.0

    def make(gen):
        traj = sft is not None
        t = _uniform(gen, (n,), 0.0, T) if traj else None
        target = None if traj else _normal(gen, (n, 3))
        start = None if traj else _normal(gen, (n, 3))
        target_yaw = None if traj else _uniform(gen, (n,), -math.pi, math.pi)
        return StateDraws(t, target, start, target_yaw, _normal(gen, (n, 3)),
                          _normal(gen, (n, 3)), _normal(gen, (n, 2)), _normal(gen, (n, 1)),
                          _normal(gen, (n, 3)), _normal(gen, (n, n_u)))

    d = StateDraws(*(_to(v, dev) for v in _next_draws(rng, make)))
    if sft is not None:
        ts = d.t
        xdes = sft(ts)                                  # ENU (unused in traj mode)
        anchors = enu2ned(xdes)
    else:
        ts = torch.zeros(n, dtype=torch.float32, device=dev)
        hov = hover_state(dev).expand(n, 13)
        targets = torch.cat([hov[:, 0:3] + dcfg.target_std * d.target, hov[:, 3:6],
                             quat.q_from_yaw(d.target_yaw), hov[:, 10:13]], dim=-1)
        anchors = torch.cat([hov[:, 0:3] + dcfg.target_std * d.start, hov[:, 3:13]], dim=-1)
        xdes = enu2ned(targets)                         # the ENU target (an involution)
    ang = torch.cat([dcfg.tilt_std * d.tilt, dcfg.yaw_std * d.yaw], dim=1)
    dq = quat.q_from_euler(ang[:, 0], ang[:, 1], ang[:, 2])
    xs = torch.cat([anchors[:, 0:3] + dcfg.pos_std * d.pos,
                    anchors[:, 3:6] + dcfg.vel_std * d.vel,
                    quat.qnormalize(quat.qmul(anchors[:, 6:10], dq)),
                    anchors[:, 10:13] + dcfg.rate_std * d.rate], dim=-1)
    u_prevs = torch.clamp(bundle.cost_params.uref.expand(n, n_u) + 0.1 * d.u,
                          bundle.lb, bundle.ub)
    return xs.contiguous(), ts.contiguous(), xdes.contiguous(), u_prevs.contiguous()


def label_states(cfg: Dict[str, Any], xs, ts, xdes, rng=None,
                 dcfg: DistillConfig = DistillConfig(), mesh=None, u_prevs=None,
                 device: Optional[torch.device | str] = None) -> torch.Tensor:
    """Converged expert plans ``u* (n, H, n_u)`` for the states (the
    original's ``:169-240``): the expert config's batched solve over all n
    scenarios, on the card one launch of the whole-solve kernel of n blocks
    (unchunked: nothing forces a split at the example's n = 4096, whose
    grid and per-scenario buffers the card takes). ``u_prevs`` (default
    ``uref``) seeds row 0 of each warm start, on the device, so the label
    depends on the previous-command feature (the slew cost reads
    ``opt_state.yk[0]``).
    ``rng`` serves configs with particles (the batched solve's draws).
    ``device`` None is the card; ``"cpu"`` solves each scenario on the plain
    version.

    ``mesh`` (``parallel/mesh.py``; the original's ``:194-215``) labels
    over its dp axis, on the mesh's device: the states are padded to a
    dp-divisible batch (the last row repeated), each rank labels its rows
    with one batched solve (one launch of the whole-solve kernel on the
    card), and the rows are gathered in rank order on every rank and cut
    back to n."""
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc

    if mesh is not None:
        device = mesh.device
    reset_b, mpc_b, bundle = make_batched_mpc(_expert_cfg(cfg, dcfg), mesh, device=device)
    dev, n_u = bundle.device, bundle.model.n_u
    xs, ts, xdes = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (xs, ts, xdes))
    n = int(xs.shape[0])
    if u_prevs is None:
        u_prevs = bundle.cost_params.uref.expand(n, n_u)
    u_prevs = torch.as_tensor(u_prevs, dtype=torch.float32).to(dev)
    if mesh is not None:
        pad = (-n) % mesh.dp
        xs, ts, xdes, u_prevs = (torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])[
            mesh.rows(n + pad)] for a in (xs, ts, xdes, u_prevs))
    st = reset_b(xs, rng, xdes)
    yk = st.yk.clone()
    yk[:, 0, :n_u] = u_prevs
    u_opt = mpc_b(xs, rng, st._replace(yk=yk), ts, xdes).u_opt
    if mesh is None:
        return u_opt
    from sde4mbrl_px4_tpu_torch.parallel.distributed import gather_to_host

    return torch.from_numpy(gather_to_host(u_opt, mesh)[:n]).to(dev)


def _reference(bundle, ts: torch.Tensor, xdes: torch.Tensor) -> torch.Tensor:
    """The serving path's reference window (n, H+1, 13) in NED: trajectory
    knots at ``ts + knot_times``, or the broadcast target."""
    sft = bundle.state_from_traj
    H1 = int(bundle.knot_times.shape[0])
    if sft is not None:
        ref = sft(ts[:, None] + bundle.knot_times)
        return enu2ned(ref) if bundle.convert_to_enu else ref
    tgt = enu2ned(xdes) if bundle.convert_to_enu else xdes
    return tgt[:, None, :].expand(tgt.shape[0], H1, 13)


def build_features(bundle, xs, ts, xdes, u_prevs=None) -> torch.Tensor:
    """Policy inputs for a batch of states — the SAME reference window the
    ``solver: policy`` serving path builds (trajectory knots in NED, or the
    broadcast NED target). ``u_prevs`` defaults to ``uref``."""
    dev = bundle.device
    xs, ts, xdes = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (xs, ts, xdes))
    if u_prevs is None:
        u_prevs = bundle.cost_params.uref.expand(xs.shape[0], bundle.model.n_u)
    return featurize(xs, _reference(bundle, ts, xdes), torch.as_tensor(u_prevs).to(dev))


# ---------------------------------------------------------------------------
# training


def warmup_cosine(lr: float, steps: int):
    """``optax.warmup_cosine_decay_schedule(0.1 lr, lr, max(10, steps // 50),
    steps, 0.01 lr)`` as a function of the 0-based step count read before
    each update: linear from 0.1 lr to lr over the warmup, then a cosine
    down to 0.01 lr at ``steps``, held there after. Raises as optax does
    when no step is left for the decay."""
    warm = max(10, steps // 50)
    decay = steps - warm
    if not decay > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay}.")
    init, end = 0.1 * lr, 0.01 * lr
    alpha = end / lr

    def sched(count: int) -> float:
        if count < warm:
            return (init - lr) * (1.0 - count / warm) + lr
        c = min(count - warm, decay)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay)) + alpha)

    return sched


def _net_layers(params) -> Tuple[list, int, int]:
    """``([(w, b), ...], H, n_u)`` of a :class:`PolicyNet` or a checkpoint's
    numpy ``params`` tree."""
    if not isinstance(params, PolicyNet):
        params = policy_from_numpy(params)
    return ([(getattr(params, f"w{i}"), getattr(params, f"b{i}"))
             for i in range(params.n_layers)], params.H, params.n_u)


def train_policy(feats: torch.Tensor, labels: torch.Tensor, lb, ub, uref,
                 dcfg: DistillConfig = DistillConfig(), params=None, verbose: bool = False,
                 indices: Optional[Iterator] = None) -> Tuple[PolicyNet, Dict[str, Any]]:
    """Supervised distillation -> ``(policy, stats)`` on ``feats``' device
    (the original's ``:266-336``). Loss: MSE in normalized-control space
    ``(u - lb) / (ub - lb)`` with exponential horizon-decay weights. Only
    the network trains (``H`` and ``n_u`` stay host ints). ``params``: the
    starting policy (a :class:`PolicyNet` or a checkpoint's numpy tree);
    None draws ``init_policy`` from ``dcfg.seed``. The minibatch indices
    come from a generator seeded with ``dcfg.seed + 1``, or from
    ``indices``, an iterator of (batch,) index arrays."""
    dev = feats.device
    n, H, n_u = labels.shape
    lb, ub, uref = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (lb, ub, uref))
    if params is None:
        params = init_policy(torch.Generator().manual_seed(dcfg.seed), H, n_u,
                             lb.cpu().numpy(), ub.cpu().numpy(), uref.cpu().numpy(),
                             hidden=dcfg.hidden, device=dev)
    layers, H_p, n_u_p = _net_layers(params)
    net = [t.detach().to(dev, torch.float32).clone().requires_grad_(True)
           for wb in layers for t in wb]
    span = ub - lb
    y = (labels.to(dev) - lb) / span                                   # (n, H, n_u)
    w = torch.exp(-torch.arange(H, dtype=torch.float32, device=dev)
                  / (dcfg.horizon_tau * H))[:, None]
    w = w / torch.mean(w)
    sched = warmup_cosine(dcfg.lr, dcfg.steps)
    # lr 1 scaled by the schedule: AdamW's step and its decoupled decay both
    # take sched(count), as optax's scale_by_learning_rate does
    opt = torch.optim.AdamW(net, lr=1.0, weight_decay=dcfg.weight_decay)
    lr_sched = torch.optim.lr_scheduler.LambdaLR(opt, sched)

    # the trainable tensors themselves as the network's weights (no copy)
    policy = PolicyNet(list(zip(net[0::2], net[1::2])), H_p, n_u_p)

    bs = min(dcfg.batch_size, n)
    gen = torch.Generator().manual_seed(dcfg.seed + 1)
    losses = []
    t0 = time.perf_counter()
    for step in range(dcfg.steps):
        idx = (torch.randint(0, n, (bs,), generator=gen) if indices is None
               else torch.as_tensor(np.asarray(next(indices)), dtype=torch.int64))
        idx = idx.to(dev)
        pn = (policy_apply(policy, feats[idx], lb, ub) - lb) / span
        loss = torch.mean(w * (pn - y[idx]) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        lr_sched.step()
        if step % 200 == 0 or step == dcfg.steps - 1:
            losses.append(float(loss.detach()))
            if verbose:
                print(f"  distill step {step}: loss {losses[-1]:.6f}")
    stats = {"losses": losses, "train_s": time.perf_counter() - t0, "n": n, "H": H,
             "n_u": n_u}
    layers = [(a.detach(), b.detach()) for a, b in zip(net[0::2], net[1::2])]
    return PolicyNet(layers, H_p, n_u_p), stats


def distill_policy(cfg: Dict[str, Any], dcfg: DistillConfig = DistillConfig(), mesh=None,
                   verbose: bool = False, device: Optional[torch.device | str] = None
                   ) -> Tuple[PolicyNet, Dict[str, Any]]:
    """Full pipeline: sample -> label (the batched expert) -> train
    (-> optional DAgger rounds). Returns ``(policy, stats)``; ``stats``
    also holds ``label_calls``, the (states, seconds) of each label call
    (the card synchronised around it). ``device`` None is the card.
    ``mesh``: the labels over its dp axis (:func:`label_states`), on the
    mesh's device; every rank samples and trains alike, so every rank ends
    with the same policy."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    if mesh is not None:
        device = mesh.device
    _, _, _, bundle = make_mpc_from_config(dict(cfg), device=device)
    dev = bundle.device
    gen = torch.Generator().manual_seed(dcfg.seed)
    calls = []

    def labels_of(xs, ts, xdes, ups):
        _sync(dev)
        t0 = time.perf_counter()
        lab = label_states(cfg, xs, ts, xdes, gen, dcfg, mesh=mesh, u_prevs=ups, device=dev)
        _sync(dev)
        calls.append((int(xs.shape[0]), time.perf_counter() - t0))
        return lab

    xs, ts, xdes, ups = sample_states(bundle, dcfg.n_states, gen, dcfg)
    labels = labels_of(xs, ts, xdes, ups)
    feats = build_features(bundle, xs, ts, xdes, ups)
    params, stats = train_policy(feats, labels, bundle.lb, bundle.ub,
                                 bundle.cost_params.uref, dcfg, verbose=verbose)
    stats["label_s"] = calls[0][1]
    for rd in range(dcfg.dagger_rounds):
        xs2, ts2, xdes2, ups2 = _dagger_states(cfg, bundle, params, dcfg, gen)
        lab2 = labels_of(xs2, ts2, xdes2, ups2)
        feats = torch.cat([feats, build_features(bundle, xs2, ts2, xdes2, ups2)])
        labels = torch.cat([labels, lab2])
        params, st2 = train_policy(feats, labels, bundle.lb, bundle.ub,
                                   bundle.cost_params.uref, dcfg, params=params,
                                   verbose=verbose)
        stats[f"dagger{rd}_losses"] = st2["losses"]
        stats[f"dagger{rd}_train_s"] = st2["train_s"]
    stats["label_calls"] = calls
    return params, stats


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dagger_states(cfg, bundle, params, dcfg: DistillConfig, rng):
    """States the CURRENT policy visits — the DAgger aggregation set (the
    original's ``:374-434``): ``dagger_rollouts`` closed-loop flights of
    ``dagger_steps`` steps, the policy in the loop and the mean dynamics as
    the plant (one Euler step of the plan's first command a step, the row 1
    of the original's ``rollout_mean``), batched over the flights on the
    device. Trajectory configs stagger start times along the table;
    position configs draw independent (start, target) pairs. Returns
    ``(xs, ts, xdes, u_prevs)`` of B·T states, step-major as the original's.
    ``rng``: a ``torch.Generator``, :class:`DaggerDraws` or an iterator of
    them."""
    from sde4mbrl_px4_tpu_torch.ops.rollout import em_step

    if not isinstance(params, PolicyNet):
        params = policy_from_numpy(params, bundle.device)
    dev = bundle.device
    sft = bundle.state_from_traj
    dt0 = bundle.time_steps[0]
    n_u = bundle.model.n_u
    B, T = int(dcfg.dagger_rollouts), int(dcfg.dagger_steps)

    def make(gen):
        if sft is not None:
            hi = max(float(getattr(sft, "t_max", 10.0)) - T * float(dt0), 1e-3)
            return DaggerDraws(_uniform(gen, (B,), 0.0, hi), None, None, None)
        return DaggerDraws(None, _normal(gen, (B, 3)), _normal(gen, (B, 3)),
                           _uniform(gen, (B,), -math.pi, math.pi))

    d = DaggerDraws(*(_to(v, dev) for v in _next_draws(rng, make)))
    if sft is not None:
        t = d.t0
        x = enu2ned(sft(t))
        xdes_b = sft(torch.zeros(B, dtype=torch.float32, device=dev))   # unused in traj mode
    else:
        hov = hover_state(dev).expand(B, 13)
        x = torch.cat([hov[:, 0:3] + dcfg.target_std * d.start, hov[:, 3:13]], dim=-1)
        tgt = torch.cat([hov[:, 0:3] + dcfg.target_std * d.target, hov[:, 3:6],
                         quat.q_from_yaw(d.target_yaw), hov[:, 10:13]], dim=-1)
        t = torch.zeros(B, dtype=torch.float32, device=dev)
        xdes_b = enu2ned(tgt)                                            # the ENU boundary
    u_prev = bundle.cost_params.uref.expand(B, n_u)
    xs, ups, tss = [], [], []
    with torch.no_grad():
        for _ in range(T):
            plan = policy_apply(params, featurize(x, _reference(bundle, t, xdes_b), u_prev),
                                bundle.lb, bundle.ub)
            xs.append(x)
            ups.append(u_prev)
            tss.append(t)
            x = em_step(bundle.model, bundle.params, x, plan[:, 0], dt0)
            u_prev, t = plan[:, 0], t + dt0
    # u_prev is harvested alongside x: the command context in effect when the
    # policy visited x, which the expert warm-starts with
    return (torch.stack(xs).reshape(B * T, 13), torch.stack(tss).reshape(B * T),
            xdes_b.expand(T, B, 13).reshape(B * T, 13), torch.stack(ups).reshape(B * T, n_u))


# ---------------------------------------------------------------------------
# checkpoint IO


def policy_to_numpy(params) -> Dict[str, Any]:
    """A :class:`PolicyNet` (or a numpy tree, as it is) -> the checkpoint's
    ``params`` tree: ``{"net": {"w0", "b0", ...}, "meta_H", "meta_n_u"}``,
    the original's ``init_policy`` layout (int32 metas)."""
    if not isinstance(params, PolicyNet):
        return params
    net = {}
    for i in range(params.n_layers):
        net[f"w{i}"] = getattr(params, f"w{i}").detach().cpu().numpy()
        net[f"b{i}"] = getattr(params, f"b{i}").detach().cpu().numpy()
    return {"net": net, "meta_H": np.int32(params.H), "meta_n_u": np.int32(params.n_u)}


def save_policy(path: str, params, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a policy checkpoint (the original's ``:455-458``): ``meta`` with
    ``kind`` ``mpc_policy_v1``, ``params`` as :func:`policy_to_numpy`."""
    m = {"kind": POLICY_KIND}
    m.update(meta or {})
    save_params(path, policy_to_numpy(params), m)


def load_policy(path: str, device: Optional[torch.device | str] = None
                ) -> Tuple[PolicyNet, Dict[str, Any]]:
    """Read a policy checkpoint of either package -> ``(policy, meta)`` on
    ``device`` (None: the card); refuses another ``kind``."""
    from sde4mbrl_px4_tpu_torch.device import resolve_device

    params, meta = load_params(path)
    if meta.get("kind") not in (None, POLICY_KIND):
        raise ValueError(f"{path!r} is not a {POLICY_KIND} checkpoint: {meta}")
    return policy_from_numpy(params, resolve_device(device)), meta
