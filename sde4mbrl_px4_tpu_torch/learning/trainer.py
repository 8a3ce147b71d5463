"""Neural-SDE model learning from flight data (L1/L6).

PyTorch counterpart of ``sde4mbrl_px4_tpu/learning/trainer.py``
(``:40-208``): fit the physics-constrained SDE of ``models/sde_model.py``
to logged (state, control) sequences with a multi-step strong loss, the
Gaussian negative log-likelihood of the W-step Euler prediction of the
mean against the logged states, with the learned diffusion as the
state-dependent scale on the velocity and rate states, plus squared
position and attitude errors.

Each update is one batched window rollout (W Euler steps through
``drift_and_sigma``, the quaternion renormalised after each), its
gradient by autograd over every leaf of the parameter tree, and one
``torch.optim.AdamW`` step, whose decoupled, learning-rate-scaled decay
and ``eps`` outside the square root are ``optax.adamw``'s
(``tests/test_torch_learning.py`` holds the two in lockstep). The batches
come from ``np.random.RandomState(seed)`` as in the original (``:121-124``),
so both packages see the very same windows. No kernel is involved: the
JAX package trains on XLA. The loss is read on the host only every
``log_every`` steps and at the end.

Data format: arrays ``t (N,)``, ``x (N, 13)``, ``u (N, n_u)`` sampled at a
fixed rate, an ``.npz`` with those keys, or a flight log
(``io/flight_log.py``). ``TrainConfig``, ``sequence_from_flight_log`` and
``TrajectoryDataset`` (numpy) are copied from the original.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy, resolve_device
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, drift_and_sigma

__all__ = ["TrainConfig", "TrajectoryDataset", "make_loss_fn", "sequence_from_flight_log",
           "train_sde"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    window: int = 8              # prediction steps per training window
    batch_size: int = 256
    steps: int = 2000
    lr: float = 1e-3
    weight_decay: float = 1e-5
    sigma_floor: float = 1e-3    # numerical floor on predictive scale
    pos_weight: float = 1.0      # extra weight on position prediction
    seed: int = 0


def sequence_from_flight_log(path: str, n_u: int = 4):
    """``(t, x, u)`` — the longest contiguous commanded segment of a
    recorded flight (``io/flight_log.py`` .npz: ``t``, ``state``,
    ``cmd_motors``). Rows before the first command (engagement) are
    dropped."""
    from sde4mbrl_px4_tpu_torch.io.flight_log import load_flight_log

    d = load_flight_log(path)
    t, x = d["t"], d["state"]
    u = d["cmd_motors"][:, :n_u]
    have = ~np.isnan(u).any(axis=1) & (np.abs(u).sum(axis=1) > 0)
    # longest contiguous commanded run
    best = (0, 0)
    i = 0
    n = len(have)
    while i < n:
        if have[i]:
            j = i
            while j < n and have[j]:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        else:
            i += 1
    i0, i1 = best
    return t[i0:i1], x[i0:i1], u[i0:i1]


class TrajectoryDataset:
    """Sliding-window view over one logged flight segment."""

    def __init__(self, t: np.ndarray, x: np.ndarray, u: np.ndarray,
                 window: int):
        assert x.shape[0] == u.shape[0] == t.shape[0]
        self.dt = float(np.median(np.diff(t)))
        self.window = int(window)
        n_win = x.shape[0] - self.window
        if n_win <= 0:
            raise ValueError("trajectory shorter than training window")
        # windows: x0 (N, 13), u (N, W, n_u), targets (N, W, 13)
        idx = np.arange(n_win)[:, None] + np.arange(self.window)[None, :]
        self.x0 = x[:n_win].astype(np.float32)
        self.u_win = u[idx].astype(np.float32)
        self.x_tgt = x[idx + 1].astype(np.float32)

    @staticmethod
    def from_npz(path: str, window: int) -> "TrajectoryDataset":
        d = np.load(path)
        return TrajectoryDataset(d["t"], d["x"], d["u"], window)

    @staticmethod
    def from_flight_log(path: str, window: int, n_u: int = 4) -> "TrajectoryDataset":
        """System identification from a recorded flight (``sim/closed_loop.py
        --log`` or a real mission): the longest contiguous commanded
        segment (:func:`sequence_from_flight_log`)."""
        t, x, u = sequence_from_flight_log(path, n_u=n_u)
        if t.shape[0] <= window:
            raise ValueError("no commanded segment longer than the window")
        return TrajectoryDataset(t, x, u, window)

    def batches(self, batch_size: int, seed: int = 0) -> Iterator[Tuple]:
        rs = np.random.RandomState(seed)
        n = self.x0.shape[0]
        while True:
            sel = rs.randint(0, n, size=batch_size)
            yield self.x0[sel], self.u_win[sel], self.x_tgt[sel]


def make_loss_fn(model: NeuralSDE, dt: float, cfg: TrainConfig) -> Callable:
    """Windowed Euler-prediction NLL over a batch: ``loss(params, x0 (B, 13),
    u_win (B, W, n_u), x_tgt (B, W, 13)) -> ()``, term for term the
    original's (``:136-161``)."""
    dt_t = torch.tensor(dt, dtype=torch.float32)

    def rollout_window(params, x0, u_win):
        """x0 (B,13), u_win (B,W,n) -> mean path (B,W,13), sigma (B,W,13)."""
        x, xs, sigs = x0, [], []
        for w in range(u_win.shape[1]):
            f, sig = drift_and_sigma(model, params, x, u_win[:, w])
            x1 = x + dt * f
            x = torch.cat([x1[..., 0:6], quat.qnormalize(x1[..., 6:10]), x1[..., 10:13]],
                          dim=-1)
            xs.append(x)
            sigs.append(sig)
        return torch.stack(xs, dim=1), torch.stack(sigs, dim=1)

    def loss_fn(params, x0, u_win, x_tgt):
        pred, sig = rollout_window(params, x0, u_win)
        sqrt_dt = torch.sqrt(dt_t.to(x0.device))
        # Gaussian NLL on the velocity states with the learned per-step scale
        # (scaled by sqrt(dt) as in the EM transition density)
        scale = sqrt_dt * sig[..., 3:6] + cfg.sigma_floor
        dv = (pred[..., 3:6] - x_tgt[..., 3:6]) / scale
        nll_v = torch.mean(0.5 * dv * dv + torch.log(scale))
        scale_w = sqrt_dt * sig[..., 10:13] + cfg.sigma_floor
        dw = (pred[..., 10:13] - x_tgt[..., 10:13]) / scale_w
        nll_w = torch.mean(0.5 * dw * dw + torch.log(scale_w))
        # deterministic penalties on the kinematic states (no diffusion)
        dp = pred[..., 0:3] - x_tgt[..., 0:3]
        dq = quat.qerr_vec(pred[..., 6:10], x_tgt[..., 6:10])
        mse_kin = cfg.pos_weight * torch.mean(dp * dp) + torch.mean(dq * dq)
        return nll_v + nll_w + mse_kin

    return loss_fn


def _leaves(tree: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """A trainable copy of a parameter tree on ``dev``: every leaf an fp32
    tensor that requires grad (numpy leaves are taken too)."""
    if isinstance(tree, dict):
        return {k: _leaves(v, dev) for k, v in tree.items()}
    t = torch.as_tensor(np.array(tree, np.float32) if not isinstance(tree, torch.Tensor)
                        else tree)
    return t.detach().to(dev, torch.float32).clone().requires_grad_(True)


def _flat(tree: Dict[str, Any]) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _flat(tree[k])]
    return [tree]


def _detached(tree: Dict[str, Any]) -> Dict[str, Any]:
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def train_sde(
    model: NeuralSDE,
    params: Dict[str, Any],
    dataset: TrajectoryDataset,
    cfg: TrainConfig = TrainConfig(),
    mesh=None,
    log_every: int = 200,
    log: Callable = print,
    device: Optional[torch.device | str] = None,
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Fit the SDE to data; returns ``(params, {"final_loss": ...})``, the
    parameters a tree of fp32 tensors on ``device`` (None: the card; without
    one this raises). ``params`` is the starting tree (tensors or numpy,
    any trunk width) and is not changed. ``model`` may live on any device:
    its constants move with the batches.

    ``mesh`` (``parallel/mesh.py``; the original's ``:186-189``) trains
    data-parallel over its dp axis, on the mesh's device: every rank draws
    the same batches from the same iterator and takes its dp-th of each
    (``batch_size`` must divide over dp); the gradients are summed over dp
    in rank order (``parallel/distributed.py::ordered_sum``) and divided by
    dp before AdamW, so every rank takes the same step and ends with the
    same parameters (the loss read is the ranks' mean the same way). A
    rank's mean over its rows is the batch mean's share, so the step is
    the one-process step up to the order of the sums."""
    apply_fp32_policy()
    rows = slice(None)
    if mesh is not None:
        device = mesh.device
        rows = mesh.rows(cfg.batch_size)
    dev = resolve_device(device)
    model = NeuralSDE(model.vehicle, model.mixing.to(dev), model.inertia.to(dev))
    params = _leaves(params, dev)
    leaves = _flat(params)
    opt = torch.optim.AdamW(leaves, lr=cfg.lr, weight_decay=cfg.weight_decay)
    loss_fn = make_loss_fn(model, dataset.dt, cfg)
    it = dataset.batches(cfg.batch_size, seed=cfg.seed)
    loss = torch.zeros((), device=dev)

    def dp_mean(t: torch.Tensor) -> torch.Tensor:
        if mesh is None or mesh.dp == 1:
            return t
        from sde4mbrl_px4_tpu_torch.parallel.distributed import ordered_sum

        return ordered_sum(t, mesh, mesh.axis_names[0]) / float(mesh.dp)

    for step in range(cfg.steps):
        x0, u_win, x_tgt = (torch.from_numpy(a[rows]).to(dev) for a in next(it))
        loss = loss_fn(params, x0, u_win, x_tgt)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None and mesh.dp > 1:
            flat = dp_mean(torch.cat([p.grad.reshape(-1) for p in leaves]))
            for p, g in zip(leaves, torch.split(flat, [p.numel() for p in leaves])):
                p.grad.copy_(g.view_as(p.grad))
        opt.step()
        if log_every and step % log_every == 0:
            log(f"step {step}: loss {float(dp_mean(loss.detach())):.5f}")
    loss = dp_mean(loss.detach().reshape(1))[0]
    return _detached(params), {"final_loss": float(loss.detach())}
