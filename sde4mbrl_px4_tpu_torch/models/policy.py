"""Amortized MPC policy network (L1).

PyTorch counterpart of ``sde4mbrl_px4_tpu/models/policy.py`` (``:1-117``):
a small MLP that maps (current state, reference window, previous control)
to the whole H-step control plan in one forward pass, served as the
``solver: policy`` family (``engine/mpc_loader.py``). The network is three
plain fp32 matrix products with swish between them (the JAX package runs
them on XLA, outside any Pallas kernel), squashed into the input box by a
sigmoid so it can never command outside it.

Features (translation-invariant, solver frame NED), in the original's
order: per reference knot (H+1 of them) the position error ``p_ref - p``,
then the velocity errors, then the attitude errors ``qerr_vec(q, q_ref)``
(each block knot-major), then the body rate ω, the gravity direction in the
body frame ``R(q)^T e_z`` and ``u_prev``. ``q`` is normalised and
canonicalised to ``q0 >= 0`` (``q * sign(q0)``, sign 0 counting as +1)
first, so q and -q give the same features.

:class:`PolicyNet` holds the weights (``w{i}`` (fan_in, fan_out), ``b{i}``,
the checkpoint's layout) and the plan shape ``H``, ``n_u`` as host ints;
:func:`featurize`, :func:`policy_apply` and :func:`init_policy` are plain
functions on tensors over any leading batch shape (the original ``vmap``s
them; here they broadcast). :func:`policy_from_numpy` carries a checkpoint's
``params`` (or the JAX package's ``init_policy`` tree) across.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sde4mbrl_px4_tpu_torch.core import quaternion as quat

__all__ = ["POLICY_KIND", "PolicyNet", "featurize", "init_policy", "policy_apply",
           "policy_feat_dim", "policy_from_numpy"]

POLICY_KIND = "mpc_policy_v1"  # checkpoint meta tag


def policy_feat_dim(H: int, n_u: int) -> int:
    """Input width for a horizon-``H`` policy: 9 error features per
    reference knot (H+1 knots) + ω (3) + g_body (3) + u_prev (n_u)."""
    return 9 * (H + 1) + 6 + n_u


class PolicyNet(torch.nn.Module):
    """The plan network's weights: ``layers`` [(w (fan_in, fan_out), b
    (fan_out,)), ...] as buffers, and the plan shape as host ints (reading
    a device scalar per solve would wait for the solve in flight)."""

    def __init__(self, layers: Sequence, H: int, n_u: int):
        super().__init__()
        self.H, self.n_u, self.n_layers = int(H), int(n_u), len(layers)
        for i, (w, b) in enumerate(layers):
            self.register_buffer(f"w{i}", w)
            self.register_buffer(f"b{i}", b)
        if self.w0.shape[0] != policy_feat_dim(self.H, self.n_u):
            raise ValueError(f"policy input width {self.w0.shape[0]} != "
                             f"{policy_feat_dim(self.H, self.n_u)} for H={H}, n_u={n_u}")
        last = getattr(self, f"w{self.n_layers - 1}")
        if last.shape[1] != self.H * self.n_u:
            raise ValueError(f"policy head width {last.shape[1]} != H*n_u = "
                             f"{self.H * self.n_u}")

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(..., feat) -> the raw head (..., H*n_u): ``h @ w + b`` per layer,
        swish between layers, fp32."""
        h = feats
        for i in range(self.n_layers):
            h = h @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n_layers - 1:
                h = F.silu(h)
        return h


def featurize(x: torch.Tensor, x_ref: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """(..., 13), (..., H+1, 13), (..., n_u) -> (..., feat) policy input in
    the solver frame (NED), the original's feature order."""
    x = x.to(torch.float32)
    q = quat.qnormalize(x[..., 6:10])
    # the double-cover representative with q0 >= 0 (sign 0 counts as +1)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
    rel_p = x_ref[..., 0:3] - x[..., None, 0:3]                 # (..., H+1, 3)
    rel_v = x_ref[..., 3:6] - x[..., None, 3:6]
    e_q = quat.qerr_vec(q[..., None, :], x_ref[..., 6:10])      # (..., H+1, 3)
    e_z = torch.zeros_like(x[..., 0:3])
    e_z[..., 2] = 1.0
    g_body = quat.qrotate_inv(q, e_z)
    lead = x.shape[:-1]
    return torch.cat([rel_p.reshape(*lead, -1), rel_v.reshape(*lead, -1),
                      e_q.reshape(*lead, -1), x[..., 10:13], g_body,
                      u_prev.to(torch.float32)], dim=-1)


def policy_apply(policy: PolicyNet, feats: torch.Tensor, lb: torch.Tensor,
                 ub: torch.Tensor) -> torch.Tensor:
    """(..., feat) -> (..., H, n_u) control plan inside the input box:
    ``lb + (ub - lb) * sigmoid(raw)``."""
    raw = policy(feats)
    raw = raw.reshape(raw.shape[:-1] + (policy.H, policy.n_u))
    return lb + (ub - lb) * torch.sigmoid(raw)


def init_policy(generator: torch.Generator, H: int, n_u: int, lb, ub, uref,
                hidden: Sequence[int] = (256, 256),
                device: torch.device | str = "cpu") -> PolicyNet:
    """A fresh policy, drawn from ``generator`` on the CPU (the numbers
    differ from the JAX package's threefry draws): He init, the last layer
    scaled by 1e-3, zero biases except the head's, which starts at the
    hover logit ``log(frac / (1 - frac))`` of ``uref`` in the box, tiled H
    times, so the untrained policy commands ``uref`` everywhere."""
    sizes = (policy_feat_dim(H, n_u), *[int(h) for h in hidden], H * n_u)
    layers = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        s = 1e-3 if i == len(sizes) - 2 else float(np.sqrt(2.0 / fan_in))
        w = torch.randn(fan_in, fan_out, generator=generator) * s
        layers.append([w, torch.zeros(fan_out)])
    lb = np.broadcast_to(np.asarray(lb, np.float32), (n_u,))
    ub = np.broadcast_to(np.asarray(ub, np.float32), (n_u,))
    frac = np.clip((np.broadcast_to(np.asarray(uref, np.float32), (n_u,)) - lb) / (ub - lb),
                   1e-4, 1 - 1e-4)
    layers[-1][1] = torch.from_numpy(np.tile(np.log(frac / (1.0 - frac)), H).astype(np.float32))
    return PolicyNet([(w.to(device), b.to(device)) for w, b in layers], H, n_u)


def policy_from_numpy(tree: Dict[str, Any], device: torch.device | str = "cpu") -> PolicyNet:
    """A checkpoint's ``params`` (``{"net": {"w0", "b0", ...}, "meta_H",
    "meta_n_u"}``, numpy) -> :class:`PolicyNet` on ``device``, the weights
    as fp32 tensors and the metas as host ints."""
    net = tree["net"]
    n_layers = sum(1 for k in net if k.startswith("w"))
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return PolicyNet([(t(net[f"w{i}"]), t(net[f"b{i}"])) for i in range(n_layers)],
                     int(np.asarray(tree["meta_H"])), int(np.asarray(tree["meta_n_u"])))
