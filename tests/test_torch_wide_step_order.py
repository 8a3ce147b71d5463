"""The summation order of the P=1 wide step's layer 1, emulated in fp32.

The wide step (``csrc/sweeps.cuh``, ``wide_l1_partials`` and
``wide_l1_back``; the whole solve's and ``value_and_grad``'s P=1 forms on
trunks off the register chain's widths) sums layer 1 in another order than
a thread per output does:

- forward: warp w of the block's 8 sums the inputs of slice w (HID/8 of
  them, in order) for every output, and the row's owner adds the 8 slice
  sums in slice order, then the bias;
- reverse (the transposed product ``c_h0p = w1 @ c_h1p``): lane l of a warp
  sums the cotangents j = l, l + 32, ... in order for each of its 16 hidden
  units, and a butterfly over the 32 lanes (xor 16, 8, 4, 2, 1:
  ``warp_sum16_scatter``) joins them.

This file runs the port's plain ``value_and_grad`` (a 20-step rollout of
the iris traj config and its gradient by autograd) with layer 1 and its
transpose in each order, written out step by step in fp32 (an autograd
function whose forward and backward take the order), on trunks of 128 and
256 units drawn from a numpy seed at the shipped trunk's spread, and holds
the wide step's order to the thread-per-output order at the reference's
tolerances: the cost at rtol 2e-5, the gradient at rtol 5e-4 / atol 5e-5.
"""
import os

import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.engine import mpc_loader as L
from sde4mbrl_px4_tpu_torch.models import sde_model as M
from sde4mbrl_px4_tpu_torch.models.params_io import params_from_numpy
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

SLICES, LANES = 8, 32          # csrc/sweeps.cuh kSlices; a warp
VAL_RTOL, G_RTOL, G_ATOL = 2e-5, 5e-4, 5e-5


def serial(h, w):
    """``h @ w`` as a thread per output sums it: over the inputs in order."""
    acc = torch.zeros(h.shape[:-1] + w.shape[1:], dtype=torch.float32)
    for i in range(w.shape[0]):
        acc = acc + h[..., i:i + 1] * w[i]
    return acc


def sliced(h, w):
    """``h @ w`` in the wide step's forward order: each slice's serial sum,
    the slices added in order."""
    n = w.shape[0]
    acc = None
    for k in range(SLICES):
        lo, hi = k * n // SLICES, (k + 1) * n // SLICES
        part = serial(h[..., lo:hi], w[lo:hi])
        acc = part if acc is None else acc + part
    return acc


def serial_t(g, w):
    """``g @ w.T`` (layer 1's transpose) as a thread per output sums it."""
    return serial(g, w.T)


def lanes_t(g, w):
    """``g @ w.T`` in the wide step's reverse order: lane l's serial sum over
    j = l, l + 32, ..., then the butterfly over the lanes."""
    n = w.shape[1]
    v = []
    for lane in range(LANES):
        acc = torch.zeros(g.shape[:-1] + w.shape[:1], dtype=torch.float32)
        for j in range(lane, n, LANES):
            acc = acc + g[..., j:j + 1] * w[:, j]
        v.append(acc)
    for d in (16, 8, 4, 2, 1):
        v = [v[lane] + v[lane ^ d] for lane in range(LANES)]
    return v[0]


class Layer1(torch.autograd.Function):
    """Layer 1's product with the forward and the transposed product in the
    given orders (the weights take no gradient)."""

    @staticmethod
    def forward(ctx, h, w, fwd, bwd):
        ctx.save_for_backward(w)
        ctx.bwd = bwd
        return fwd(h, w)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return ctx.bwd(g, w), None, None, None


def trunk_in(fwd, bwd):
    """``sde_model.trunk_apply`` with layer 1 in the orders (fwd, bwd)."""
    def trunk_apply(params, x, u, bf16=False):
        assert not bf16
        h = M._feat(x, u)
        net = params["net"]
        for i in range(3):
            w = net[f"w{i}"]
            h = (Layer1.apply(h, w, fwd, bwd) if i == 1 else h @ w) + net[f"b{i}"]
            if i < 2:
                h = h * torch.sigmoid(h)
        res, raw = h.split((6, 6), dim=-1)
        return res, M.softplus(raw) * torch.exp(params["diffusion_log_scale"])
    return trunk_apply


@pytest.fixture(scope="module")
def traj(repo_root):
    return L.load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
                                   device="cpu")[3]


def drawn(b, hidden: int, seed: int) -> dict:
    """The shipped params with the trunk redrawn at ``hidden`` units from a
    numpy seed, each weight at the spread of the shipped one, biases 0 but
    the output layer's."""
    rs = np.random.RandomState(seed)
    net = {k: v.numpy() for k, v in b.params["net"].items()}
    F, OUT = net["w0"].shape[0], net["w2"].shape[1]
    new = {k: rs.standard_normal(shape) * float(np.std(net[k]))
           for k, shape in (("w0", (F, hidden)), ("w1", (hidden, hidden)),
                            ("w2", (hidden, OUT)))}
    new.update(b0=np.zeros(hidden), b1=np.zeros(hidden), b2=net["b2"])
    return {**b.params, "net": params_from_numpy(new)}


def test_butterfly_is_the_sum_of_the_lanes():
    """The emulation's transposed orders compute the product."""
    rs = np.random.RandomState(1)
    g = torch.from_numpy(rs.standard_normal((2, 72)).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal((72, 72)).astype(np.float32))
    for fn in (lanes_t, serial_t):
        torch.testing.assert_close(fn(g, w), g @ w.T, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sliced(g, w), g @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden", [128, 256])
def test_wide_order_matches_thread_per_output(traj, monkeypatch, hidden):
    """A 20-step rollout's cost and gradient with layer 1 summed in the wide
    step's orders against the thread-per-output orders, on a trunk of
    ``hidden`` units: cost rtol 2e-5, gradient rtol 5e-4 / atol 5e-5."""
    b = traj
    H = int(b.time_steps.shape[0])
    assert H == 20
    params = drawn(b, hidden, seed=hidden)
    x0 = hover_state()
    x0[0], x0[3] = 0.3, 0.2
    x_ref = hover_state().expand(H + 1, 13).contiguous()
    u_prev = b.cost_params.uref.clone()
    rs = np.random.RandomState(3)
    u = torch.from_numpy(rs.uniform(0.3, 0.95, (H, 4)).astype(np.float32))
    out = {}
    for name, orders in (("serial", (serial, serial_t)), ("wide", (sliced, lanes_t))):
        monkeypatch.setattr(M, "trunk_apply", trunk_in(*orders))
        oracle = CO.cost_oracle_plain(b.model, params, b.cost_params, b.time_steps, x0, x_ref,
                                      u_prev, None, 1, 4)
        out[name] = oracle.value_and_grad(u)
    (v_s, g_s), (v_w, g_w) = out["serial"], out["wide"]
    assert torch.isfinite(g_w).all() and float(g_w.abs().max()) > 0
    assert float(v_w) == pytest.approx(float(v_s), rel=VAL_RTOL)
    torch.testing.assert_close(g_w, g_s, rtol=G_RTOL, atol=G_ATOL)
