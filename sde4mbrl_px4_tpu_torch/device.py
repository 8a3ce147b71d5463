"""Device and dtype policy: fp32 everywhere, TF32 off; the card by default.

Reduced precision on the control-to-wrench product makes the solver stall
short of the optimum (``sde4mbrl_px4_tpu/models/sde_model.py:167-176``), so
every float matmul of the port runs in full fp32. The loader applies this
policy before it builds anything.

The port's entry points (the loader, ``CompiledMPC``,
``RecedingHorizonController``, ``goldens.replay*``) run on the card unless
the caller asks for the CPU: ``device=None`` means ``cuda``, and without a
CUDA device they raise instead of carrying on on the CPU. ``"cpu"`` (the
plain PyTorch versions of the kernels) must be asked for, as the tests do.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["apply_fp32_policy", "host_values", "resolve_device"]


def apply_fp32_policy() -> None:
    """Turn TF32 off for matmuls and convolutions; fp32 matmul at "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def host_values(values, device: torch.device) -> torch.Tensor:
    """A float32 tensor of host ``values`` on ``device``. On a CUDA device
    the copy goes from pinned memory with ``non_blocking``: a plain
    ``torch.tensor(..., device="cuda")`` waits for the stream to drain, which
    would make a caller wait for the solve in flight."""
    t = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """``None`` means the card (``cuda``); a CUDA device must exist, or this
    raises naming the missing card. The CPU must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested{' (the default)' if device is None else ''} "
            "but no CUDA card is available (torch.cuda.is_available() is false); "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
