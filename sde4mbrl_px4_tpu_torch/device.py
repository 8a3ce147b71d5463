"""Device and dtype policy: fp32 everywhere, TF32 off.

Reduced precision on the control-to-wrench product makes the solver stall
short of the optimum (``sde4mbrl_px4_tpu/models/sde_model.py:167-176``), so
every float matmul of the port runs in full fp32. The loader applies this
policy before it builds anything; callers pass their ``device`` explicitly.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["apply_fp32_policy", "resolve_device"]


def apply_fp32_policy() -> None:
    """Turn TF32 off for matmuls and convolutions; fp32 matmul at "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """``None`` means the CPU; a CUDA device must exist when asked for."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
