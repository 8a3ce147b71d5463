"""Baseline controllers (L7), the PyTorch counterpart of
``sde4mbrl_px4_tpu/baselines/`` with the same exports."""
from sde4mbrl_px4_tpu_torch.baselines.geometric import (  # noqa: F401
    GeoParams,
    NativeGeometricController,
    geometric_control,
)
