"""Hyper-parameter tuning on the card's scenario axis (L6), the PyTorch
counterpart of ``sde4mbrl_px4_tpu/tuning/`` with the same exports."""
from sde4mbrl_px4_tpu_torch.tuning.tuner import (  # noqa: F401
    TuneResult,
    WeightTuneResult,
    make_mppi_grid,
    make_weight_grid,
    tune_cost_weights,
    tune_mppi,
)

__all__ = ["TuneResult", "WeightTuneResult", "make_mppi_grid",
           "make_weight_grid", "tune_cost_weights", "tune_mppi"]
