"""Learning: the SDE trainer, model evaluation and policy distillation,
the PyTorch counterparts of ``sde4mbrl_px4_tpu/learning/`` with the same
exports."""
from sde4mbrl_px4_tpu_torch.learning.trainer import (  # noqa: F401
    TrainConfig,
    TrajectoryDataset,
    make_loss_fn,
    sequence_from_flight_log,
    train_sde,
)
from sde4mbrl_px4_tpu_torch.learning.evaluate import (  # noqa: F401
    calibration,
    evaluate_model,
    kstep_errors,
)
from sde4mbrl_px4_tpu_torch.learning.distill import (  # noqa: F401
    DistillConfig,
    distill_policy,
    load_policy,
    save_policy,
    train_policy,
)
