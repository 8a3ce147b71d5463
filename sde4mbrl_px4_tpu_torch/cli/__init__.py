"""Mission / operator layer (L6), the PyTorch counterpart of
``sde4mbrl_px4_tpu/cli/`` with the same exports."""
from sde4mbrl_px4_tpu_torch.cli.mission import MissionControl, SimVehicle, repl  # noqa: F401
