"""sde4mbrl_px4_tpu_torch — the neural-SDE MPC framework on PyTorch and CUDA.

The port of ``sde4mbrl_px4_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100, one slice at a time, with the same layout (``core``, ``models``,
``ops``, ``cost``, ``solver``, ``engine``, ``io``). It imports ``torch``
and numpy and never JAX. The hot path, one receding-horizon APG solve, is
a hand-written CUDA kernel (``csrc/apg_solve.cu``) built with ``nvcc`` at
first use; on the CPU the same functions run in plain PyTorch.
"""

__version__ = "0.1.0"

from sde4mbrl_px4_tpu_torch.core.frames import enu2ned, ned2enu  # noqa: F401
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile  # noqa: F401
