"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

This slice serves LightGBM models on an NVIDIA GPU: `Booster` loads
model text, and `ServingRuntime` answers requests through hand-written
CUDA kernels (`csrc/`).  It imports torch and numpy, never jax and
nothing of `lightgbm_tpu`, which stays the reference the port is tested
against.
"""
from .booster import Booster
from .serving import ServingRuntime
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "ServingRuntime", "LightGBMError"]
