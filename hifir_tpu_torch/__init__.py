"""hifir_tpu_torch: the PyTorch/CUDA port of hifir_tpu's device half.

Loads a multilevel HIF preconditioner saved by ``hifir_tpu``, packs it onto
an NVIDIA GPU and applies it (batched M-solve, HIFIR refinement) through
hand-written CUDA kernels (``csrc/kernels.cu``).  Entry points run on the
card unless the caller passes ``device="cpu"``.  The package imports torch,
numpy and scipy, never jax or hifir_tpu.
"""

from . import device
from .alg.prec import DevicePrec
from .api import HIF, load_prec, prec_from_arrays
from .solvers.ir import ir_apply

__all__ = ["device", "DevicePrec", "HIF", "load_prec", "prec_from_arrays",
           "ir_apply"]
