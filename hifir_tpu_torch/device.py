"""Device and dtype resolution for the PyTorch/CUDA port.

Every entry point of the package takes ``device="cuda"`` by default.  The
CPU runs only when the caller asks for it with ``device="cpu"`` (the tests
do); a missing card is an error, never a silent fall-back.
"""

from __future__ import annotations

import numpy as np
import torch

# Full-precision float32 products everywhere: the counterpart of the JAX
# package's ``Precision.HIGHEST`` (TF32 keeps ~3 decimal digits, which misses
# the 1e-4 f32 M-solve gate).  Set for matmul and cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device", "torch_dtype", "numpy_dtype"]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: hifir_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run on the CPU")
    return dev


def numpy_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy/torch dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy/torch dtype or dtype name (real types only)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if dt not in _NP_TO_TORCH:
        raise TypeError(f"unsupported dtype {dt}: the port handles float32, "
                        "float64, int32 and int64")
    return _NP_TO_TORCH[dt]
