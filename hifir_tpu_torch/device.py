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

__all__ = ["resolve_device", "torch_dtype", "numpy_dtype", "real_dtype",
           "as_values"]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
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
    """torch dtype of a numpy/torch dtype or dtype name: float32, float64,
    complex64, complex128, int32 or int64."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if dt not in _NP_TO_TORCH:
        raise TypeError(f"unsupported dtype {dt}: the port handles float32, "
                        "float64, complex64, complex128, int32 and int64")
    return _NP_TO_TORCH[dt]


def real_dtype(dtype) -> torch.dtype:
    """The real torch dtype of a value dtype: float32 for complex64, float64
    for complex128, the dtype itself for a real one."""
    dt = torch_dtype(dtype)
    return dt.to_real() if dt.is_complex else dt


def as_values(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` on ``device`` whose memory holds its
    values: a lazy conjugate or negative view is resolved, since the kernels
    read memory as it is."""
    return torch.as_tensor(x, dtype=dtype, device=device).resolve_conj() \
        .resolve_neg()
