"""Build and load the hand-written CUDA kernels (``csrc/kernels.cu``).

``nvcc`` compiles the source for ``sm_90a`` into a shared library with a
plain C interface under ``build/hifir_tpu_torch/`` at the root of the
checkout, at first use; ``ctypes`` loads it.  The library's name carries a
hash of the source, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time: the CPU tests import every
module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KernelLib", "load_kernels", "check", "kernel_fn", "nvcc_path",
           "nvcc_version", "BUILD_DIR", "SOURCE"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hifir_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "bsr_spmv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sell_spmv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I,
                  _I, _P],
    "trsv_solve": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _P,
                   _P],
}


@dataclasses.dataclass(frozen=True)
class KernelLib:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when the library was already built
    ptxas_log: str         # nvcc's -Xptxas -v report (empty when cached)

    def fn(self, name: str, dtype_suffix: str):
        return getattr(self.lib, f"{name}_{dtype_suffix}")


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME (or $CUDA_PATH), $PATH, or the default toolkit
    location; raises if none is found."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build hifir_tpu_torch's CUDA kernels")


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the build tag)."""
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


@functools.cache
def load_kernels() -> KernelLib:
    """Build (if needed) and load the kernel library; raises on failure."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = BUILD_DIR / f"libhifir_kernels_{tag}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        log = proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        for sfx in ("f32", "f64"):
            f = getattr(lib, f"{name}_{sfx}")
            f.argtypes = args
            f.restype = ctypes.c_int
    lib.hifir_error_string.argtypes = [ctypes.c_int]
    lib.hifir_error_string.restype = ctypes.c_char_p
    lib.read_rate.argtypes = [_P, _L, _P, ctypes.c_uint, _P]
    lib.read_rate.restype = ctypes.c_int
    return KernelLib(lib, so, seconds, log)


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = load_kernels().lib.hifir_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def kernel_fn(name: str, *tensors, index_dtypes=()):
    """The ``name`` entry point for the tensors' float dtype, after checking
    that every tensor is a contiguous CUDA tensor on one device, that the
    float ones share one dtype and that the others have ``index_dtypes`` in
    order; raises on anything the kernels do not take."""
    import torch

    floats = [t for t in tensors if t.is_floating_point()]
    ints = [t.dtype for t in tensors if not t.is_floating_point()]
    if ints != list(index_dtypes):
        raise TypeError(f"{name}: index dtypes {ints}, expected "
                        f"{list(index_dtypes)}")
    dtype = floats[0].dtype
    sfx = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if sfx is None:
        raise TypeError(f"{name}: float32 or float64 required, got {dtype}")
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all operands must be on {dev} (CUDA), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.is_floating_point() and t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
    return load_kernels().fn(name, sfx)
