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

__all__ = ["KernelLib", "load_kernels", "check", "kernel_fn", "dtype_suffix",
           "nvcc_path", "nvcc_version", "BUILD_DIR", "SOURCE", "SUFFIXES"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hifir_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "bsr_spmv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sell_spmv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I,
                  _I, _P],
    "trsv_solve": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I,
                   _I, _P, _P],
    "chunk_fma": [_P, _L, _I, _I, _P, _P, _L, _I, _I, _I, _P, _P],
    "chunk_sweep": [_P, _L, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                    _P],
    "chunk_peer": [_I, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                   _I, _I, _I, _I, _I, _P, _P],
    "schur_partial": [_P, _P, _P, _L, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P, _P, _P, _P],
    "qrcp": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "qrcp_plan": [_I, _I, _I, _P],
}
# The value dtypes each entry point is built for (its symbols are
# ``{name}_{suffix}``): K1 and K2 real and complex, K7 real only, as the TPU
# kernel it replaces; K8 real only, as the JAX sweep.
_DTYPE_SUFFIX = {"float32": "f32", "float64": "f64", "complex64": "c64",
                 "complex128": "c128"}
SUFFIXES = {"bsr_spmv": ("f32", "f64"),
            "sell_spmv": ("f32", "f64", "c64", "c128"),
            "trsv_solve": ("f32", "f64", "c64", "c128"),
            "chunk_fma": ("f32", "f64"),
            "chunk_sweep": ("f32", "f64"),
            "chunk_peer": ("f32", "f64"),
            "schur_partial": ("f32", "f64"),
            "qrcp": ("f32", "f64"),
            "qrcp_plan": ("f32", "f64")}


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
        for sfx in SUFFIXES[name]:
            f = getattr(lib, f"{name}_{sfx}")
            f.argtypes = args
            f.restype = ctypes.c_int
    lib.hifir_error_string.argtypes = [ctypes.c_int]
    lib.hifir_error_string.restype = ctypes.c_char_p
    lib.hifir_max_smem.argtypes = []
    lib.hifir_max_smem.restype = ctypes.c_int
    lib.chunk_sweep_smem.argtypes = [_I] * 7
    lib.chunk_sweep_smem.restype = ctypes.c_int64
    lib.read_rate.argtypes = [_P, _L, _P, ctypes.c_uint, _P]
    lib.read_rate.restype = ctypes.c_int
    return KernelLib(lib, so, seconds, log)


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = load_kernels().lib.hifir_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_suffix(name: str, dtype) -> str:
    """The symbol suffix of entry point ``name`` for a torch value dtype;
    raises TypeError for a dtype that ``name`` is not built for."""
    sfx = _DTYPE_SUFFIX.get(str(dtype).removeprefix("torch."))
    if sfx not in SUFFIXES[name]:
        names = {v: k for k, v in _DTYPE_SUFFIX.items()}
        raise TypeError(f"{name}: {', '.join(names[x] for x in SUFFIXES[name])}"
                        f" required, got {dtype}")
    return sfx


def kernel_fn(name: str, index_dtypes=(), **operands):
    """The ``name`` entry point for the value operands' dtype.

    ``operands`` are the launch's tensors by name, in the entry point's
    order.  The value operands (float or complex) must share a dtype that
    ``name`` is built for and carry no conjugate or negative bit: a lazy
    ``.conj()`` view's memory is not conjugated, and the kernel would read
    the unconjugated values.  The other operands must have ``index_dtypes``
    in order.  These checks come first, so that they hold for CPU tensors
    too; then every operand must be a contiguous CUDA tensor on one device.
    Raises on anything the kernels do not take."""
    def is_value(t):
        return t.is_floating_point() or t.is_complex()

    values = {k: t for k, t in operands.items() if is_value(t)}
    ints = [t.dtype for t in operands.values() if not is_value(t)]
    if ints != list(index_dtypes):
        raise TypeError(f"{name}: index dtypes {ints}, expected "
                        f"{list(index_dtypes)}")
    dtype = next(iter(values.values())).dtype
    sfx = dtype_suffix(name, dtype)
    for k, t in values.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes: {k} is {t.dtype}, "
                            f"expected {dtype}")
        if t.is_conj() or t.is_neg():
            raise ValueError(f"{name}: operand {k} has the "
                             f"{'conjugate' if t.is_conj() else 'negative'} "
                             "bit set (a lazy view: the kernel would read "
                             "its memory, not its values); resolve it first")
    dev = next(iter(operands.values())).device
    for k, t in operands.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all operands must be on {dev} (CUDA), "
                             f"got {k} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {k} must be contiguous")
    return load_kernels().fn(name, sfx)
