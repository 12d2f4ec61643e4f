"""Build and load the native host library (``native/src/*.cpp``).

``g++`` (the first of ``$CXX``, ``g++`` on PATH and ``/usr/bin/g++`` that
links OpenMP) compiles the translation units in parallel, with the flags
of the JAX package's ``native/Makefile``, and links them into a shared
library under ``build/hifir_tpu_torch/native/`` at the root of the
checkout, at first use; ``ctypes`` loads it.  ``-ffp-contract=off`` and the absence of
``-ffast-math`` keep the kernels equal to the numpy anchors bit for bit.
The library's name carries a hash of the sources, the flags, the compiler
and the host CPU: it is built with ``-march=native``, and a library built on
one CPU can die with SIGILL on another.  A file lock lets one process build
while the others wait (parallel test workers).  A failed build raises with
the compiler's output.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["NativeLib", "load_native", "build_library", "library_path",
           "CXXFLAGS", "SOURCE_DIR", "BUILD_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hifir_tpu_torch" \
    / "native"
# hifir_tpu/native/Makefile, CXXFLAGS
CXXFLAGS = ("-std=c++17", "-O3", "-march=native", "-ffp-contract=off",
            "-fno-math-errno", "-fno-trapping-math", "-funroll-loops",
            "-fopenmp", "-fPIC", "-fvisibility=hidden", "-Wall")


@dataclasses.dataclass(frozen=True)
class NativeLib:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when the library was already built


@functools.cache
def _cxx() -> str:
    """The first of ``$CXX``, ``g++`` on PATH and ``/usr/bin/g++`` that
    compiles and links a shared library with ``-fopenmp`` (the Crout's
    threads need OpenMP, and a compiler can lack its runtime); raises with
    each one's error when none does."""
    errors = []
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "omp.cpp"
        src.write_text("#include <omp.h>\n"
                       "int f() { return omp_get_max_threads(); }\n")
        for cxx in dict.fromkeys((os.environ.get("CXX"), shutil.which("g++"),
                                  "/usr/bin/g++")):
            if not cxx:
                continue
            try:
                proc = subprocess.run(
                    [cxx, "-fopenmp", "-fPIC", "-shared", str(src), "-o",
                     str(Path(tmp) / "omp.so")], capture_output=True,
                    text=True)
            except OSError as e:
                errors.append(f"{cxx}: {e}")
                continue
            if proc.returncode == 0:
                return cxx
            errors.append(f"{cxx} (code {proc.returncode}): "
                          f"{proc.stderr.strip()}")
    raise RuntimeError("no C++ compiler that links OpenMP was found (set "
                       "CXX) to build hifir_tpu_torch's native host "
                       "library:\n" + "\n".join(errors))


def _host_key() -> str:
    """What ``-march=native`` resolves from: the CPU's model and feature
    flags (the first processor of /proc/cpuinfo) and the machine type."""
    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    key += line
                elif not line.strip():
                    break
    except OSError:
        key += platform.processor()
    return key


def library_path(src_dir: Path, out_dir: Path, stem: str) -> Path:
    """``out_dir/{stem}_{hash}.so``, the hash over the sources and headers
    of ``src_dir``, the flags, the compiler and the host CPU."""
    cxx = _cxx()
    h = hashlib.sha256()
    for p in sorted(src_dir.glob("*.[ch]pp")):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    h.update("\0".join((*CXXFLAGS, cxx, version, _host_key())).encode())
    return out_dir / f"{stem}_{h.hexdigest()[:16]}.so"


def build_library(src_dir: Path, out_dir: Path, stem: str) -> tuple:
    """Compile every ``*.cpp`` of ``src_dir`` (each in its own ``g++``
    process, all started together) and link them into
    :func:`library_path`; returns ``(path, seconds)``, seconds 0.0 when
    the library was already there.  Raises with the compiler's output if a
    step fails."""
    cxx = _cxx()
    srcs = sorted(src_dir.glob("*.cpp"))
    so = library_path(src_dir, out_dir, stem)
    if so.exists():
        return so, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f".{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():   # another process built it while we waited
            return so, 0.0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [Path(tmp) / f"{p.stem}.o" for p in srcs]
            procs = [(subprocess.Popen([cxx, *CXXFLAGS, "-c", str(p), "-o",
                                        str(o)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      p) for p, o in zip(srcs, objs)]
            failed = []
            for proc, p in procs:
                out = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(f"{p.name} (code {proc.returncode}):\n"
                                  f"{out}")
            if failed:
                raise RuntimeError(f"g++ failed to compile "
                                   f"{len(failed)} of {len(srcs)} sources "
                                   f"of {src_dir}:\n" + "\n".join(failed))
            tmp_so = Path(tmp) / so.name
            link = [cxx, "-shared", "-fopenmp", "-o", str(tmp_so),
                    *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to link {so.name} (code "
                                   f"{proc.returncode}):\n{' '.join(link)}\n"
                                   f"{proc.stderr}")
            os.replace(tmp_so, so)
        return so, time.perf_counter() - t0


@functools.cache
def load_native() -> NativeLib:
    """Build (if needed) and load the port's native host library; raises
    on failure."""
    so, seconds = build_library(SOURCE_DIR, BUILD_DIR, "libhifir_native")
    return NativeLib(ctypes.CDLL(str(so)), so, seconds)
