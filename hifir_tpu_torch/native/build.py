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

Two more targets of the JAX Makefile are built on request, the same way
(hashed name, file lock, the compiler's output on failure):
:func:`build_capi`, the C ABI shim ``native/capi/capi.cpp`` that embeds
CPython (into ``build/hifir_tpu_torch/capi/``), and
:func:`build_bench_crout`, the Crout replay tool
``native/bench/bench_crout.cpp`` linked against the host library (into
``build/hifir_tpu_torch/native/``).
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
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["NativeLib", "load_native", "build_library", "library_path",
           "build_capi", "build_bench_crout", "python_flags", "CXXFLAGS",
           "SOURCE_DIR", "BUILD_DIR", "CAPI_DIR", "CAPI_BUILD_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hifir_tpu_torch" \
    / "native"
CAPI_DIR = Path(__file__).resolve().parent / "capi"
CAPI_BUILD_DIR = BUILD_DIR.parent / "capi"
BENCH_SOURCE = Path(__file__).resolve().parent / "bench" / "bench_crout.cpp"
# hifir_tpu/native/Makefile, the capi and bench rules
CAPI_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-Wall")
BENCH_FLAGS = ("-std=c++17", "-O2", "-Wall")
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


def _hashed(out_dir: Path, stem: str, suffix: str, files, flags) -> Path:
    """``out_dir/{stem}_{hash}{suffix}``, the hash over ``files``, the
    flags and the compiler with its version."""
    cxx = _cxx()
    h = hashlib.sha256()
    for p in files:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    h.update("\0".join((*flags, cxx, version)).encode())
    return out_dir / f"{stem}_{h.hexdigest()[:16]}{suffix}"


def library_path(src_dir: Path, out_dir: Path, stem: str) -> Path:
    """``out_dir/{stem}_{hash}.so``, the hash over the sources and headers
    of ``src_dir``, the flags, the compiler and the host CPU."""
    return _hashed(out_dir, stem, ".so", sorted(src_dir.glob("*.[ch]pp")),
                   (*CXXFLAGS, _host_key()))


def _locked(out_dir: Path, stem: str, target: Path, make) -> tuple:
    """Run ``make(tmp_target, tmp_dir)`` under ``out_dir``'s lock for
    ``stem`` unless ``target`` exists (another process may build it while
    this one waits), then move the result into place; returns ``(target,
    seconds)``, seconds 0.0 when it was already there."""
    if target.exists():
        return target, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f".{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return target, 0.0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_target = Path(tmp) / target.name
            make(tmp_target, Path(tmp))
            os.replace(tmp_target, target)
        return target, time.perf_counter() - t0


def _run(cmd: list, what: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (code {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def build_library(src_dir: Path, out_dir: Path, stem: str) -> tuple:
    """Compile every ``*.cpp`` of ``src_dir`` (each in its own ``g++``
    process, all started together) and link them into
    :func:`library_path`; returns ``(path, seconds)``, seconds 0.0 when
    the library was already there.  Raises with the compiler's output if a
    step fails."""
    cxx = _cxx()
    srcs = sorted(src_dir.glob("*.cpp"))

    def make(so: Path, tmp: Path) -> None:
        objs = [tmp / f"{p.stem}.o" for p in srcs]
        procs = [(subprocess.Popen([cxx, *CXXFLAGS, "-c", str(p), "-o",
                                    str(o)], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True), p)
                 for p, o in zip(srcs, objs)]
        failed = []
        for proc, p in procs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{p.name} (code {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError(f"g++ failed to compile {len(failed)} of "
                               f"{len(srcs)} sources of {src_dir}:\n"
                               + "\n".join(failed))
        _run([cxx, "-shared", "-fopenmp", "-o", str(so), *map(str, objs)],
             f"g++ linking {so.name}")

    return _locked(out_dir, stem, library_path(src_dir, out_dir, stem), make)


@functools.cache
def python_flags() -> tuple:
    """``(includes, ldflags)`` of the running interpreter from
    ``python3-config --includes`` and ``--ldflags --embed`` (the
    ``python3.X-config`` beside ``sys.executable`` first, then the one on
    PATH), with an rpath for each library directory; raises when there is
    none."""
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}-config"
    cands = [Path(sys.executable).with_name(ver),
             Path(sys.executable).with_name("python3-config"),
             shutil.which(ver), shutil.which("python3-config")]
    cfg = next((str(c) for c in cands if c and Path(c).is_file()), None)
    if cfg is None:
        raise RuntimeError("python3-config was not found: the C ABI shim "
                           "embeds CPython and needs its flags")

    def ask(*args) -> list:
        proc = subprocess.run([cfg, *args], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cfg} {' '.join(args)} failed (code "
                               f"{proc.returncode}):\n{proc.stderr}")
        return proc.stdout.split()

    inc = ask("--includes")
    ld = ask("--ldflags", "--embed")
    ld += [f"-Wl,-rpath,{f[2:]}" for f in ld if f.startswith("-L")]
    return tuple(inc), tuple(ld)


def build_capi() -> tuple:
    """Build the C ABI shim ``native/capi/capi.cpp`` (the JAX Makefile's
    ``capi/libhifir_tpu_capi.so`` rule, with the Python flags taken from
    :func:`python_flags` instead of a fixed ``-lpython3.12``, and the
    version triple of ``version.py`` as ``-DLHF_VERSION_*``) into
    ``build/hifir_tpu_torch/capi/libhifir_tpu_capi_<hash>.so``; returns
    ``(path, seconds)``.  Link C programs against it with
    ``-I hifir_tpu_torch/native/capi``."""
    from ..version import VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH

    inc, ld = python_flags()
    vers = (f"-DLHF_VERSION_MAJOR={VERSION_MAJOR}",
            f"-DLHF_VERSION_MINOR={VERSION_MINOR}",
            f"-DLHF_VERSION_PATCH={VERSION_PATCH}")
    src = CAPI_DIR / "capi.cpp"
    flags = (*CAPI_FLAGS, *vers, *inc)
    so = _hashed(CAPI_BUILD_DIR, "libhifir_tpu_capi", ".so",
                 (src, CAPI_DIR / "libhifir_tpu.h"), (*flags, *ld))
    return _locked(CAPI_BUILD_DIR, "libhifir_tpu_capi", so, lambda out, _: _run(
        [_cxx(), *flags, f"-I{CAPI_DIR}", "-o", str(out), str(src), *ld],
        f"g++ on {src.name}"))


def build_bench_crout() -> tuple:
    """Build the Crout replay tool ``native/bench/bench_crout.cpp`` (the
    JAX Makefile's ``bench`` rule) linked against the port's host library
    (built first if needed) into
    ``build/hifir_tpu_torch/native/bench_crout_<hash>``, beside the
    library, which it finds through ``$ORIGIN``; returns
    ``(path, seconds)``.  Run it as ``bench_crout <dumpfile> [reps]`` on a
    file written by the ``HT_DUMP_CROUT`` hook of ``pre/_native.py``."""
    lib, _ = build_library(SOURCE_DIR, BUILD_DIR, "libhifir_native")
    flags = (*BENCH_FLAGS, lib.name)
    exe = _hashed(BUILD_DIR, "bench_crout", "", (BENCH_SOURCE,), flags)
    return _locked(BUILD_DIR, "bench_crout", exe, lambda out, _: _run(
        [_cxx(), *BENCH_FLAGS, "-o", str(out), str(BENCH_SOURCE),
         f"-L{lib.parent}", f"-l:{lib.name}", "-Wl,-rpath,$ORIGIN"],
        f"g++ on {BENCH_SOURCE.name}"))


@functools.cache
def load_native() -> NativeLib:
    """Build (if needed) and load the port's native host library; raises
    on failure."""
    so, seconds = build_library(SOURCE_DIR, BUILD_DIR, "libhifir_native")
    return NativeLib(ctypes.CDLL(str(so)), so, seconds)
