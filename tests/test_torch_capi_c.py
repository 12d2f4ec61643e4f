"""The port's compiled C ABI shim: ``tests/capi/test_capi.c``, unchanged,
compiled against ``hifir_tpu_torch/native/capi/libhifir_tpu.h`` and linked
with the shim that ``hifir_tpu_torch.native.build.build_capi`` builds into
``build/hifir_tpu_torch/capi/``.

The C program assembles a small sparse system, factorizes it through the
handle API, exercises the four apply modes, iterative refinement, the
mixed-precision (sd) and complex (z) appliers, and must print ``all
checks passed``.  It runs twice: once as is, and once with ``PYTHONPATH``
led by a directory of stub ``hifir_tpu`` and ``jax`` packages whose import
raises, which shows that the embedded interpreter reaches only the port.
Nothing is built or written under ``hifir_tpu/``.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
CAPI = REPO / "hifir_tpu_torch" / "native" / "capi"
NEEDS = pytest.mark.skipif(
    shutil.which("gcc") is None or (
        shutil.which("python3-config") is None
        and not pathlib.Path(sys.executable).with_name(
            "python3-config").exists()),
    reason="no C compiler or no python3-config")


@pytest.fixture(scope="module")
def capi_exe(tmp_path_factory):
    from hifir_tpu_torch.native.build import build_capi

    shim, _ = build_capi()
    exe = tmp_path_factory.mktemp("capi") / "test_capi"
    r = subprocess.run(
        ["gcc", "-O2", "-std=c99", f"-I{CAPI}",
         str(REPO / "tests" / "capi" / "test_capi.c"), str(shim),
         f"-Wl,-rpath,{shim.parent}", "-lm", "-o", str(exe)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return exe


def _run(exe, pythonpath):
    env = dict(os.environ)
    env["LHF_PYTHON"] = sys.executable
    env["PYTHONPATH"] = os.pathsep.join(map(str, pythonpath))
    r = subprocess.run([str(exe)], capture_output=True, text=True, env=env,
                       timeout=600)
    sys.stdout.write(r.stdout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "all checks passed" in r.stdout
    return r.stdout


@NEEDS
def test_capi_end_to_end(capi_exe):
    out = _run(capi_exe, [REPO])
    assert "FAIL" not in out


@NEEDS
def test_capi_reaches_only_the_port(capi_exe, tmp_path):
    for pkg in ("hifir_tpu", "jax"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "__init__.py").write_text(
            f"raise ImportError('the C ABI shim imported {pkg}')\n")
    _run(capi_exe, [tmp_path, REPO])


@NEEDS
def test_capi_version_is_the_ports(tmp_path):
    """lhfGetVersions returns hifir_tpu_torch/version.py's triple."""
    from hifir_tpu_torch.native.build import build_capi
    from hifir_tpu_torch.version import (VERSION_MAJOR, VERSION_MINOR,
                                         VERSION_PATCH)

    shim, _ = build_capi()
    src = tmp_path / "v.c"
    src.write_text('#include <stdio.h>\n#include "libhifir_tpu.h"\n'
                   "int main(void) { int v[3]; lhfGetVersions(v);\n"
                   '  printf("%d.%d.%d\\n", v[0], v[1], v[2]); return 0; }\n')
    exe = tmp_path / "v"
    r = subprocess.run(["gcc", "-std=c99", f"-I{CAPI}", str(src), str(shim),
                        f"-Wl,-rpath,{shim.parent}", "-o", str(exe)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    assert out == f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_PATCH}"


@NEEDS
@pytest.mark.skipif(shutil.which("nm") is None, reason="no nm")
def test_capi_exports_every_header_function():
    """Every ``lhf*`` function the header declares (the reference
    exports, the four SolveMrhs extensions, lhfInitialize and lhfFinalize)
    is defined by the shim, and the header declares what the JAX header
    does."""
    import re

    from hifir_tpu_torch.native.build import build_capi

    def declared(path):
        return set(re.findall(r"\b(lhf\w+)\s*\(", path.read_text()))

    names = declared(CAPI / "libhifir_tpu.h")
    assert names == declared(REPO / "hifir_tpu" / "native" / "capi"
                             / "libhifir_tpu.h")
    assert len([n for n in names if "SolveMrhs" in n]) == 4
    shim, _ = build_capi()
    out = subprocess.run(["nm", "-D", "--defined-only", str(shim)],
                         capture_output=True, text=True, check=True).stdout
    defined = {ln.split()[-1] for ln in out.splitlines()
               if " T " in ln and ln.split()[-1].startswith("lhf")}
    assert names <= defined, sorted(names - defined)
