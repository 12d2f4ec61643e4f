"""The ``HT_DUMP_CROUT`` hook of the port's native bridge and the Crout
replay tool ``hifir_tpu_torch/native/bench/bench_crout.cpp``.

Call 0 of a small f64 factorize, dumped by each package's hook (the JAX
library loaded by the ``jax_lib`` fixture of ``tests/test_torch_native.py``),
gives byte-equal files.  Both hooks count calls in a module-global list
(``_dump_counter``), which an earlier factorize in the same worker has
advanced, so each is replaced by a fresh ``[0]`` for the test with
``monkeypatch.setattr`` (``setitem`` takes a mapping, not a list); the JAX
module is not edited.  ``build_bench_crout`` links the tool against the
port's host library into ``build/hifir_tpu_torch/native/``; one replay of
the port's dump exits 0 and prints the level's m.
"""

import re
import subprocess

import numpy as np
import pytest

import hifir_tpu.pre._native as jnative
from hifir_tpu.api import HIF as JHIF
from hifir_tpu.models import convdiff2d, poisson2d
from hifir_tpu.options import Options as JOptions

import hifir_tpu_torch as ht
import hifir_tpu_torch.pre._native as tnative
from hifir_tpu_torch.native.build import build_bench_crout

from test_torch_native import jax_lib, jax_lib_path  # noqa: F401
from test_torch_prec import _port


def _dump_both(A, opts, call, tmp_path, monkeypatch):
    """Dump crout call ``call`` of both packages' factorizes of A."""
    jpath, tpath = tmp_path / "jax.bin", tmp_path / "port.bin"
    monkeypatch.setattr(jnative, "_dump_counter", [0])
    monkeypatch.setattr(tnative, "_dump_counter", [0])
    monkeypatch.setenv("HT_DUMP_CROUT", f"{call}:{jpath}")
    J = JHIF().factorize(A, JOptions(**opts))
    monkeypatch.setenv("HT_DUMP_CROUT", f"{call}:{tpath}")
    P = ht.HIF().factorize(_port(A), ht.Options(**opts), device="cpu")
    assert tnative._dump_counter[0] == jnative._dump_counter[0] \
        == len(P.precs)
    return J, P, jpath, tpath


@pytest.mark.parametrize("case", ["poisson32", "convdiff32 call 1"])
def test_dump_is_byte_equal_to_jax(case, jax_lib, tmp_path,  # noqa: F811
                                   monkeypatch):
    A = poisson2d(32) if case == "poisson32" else convdiff2d(32)
    call = 1 if "call 1" in case else 0
    opts = dict(verbose=0, dense_thres=50)
    J, P, jpath, tpath = _dump_both(A, opts, call, tmp_path, monkeypatch)
    assert len(P.precs) > call
    jb, tb = jpath.read_bytes(), tpath.read_bytes()
    assert len(tb) > 0 and tb == jb
    hdr = np.frombuffer(tb[:32], dtype=np.int64)
    assert hdr[0] == P.precs[call].n


def test_dump_skips_single_precision(tmp_path, monkeypatch):
    """The hook dumps f64 calls only, as the JAX package's."""
    path = tmp_path / "f32.bin"
    monkeypatch.setattr(tnative, "_dump_counter", [0])
    monkeypatch.setenv("HT_DUMP_CROUT", f"0:{path}")
    ht.HIF().factorize(_port(poisson2d(16)),
                       ht.Options(verbose=0, dtype="float32"), device="cpu")
    assert not path.exists() and tnative._dump_counter[0] == 0


def test_bench_crout_replays_the_dump(tmp_path, monkeypatch):
    path = tmp_path / "port.bin"
    monkeypatch.setattr(tnative, "_dump_counter", [0])
    monkeypatch.setenv("HT_DUMP_CROUT", f"0:{path}")
    P = ht.HIF().factorize(_port(poisson2d(32)),
                           ht.Options(verbose=0, dense_thres=50),
                           device="cpu")
    exe, _ = build_bench_crout()
    assert exe.parent.parts[-3:] == ("build", "hifir_tpu_torch", "native")
    r = subprocess.run([str(exe), str(path), "1"], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"n={P.precs[0].n} " in r.stdout
    ms = re.findall(r"rep 0 crout [0-9.]+ s m=(\d+) ", r.stdout)
    assert ms == [str(P.precs[0].m)], r.stdout
