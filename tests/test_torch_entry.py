"""The port's entry points (``hifir_tpu_torch/entry.py``) against
``__graft_entry__.py``.

Both packages factorize with their native libraries (the ``jax_lib``
fixture of ``tests/test_torch_native.py``), so that the two factorizations
of the entry's operators are equal level by level.  ``entry()``'s M-solve
is held to the JAX entry's ``fn(*args)`` within 1e-5 of max|X| (float32);
``dryrun_multichip(8)`` passes its asserts on eight CPU ranks and its
DistPrec has the JAX DistPrec's exchange counts.  The JAX entry's XLA
compile cache is switched off for the test (it would write outside the
checkout); nothing of the JAX package is edited.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import __graft_entry__ as graft  # noqa: E402
from hifir_tpu.parallel import DistPrec as JDistPrec  # noqa: E402
from hifir_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402

from hifir_tpu_torch import entry as tentry  # noqa: E402

from test_torch_factorize import assert_levels_equal  # noqa: E402
from test_torch_native import jax_lib, jax_lib_path  # noqa: E402,F401


@pytest.fixture
def no_cache(monkeypatch):
    monkeypatch.setattr(graft, "_enable_compile_cache", lambda: None)


def test_entry_matches_jax_entry(jax_lib, no_cache):  # noqa: F811
    """The same convdiff2d(12) factorization in both packages; the port's
    fn(*args) within 1e-5 max|X| of the JAX entry's, float32, (n, 8)."""
    _, J = graft._small_prec(nx=12)
    _, P = tentry._small_prec(nx=12)
    assert_levels_equal(P, J)
    jfn, jargs = graft.entry()
    fn, args = tentry.entry(device="cpu")
    JX = np.asarray(jfn(*jargs))
    X = fn(*args)
    assert X.dtype.is_floating_point and X.dtype.itemsize == 4
    assert tuple(X.shape) == JX.shape == (144, 8)
    X = X.numpy()
    assert np.all(np.isfinite(X))
    np.testing.assert_allclose(X, JX, rtol=0, atol=1e-5 * np.abs(JX).max())
    # and the host's f64 solve of the same block
    xh = P.solve(np.ones(144))
    np.testing.assert_allclose(X[:, 3], xh, rtol=0,
                               atol=1e-4 * np.abs(xh).max())


def test_entry_returns_the_compiled_solve_and_operands(monkeypatch):
    """As the JAX entry returns its jitted solve and ``operands()``: ``fn``
    is ``prec_solve_mrhs`` compiled against the pack, ``args`` the pack's
    ``operands()`` and B.  Eager on the CPU; through the graph cache (the
    stand-in backend of ``test_torch_graphs.py``) its first call captures
    and later calls replay, each equal to the eager solve bit for bit."""
    from hifir_tpu_torch import graphs
    from hifir_tpu_torch.alg.prec import prec_solve_mrhs

    from test_torch_graphs import EagerGraphs

    fn, args = tentry.entry(device="cpu")
    assert fn.__wrapped__ is prec_solve_mrhs and len(args) == 3
    levels, tail, B = args
    ref = prec_solve_mrhs(levels, tail, B)
    assert torch.equal(fn(*args), ref)
    made = []

    class Counted(EagerGraphs):
        def __init__(self, device):
            super().__init__(device)
            made.append(self)

    monkeypatch.setitem(graphs.BACKENDS, "cpu", Counted)
    for _ in range(3):
        assert torch.equal(fn(*args), ref)
    assert len(made) == 1 and (made[0].captures, made[0].replays) == (1, 2)


def test_dryrun_multichip_matches_jax_counts(jax_lib):  # noqa: F811
    """The dry run on eight CPU ranks passes its asserts; its DistPrec's
    exchange counts equal the JAX DistPrec's on the JAX factorization of
    the same operator (``chunk=32``, ``make_mesh(8, rhs=1)``)."""
    rep = tentry.dryrun_multichip(8, device="cpu")
    assert rep["ir_residual2"] < rep["ir_residual0"]
    _, J = graft._small_prec(nx=40)
    assert_levels_equal(rep["M"], J)
    assert J.levels() >= 3
    jdp = JDistPrec.from_host(jmake_mesh(8, rhs=1), J, chunk=32)
    dp = rep["dist"]
    assert (dp.comm_elems, dp.allgather_elems, dp.n_halo) == (
        jdp.comm_elems, jdp.allgather_elems, jdp.n_halo)
    assert dp.n_halo > 0 and dp.comm_elems < dp.allgather_elems


@pytest.mark.parametrize("n_ranks", [1, 3])
def test_dryrun_multichip_other_rank_counts(n_ranks):
    """One rank (no halo, rhs=1) and an odd count (rhs=1) pass too."""
    rep = tentry.dryrun_multichip(n_ranks, device="cpu")
    assert rep["dist"].mesh.D == n_ranks
    assert np.abs(rep["x"] - rep["x_host"]).max() <= 1e-8 * max(
        1.0, np.abs(rep["x_host"]).max())


def test_entry_imports_neither_jax_nor_hifir_tpu():
    code = ("import sys\n"
            "import hifir_tpu_torch.entry as e\n"
            "fn, args = e.entry(device='cpu')\n"
            "assert bool(fn(*args).isfinite().all())\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('jaxlib') or m == 'hifir_tpu'"
            " or m.startswith('hifir_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.dryrun_multichip(8)
