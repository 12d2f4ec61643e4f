"""K8's dispatch and the semantics its kernel is held to, on the CPU.

``qrcp_device`` runs kernel K8 (``csrc/kernels.cu:qrcp_kernel``, one
cooperative launch) on a CUDA tensor and its plain version, the eager loop
``qrcp_device_plain``, on a CPU one.  The kernel runs only on the card,
where ``chip_smoke.py`` holds it against the plain version; here the plain
version is held to the JAX package's ``qrcp_device`` on the matrices whose
pivots the position rule decides (the first maximal norm wins, as argmax
takes it): 1x1, 2x2, the identity and a permutation matrix (every norm ties
at every step), two equal columns, a zero column and the zero matrix.
Pivots must be equal in full; Q and R within 1e-12 (f64) / 1e-5 (f32) of
the JAX factors relative to their largest entry, each reflector's sign
taken from R's diagonal (a zero counts as +).  The wrapper's refusals are
checked without a compiler: they come before the library is loaded.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifir_tpu.small_scale.qrcp_device import qrcp_device as jqrcp_device

from hifir_tpu_torch.kernels import build
from hifir_tpu_torch.small_scale import qrcp_device as qd


def _rel(X, Xref) -> float:
    """Largest difference relative to Xref's largest entry (0 for two zero
    matrices)."""
    return np.abs(X - Xref).max() / max(np.abs(Xref).max(), 1e-300)


def _ties() -> dict:
    rng = np.random.default_rng(5)
    B = rng.standard_normal((8, 8))
    eq, zc = B.copy(), B.copy()
    eq[:, 5] = eq[:, 2]
    zc[:, 3] = 0.0
    return {"1x1": np.array([[-3.0]]), "2x2": rng.standard_normal((2, 2)),
            "identity": np.eye(8),
            "permutation": np.eye(8)[rng.permutation(8)],
            "equal_columns": eq, "zero_column": zc, "zero": np.zeros((8, 8))}


_TIES = _ties()


def _signed(Q, R):
    s = np.where(np.diag(R) < 0, -1.0, 1.0)
    return Q * s, R * s[:, None]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(_TIES))
def test_plain_matches_jax_on_ties(name, dtype):
    D = _TIES[name].astype(dtype)
    calls = qd.qrcp_device_plain.calls
    Q, R, piv = (a.numpy() for a in qd.qrcp_device_plain(torch.from_numpy(D)))
    assert qd.qrcp_device_plain.calls == calls + 1
    Qj, Rj, pj = (np.asarray(a) for a in jqrcp_device(jnp.asarray(D)))
    np.testing.assert_array_equal(piv, pj)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    (q, r), (qj, rj) = _signed(Q, R), _signed(Qj, Rj)
    assert _rel(q, qj) <= tol
    assert _rel(r, rj) <= tol
    assert np.abs(Q @ R - D[:, piv]).max() <= 10 * tol * max(
        np.abs(D).max(), 1.0)


def test_ties_resolve_to_the_first_position():
    """The rule the kernel's grid reduction must keep: among equal norms
    the lowest logical position wins, at every step."""
    for name in ("identity", "permutation", "zero"):
        piv = qd.qrcp_device_plain(torch.from_numpy(_TIES[name]))[2]
        np.testing.assert_array_equal(piv.numpy(), np.arange(8))
    # the duplicate of a pivoted column has no norm left: it comes last
    piv = qd.qrcp_device_plain(torch.from_numpy(_TIES["equal_columns"]))[2]
    assert piv[-1] == 5 and 2 in piv[:-1].tolist()
    piv = qd.qrcp_device_plain(torch.from_numpy(_TIES["zero_column"]))[2]
    assert piv[-1] == 3


def test_cpu_tensor_takes_the_plain_route():
    A = torch.from_numpy(_TIES["2x2"])
    calls, plain = qd.qrcp_device.calls, qd.qrcp_device_plain.calls
    launches = qd.qrcp_device_cuda.launches
    Q, R, piv = qd.qrcp_device(A)
    assert qd.qrcp_device.calls == calls + 1
    assert qd.qrcp_device_plain.calls == plain + 1
    assert qd.qrcp_device_cuda.launches == launches
    assert Q.device.type == R.device.type == piv.device.type == "cpu"


@pytest.fixture
def no_compiler(monkeypatch):
    """Loading the library or asking for nvcc fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(build, "load_kernels", refuse)
    monkeypatch.setattr(build, "nvcc_path", refuse)
    monkeypatch.setattr(qd, "load_kernels", refuse)


@pytest.mark.parametrize("case", ["cpu", "complex", "non-square", "half"])
def test_cuda_wrapper_refuses_before_loading(no_compiler, case):
    launches = qd.qrcp_device_cuda.launches
    A, err, what = {
        "cpu": (torch.eye(4, dtype=torch.float64), ValueError, "CUDA"),
        "complex": (torch.eye(4, dtype=torch.complex128), TypeError,
                    "real only"),
        "non-square": (torch.ones(3, 4, dtype=torch.float64), ValueError,
                       "square"),
        "half": (torch.eye(4, dtype=torch.float16), TypeError,
                 "float32, float64 required"),
    }[case]
    with pytest.raises(err, match=what):
        qd.qrcp_device_cuda(A)
    assert qd.qrcp_device_cuda.launches == launches


def test_build_lists_qrcp_real_only():
    for name in ("qrcp", "qrcp_plan"):
        assert build.SUFFIXES[name] == ("f32", "f64")
        assert name in build._SIGNATURES
    assert build.dtype_suffix("qrcp", torch.float32) == "f32"
    assert build.dtype_suffix("qrcp", torch.float64) == "f64"
    for dt in (torch.complex64, torch.complex128, torch.float16):
        with pytest.raises(TypeError, match="float32, float64 required"):
            build.dtype_suffix("qrcp", dt)
    # the launch takes A, n, columns a CTA, the layout, the grid, Q, R,
    # piv, R's scratch, the CTAs' x, map and inverse, the candidates'
    # columns, norms and positions, the stream
    assert len(build._SIGNATURES["qrcp"]) == 14


# a block's dynamic shared memory on the H100 (kernels.cu:kMaxSmem)
MAX_SMEM = 227 * 1024


@pytest.mark.parametrize("n, itemsize, layout, bytes_global", [
    (360, 8, "shared", None), (2000, 8, "global", None),
    (14464, 8, "global", 232448), (14465, 8, "global_x", 232496),
    (19312, 4, "global", 232416), (19313, 4, "global_x", 232464)])
def test_layout_thresholds(no_compiler, n, itemsize, layout, bytes_global):
    """On 132 SMs the tails that fit keep their layout; x, the map and its
    inverse leave shared memory from n = 14465 in f64 and 19313 in f32,
    where the global layout would need more than a block holds."""
    plan = qd.qrcp_layout(n, itemsize, 132, MAX_SMEM)
    assert plan["layout"] == layout
    assert plan["cols"] == max(8, -(-n // 132))
    assert plan["grid"] == -(-n // plan["cols"])
    assert plan["smem"] == qd.qrcp_smem(n, plan["cols"], itemsize, layout)
    if bytes_global is not None:
        assert qd.qrcp_smem(n, plan["cols"], itemsize,
                            "global") == bytes_global
    if layout == "global_x":
        # the norms and the warps' partial sums only
        assert plan["smem"] < 5000


def test_no_n_refused_for_shared_memory(no_compiler):
    for itemsize in (4, 8):
        worst = max(qd.qrcp_layout(n, itemsize, 132, MAX_SMEM)["smem"]
                    for n in range(1, 65537))
        assert worst <= MAX_SMEM


def test_forced_layout(no_compiler):
    """A layout asked for is taken where it fits and refused, naming the
    limit, where it does not."""
    plan = qd.qrcp_layout(33, 8, 132, MAX_SMEM, layout="global_x")
    assert (plan["layout"], plan["cols"], plan["grid"]) == ("global_x", 8, 5)
    assert qd.qrcp_layout(736, 4, 132, MAX_SMEM,
                          layout="global_x")["layout"] == "global_x"
    with pytest.raises(ValueError, match="more than a block's 232448"):
        qd.qrcp_layout(2000, 8, 132, MAX_SMEM, layout="shared")
    with pytest.raises(ValueError, match="not in"):
        qd.qrcp_layout(33, 8, 132, MAX_SMEM, layout="registers")
    assert qd.qrcp_vec_bytes(14465, 8) == 115728 + 2 * 57872
