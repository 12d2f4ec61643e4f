"""hifir_tpu_torch: the PyTorch/CUDA port of hifir_tpu.

Factorizes a multilevel HIF preconditioner on the host
(``HIF().factorize(A, Options(...))``, in the native host library that
``native/build.py`` builds with g++ at first use; the dense tail's QRCP
optionally on the GPU) or loads one saved by either package, applies it on
the host (``HIF.solve``/``solve_mrhs``/``hifir``/``mmultiply``, the host
GMRES of ``solvers/gmres_np.py``), packs it onto an NVIDIA GPU and applies
it there through hand-written CUDA kernels (``csrc/kernels.cu``): the
M-solve and its adjoint, with a runtime rank and null-space filters, the
products M x and M^H x, HIFIR refinement and the GMRES drivers, in
float32, float64, complex64 and complex128; on the card these run as
replays of captured CUDA graphs, the port's jit layer (``graphs``), unless
a pack's ``graphs`` is off.  ``parallel`` distributes the
M-solve, the SpMV, the Schur complement and a partitioned factorization
over a mesh of ranks (eight on one card by default).  ``entry`` holds the
counterparts of ``__graft_entry__.py``'s entry points (the M-solve and a
multi-rank dry run), ``capi`` the
handle API behind the C ABI shim of ``native/capi`` (a host surface), and
``examples`` the device demos.  Device entry points run on the card unless
the caller passes ``device="cpu"``.  The package imports torch, numpy and
scipy, never jax or hifir_tpu.
"""

from . import device
from .alg.prec import DevicePrec
from .api import HIF, load_prec, prec_from_arrays, save_prec
from .nsp import NspFilter
from .options import Options
from .solvers.gmres import fgmres_hifir, gmres_hif, gmres_mrhs
from .solvers.ir import ir_apply
from .version import __version__, version

__all__ = ["device", "DevicePrec", "HIF", "load_prec", "save_prec",
           "prec_from_arrays",
           "NspFilter", "Options", "ir_apply", "gmres_hif", "fgmres_hifir",
           "gmres_mrhs", "__version__", "version"]
