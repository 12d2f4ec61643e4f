"""The frozen generators give the program's own matrices."""

import numpy as np
import pytest

from hifbench import problems


@pytest.mark.parametrize("gen,nx", [("poisson2d", 5), ("poisson2d", 33),
                                    ("poisson3d", 4), ("poisson3d", 9)])
def test_generators_match_the_program(gen, nx):
    from hifir_tpu_torch.models import problems as port

    A = problems.make({"generator": gen, "nx": nx})
    B = getattr(port, gen)(nx).to_scipy().tocsr()
    B.sort_indices()
    assert A.shape == B.shape
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data)


def test_published_sizes():
    A = problems.make({"generator": "poisson3d", "nx": 64})
    assert A.shape[0] == 262144 and A.nnz == 1810432
    # the 2-D 1M operator: n nx^2 and 5 n - 4 nx entries
    nx = 1024
    assert 5 * nx * nx - 4 * nx == 5238784
