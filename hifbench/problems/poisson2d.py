"""5-point 2-D Poisson on an nx-by-nx grid: 4 on the diagonal, -1 to each
grid neighbour (n = nx**2); a frozen copy of
``hifir_tpu_torch.models.problems.poisson2d``."""

from __future__ import annotations

import numpy as np

from hifbench.problems import assemble


def poisson2d(nx: int):
    idx = np.arange(nx * nx).reshape(nx, nx)
    return assemble(nx * nx, 4.0, [(idx[:, :-1].ravel(), idx[:, 1:].ravel()),
                                   (idx[:-1, :].ravel(), idx[1:, :].ravel())])


def make(config: dict):
    return poisson2d(int(config["nx"]))
