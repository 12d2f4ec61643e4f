"""7-point 3-D Poisson on an nx**3 grid: 6 on the diagonal, -1 to each grid
neighbour; a frozen copy of
``hifir_tpu_torch.models.problems.poisson3d``."""

from __future__ import annotations

import numpy as np

from hifbench.problems import assemble


def poisson3d(nx: int):
    idx = np.arange(nx ** 3).reshape(nx, nx, nx)
    return assemble(nx ** 3, 6.0,
                    [(idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()),
                     (idx[:, :-1, :].ravel(), idx[:, 1:, :].ravel()),
                     (idx[:-1, :, :].ravel(), idx[1:, :, :].ravel())])


def make(config: dict):
    return poisson3d(int(config["nx"]))
