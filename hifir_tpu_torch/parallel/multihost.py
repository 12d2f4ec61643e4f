"""Multi-process initialization.

The port of ``hifir_tpu/parallel/multihost.py``.  :class:`~.prec_sharded.
DistPrec` is single-controller: one process drives the ranks of its own
mesh (:func:`global_mesh`, ranks on this process's devices), as the JAX
package's ``shard_map`` over local devices does.  The cross-process leg is
the restricted additive Schwarz share sum of
:meth:`~.partition.PartitionedHIF.local_contrib`: each process factorizes
and applies the parts it owns and the shares are summed with
``torch.distributed.all_reduce`` (``tests/test_torch_multihost.py``).  The
JAX package's DistPrec over a multi-host global mesh was never run; it is
not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import Mesh, make_mesh

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` is ``tcp://host:port`` (or ``host:port``);
    without it the environment's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` are read.  The backend is gloo, or NCCL
    when every process has its own card (at least ``num_processes``
    visible cards): NCCL refuses two processes on one card."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    own_card = (torch.cuda.is_available() and num_processes is not None
                and torch.cuda.device_count() >= num_processes)
    backend = "nccl" if own_card else "gloo"
    kw = {}
    if coordinator_address is not None:
        addr = coordinator_address
        kw["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend, **kw)


def global_mesh(rhs: int = 1, device="cuda") -> Mesh:
    """The mesh over this process's devices: eight ranks on each visible
    card (``device="cuda"``), or on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    return make_mesh(rhs=rhs, devices=[d for d in devices
                                       for _ in range(8)])
