"""Two processes on the CPU: the port's multi-process leg.

The test starts this file twice as a worker (``python
tests/test_torch_multihost.py <rank> <world> <port>``).  Each worker joins
a gloo process group (``hifir_tpu_torch.parallel.multihost``), factorizes
the parts it owns of a four-part ``PartitionedHIF`` (``k % world ==
rank``), applies them on the host and through a DistPrec a part on its own
eight CPU ranks (equal within 1e-12), and the RAS shares are summed with
``torch.distributed.all_reduce``.  Rank 0 checks the sum against the
single-process apply (1e-12 of max|x|) and every worker prints
MULTIHOST_OK.  Each worker has its own timeout.
"""

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_ras_share_sum():
    import pytest

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    workers = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for w in workers:
            outs.append(w.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for w in workers:
            w.kill()
            w.communicate()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for r, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"rank {r} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"rank {r} output:\n{out}"
    assert "sum err=" in outs[0], outs[0]


def _worker(pid: int, nproc: int, port: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.parallel import (PartitionedHIF, initialize_multihost,
                                          make_mesh)

    initialize_multihost(f"tcp://localhost:{port}", nproc, pid)
    assert dist.get_world_size() == nproc and dist.get_rank() == pid
    assert dist.get_backend() == "gloo"
    A = poisson2d(48)
    opts = ht.Options(verbose=0, tau_L=1e-2, tau_U=1e-2, alpha_L=3,
                      alpha_U=3, kappa=5, kappa_d=5, dense_thres=500)
    P = PartitionedHIF().factorize(A, 4, opts, process_rank=pid,
                                   process_count=nproc)
    owned = [k for k, p in enumerate(P.parts) if p.M is not None]
    assert owned == [k for k in range(4) if k % nproc == pid], owned
    b = np.random.default_rng(7).standard_normal(A.nrows)
    share_host = P.local_contrib(b)
    # each owned part's M-solve distributed over this process's ranks
    P.attach_dist_solvers(make_mesh(8, device="cpu"), chunk=64)
    share = P.local_contrib(b)
    err = float(np.abs(share - share_host).max()
                / max(np.abs(share_host).max(), 1e-300))
    assert err < 1e-12, err
    print(f"rank {pid}: DistPrec share err vs host {err:.2e}", flush=True)
    total = torch.tensor(share)
    dist.all_reduce(total)
    if pid == 0:
        ref = PartitionedHIF().factorize(A, 4, opts).solve(b)
        serr = float(np.abs(total.numpy() - ref).max() / np.abs(ref).max())
        assert serr < 1e-12, serr
        print(f"rank 0: all_reduce sum err={serr:.2e}", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    print("MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(*map(int, sys.argv[1:4]))
