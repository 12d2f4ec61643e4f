"""The port's device demos (``hifir_tpu_torch/examples``), each ``main``
run in-process with ``--device cpu`` at a small size, as one parametrised
test.  Each case asserts on the lines the demo prints and on the results
it returns: GMRES flags 0 and residuals within their tolerance, the
pseudoinverse within the bounds the demo module states, the distributed
solve within 1e-12 of the host's.  Nothing here needs the reference's
input files.
"""

import numpy as np
import pytest


def _batch(capsys):
    from hifir_tpu_torch.examples import demo_device_batch as d

    r = d.main(["--device", "cpu", "--nx", "32", "--nrhs", "8"])
    out = capsys.readouterr().out
    assert "batched M-solve:" in out and "for 8 RHS" in out
    assert f"device FGMRES: flag=0 iters={r['iters']}" in out
    assert r["flag"] == 0 and r["res"] <= 1e-8
    X = r["X"].double().numpy()
    Xh = r["M"].solve_mrhs(r["B"].double().numpy())
    assert np.abs(X - Xh).max() <= 1e-4 * np.abs(Xh).max()


def _pinv(capsys):
    from hifir_tpu_torch.examples import demo_pseudoinverse_device as d

    r = d.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"tail rank {r['rank']} of {r['tail_n']}" in out
    assert r["rank"] < r["tail_n"]          # the null space was found
    assert "device IR (f32 M, f64 residuals)" in out
    assert r["rel_res"] <= d.RES_BOUND and r["pinv_err"] <= d.PINV_BOUND
    assert abs(r["x"].mean()) <= 1e-12 * np.abs(r["x"]).max()
    assert len(r["ranks"]) == 2 and all(np.isfinite(list(r["ranks"].values())))
    # the f32 filtered apply itself, against the host's filtered solve
    r["M"].nsp = r["dp"].nsp
    xh = r["M"].solve(r["b"])
    xd = r["dp"].solve(r["b"]).double().numpy()
    assert np.abs(xd - xh).max() <= 1e-4 * np.abs(xh).max()


def _partitioned(capsys):
    from hifir_tpu_torch.examples import demo_partitioned as d

    rows = d.main(["--device", "cpu", "--nx", "32"])
    out = capsys.readouterr().out
    assert [r["nparts"] for r in rows] == [1, 4, 8]
    for r in rows:
        assert f"nparts={r['nparts']:2d}" in out
        assert r["flag"] == 0 and r["rel_res"] <= 1e-6


def _distprec(capsys):
    from hifir_tpu_torch.examples import distprec_scale as d

    r = d.main(["32", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "distributed vs host max rel diff" in out
    assert r["err"] < 1e-12 and r["n_halo"] > 0
    assert r["comm_elems"] < r["allgather_elems"]
    assert r["bytes_per_rank"]["sharded"] > 0


def _study(capsys):
    from hifir_tpu_torch.examples import partition_study as d

    r = d.main(["32", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"global: iters={r['global_iters']}" in out
    assert r["global_flag"] == 0 and len(r["rows"]) == 8
    for row in r["rows"]:
        assert row["flag"] == 0 and row["rel_res"] <= 1e-6
        assert row["iters"] >= r["global_iters"]


DEMOS = {"demo_device_batch": _batch, "demo_pseudoinverse_device": _pinv,
         "demo_partitioned": _partitioned, "distprec_scale": _distprec,
         "partition_study": _study}


@pytest.mark.parametrize("demo", list(DEMOS))
def test_demo_runs_on_cpu(demo, capsys):
    DEMOS[demo](capsys)


# the smallest arguments of each demo, without --device
SMALL = {"demo_device_batch": ["--nx", "8"], "demo_pseudoinverse_device": [],
         "demo_partitioned": ["--nx", "8"], "distprec_scale": ["8", "8"],
         "partition_study": ["8", "1"]}


@pytest.mark.parametrize("demo", list(SMALL))
def test_demo_defaults_to_cuda(demo):
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    mod = importlib.import_module(f"hifir_tpu_torch.examples.{demo}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(SMALL[demo])
