"""Nothing the benchmark runs imports jax or the JAX package, compared by
the whole top-level name (the port's name begins with the JAX package's),
and the reference imports nothing of the program; the harness refuses to
run without a card."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "hifir_tpu"}
REFERENCE = ["hifbench.reference", "hifbench.compare", "hifbench.hostprec",
             "hifbench.problems", "hifbench.window", "hifbench.peaks",
             "hifbench.work.msolve", "hifbench.work.k2",
             "hifbench.work.gmres"] + [
    f"hifbench.problems.{p.stem}" for p in (HERE / "problems").glob("*.py")
    if p.stem != "__init__"]


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")
                                        if "tests" not in p.parts))
def test_no_source_imports_jax(path):
    assert not imported_tops(HERE / path) & FORBIDDEN


def python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_loaded_modules_of_a_run():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import hifbench.run, hifbench.control
from hifbench import spec
bench = spec.load_benchmark()
for w in bench["workloads"]:
    cell = spec.resolve(bench, w["name"])
    spec.load_module(cell.driver)
    for m in cell.per_layer:
        spec.load_module(spec.metric_file(m["name"]))
import hifir_tpu_torch, hifir_tpu_torch.graphs
tops = {{m.split('.')[0] for m in sys.modules}}
print(sorted(tops & set({sorted(FORBIDDEN)!r})))
print('hifir_tpu_torch' in sys.modules)
"""
    p = python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ["[]", "True"]


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            + "; ".join(f"import {m}" for m in REFERENCE)
            + "; print(sorted({m.split('.')[0] for m in sys.modules} & "
            + f"set({sorted(FORBIDDEN | {'hifir_tpu_torch', 'torch'})!r})))")
    p = python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness would run")
    p = subprocess.run([sys.executable, "hifbench/run.py", "--workload",
                        "p2d1m.apply64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "card" in p.stderr


def test_a_short_run_on_the_card():
    """On a machine with a card: one short run of the first cell is
    correct and reports every end-to-end metric."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "hifbench/run.py", "--workload",
                        "p3d64.apply128", "--seed", "12345", "--seconds",
                        "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
