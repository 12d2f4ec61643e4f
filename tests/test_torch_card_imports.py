"""The card tests run where JAX is absent: no ``tests/test_torch_*_card.py``
file, nor the helper module they share, imports ``jax`` or ``hifir_tpu``
(the card machine has neither, and runs them with ``--noconftest`` because
``conftest.py`` imports JAX)."""

import ast
import glob
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = sorted(glob.glob(os.path.join(HERE, "test_torch_*_card.py"))) + [
    os.path.join(HERE, "card_common.py")]
BANNED = ("jax", "jaxlib", "hifir_tpu")


def imported(path):
    """Every module a file names in an import statement, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_card_files_found():
    assert len(FILES) >= 8


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_card_file_imports_no_jax(path):
    bad = [m for m in imported(path) if m.split(".")[0] in BANNED]
    assert bad == [], f"{os.path.basename(path)} imports {bad}"
