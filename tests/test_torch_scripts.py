"""The port's card scripts, chip_smoke.py and profile_banded.py, off the
card: they import neither jax nor the JAX package themselves, and they
exit non-zero with no result line when no CUDA card is visible. The
profiler's device busy time is the union of the device events' intervals."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCRIPTS = ["chip_smoke.py", "profile_banded.py"]


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_imports_no_jax(script):
    tops = {n.split(".")[0] for n in _imported(os.path.join(ROOT, script))}
    assert "prisim_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "prisim_tpu"}, tops


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_fails_without_cuda(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA card" in proc.stderr


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (3.0, 4.0)], 3.0),            # disjoint
    ([(0.0, 2.0), (1.0, 4.0), (3.5, 5.0)], 5.0),  # chained overlaps
    ([(5.0, 6.0), (0.0, 10.0), (2.0, 3.0)], 10.0),  # nested, unsorted
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),            # touching
])
def test_busy_us_is_union_length(spans, want):
    sys.path.insert(0, ROOT)
    try:
        from profile_banded import busy_us
    finally:
        sys.path.remove(ROOT)
    assert busy_us(spans) == want
