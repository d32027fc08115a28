"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references import nothing of the program.  Top-level module names are
compared whole: ``repro_torch`` begins with ``repro``."""
import ast
import json
import os
import subprocess
import sys

import pytest

from bench.harness import BANNED, BENCH, ROOT

# one interpreter: the references alone, then every module and a run
SCRIPT = r"""
import json, sys, time
from pathlib import Path
import torch
torch.set_num_threads(1)
from bench import harness
def top():
    return sorted({m.split(".")[0] for m in sys.modules})
for path in sorted((harness.BENCH / "references").glob("*.py")):
    harness.load(path)
refs = top()
for path in sorted(harness.BENCH.rglob("*.py")):
    if "tests" not in path.parts and path.parent != harness.BENCH:
        harness.load(path)
import bench.check, bench.control, bench.flops, bench.generator, bench.peaks
import bench.run, bench.trace
from bench.tests import tiny
harness.run_cell(tiny.cell("prefill-long"), 3, 0.05, False, "cpu",
                 time.perf_counter())
print(json.dumps([refs, top()]))
"""


@pytest.fixture(scope="module")
def loaded():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    refs, run = json.loads(out.stdout.strip().splitlines()[-1])
    return set(refs), set(run)


def test_a_run_loads_no_jax_and_no_jax_package(loaded):
    _, run = loaded
    assert "repro_torch" in run
    assert not run & BANNED


def test_references_import_nothing_of_the_program(loaded):
    refs, _ = loaded
    assert not refs & (BANNED | {"repro_torch"})
    for path in (BENCH / "references").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED | {"repro_torch"}, \
                    f"{path.name} imports {name}"
