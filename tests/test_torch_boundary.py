"""The port's import boundary and device rules.

Every module of ``src/repro_torch`` and ``chip_smoke.py`` imports neither
``jax`` nor anything of ``repro``; the port imports and runs with JAX
unimportable; an entry point asked for the default device raises when
CUDA is absent (the simulator's numerics, the training entry points and
the serving launchers too, while the simulator's timing-only runs and the
dry run need no device); ``chip_smoke.py`` fails, printing no result,
without a GPU or away from the repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def _run(code: str, cwd=ROOT, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


BLOCKED = """
import sys
sys.modules["jax"] = None          # any import of jax now raises
import torch
torch.cuda.is_available = lambda: False
"""


def test_port_runs_without_jax_and_refuses_a_missing_gpu():
    code = BLOCKED + """
import dataclasses, pkgutil, importlib
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
assert not any(k == "repro" or k.startswith(("repro.", "jax.")) for k in sys.modules)
from repro_torch.configs import get_config
from repro_torch.runtime.split_exec import SplitModelBank
cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=2)
try:
    SplitModelBank(cfg, 16)
except RuntimeError as e:
    assert "CUDA" in str(e), e
else:
    raise SystemExit("SplitModelBank without device='cpu' did not raise")
bank = SplitModelBank(cfg, 16, device="cpu")
r = bank.runner(1)
p, s, c0 = r.edge_half(r.params, [[1, 2, 3, 4]])
logits, _ = r.cloud_half(r.params, p, s)
assert logits.shape == (1, cfg.vocab_size)
print("ok")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_simulation_needs_a_gpu_for_numerics_only():
    """The runtime simulator's numerics default to the card and raise
    without one; a timing-only run touches no device, a model axis
    included (it only divides the cost model's times)."""
    code = BLOCKED + """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.runtime.simulator import SimConfig, Simulation
cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=2)
try:
    Simulation(SimConfig(cfg=cfg, num_requests=2))
except RuntimeError as e:
    assert "CUDA" in str(e), e
else:
    raise SystemExit("Simulation(numerics=True) without a GPU did not raise")
sim = Simulation(SimConfig(cfg=cfg, num_requests=2, numerics=False))
assert sim.bank is None
assert len(sim.run().traces) == 2
print("ok")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    for extra, err in (([], "CUDA"), (["--no-numerics", "--edge-mp", "2"],
                                      None)):
        argv = ["runtime_sim", "--requests", "2"] + extra
        proc = _run(BLOCKED + f"""
import runpy
sys.argv = {argv!r}
runpy.run_module("repro_torch.launch.runtime_sim", run_name="__main__")
""")
        if err is None:
            assert proc.returncode == 0, proc.stderr
            assert "model-parallel edge x2" in proc.stdout, proc.stdout
        else:
            assert proc.returncode != 0 and err in proc.stderr, proc.stderr


def test_training_needs_a_gpu(tmp_path):
    """``init_train_state``, the training launcher and both training
    examples default to the card and raise without one; the launcher's
    ``--lower-only`` traces on meta tensors and needs no device, its
    ``--multi-pod`` (rank 0 of the multi-pod grid in a fake world) too."""
    code = BLOCKED + """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.examples import quickstart, train_resnet_butterfly
from repro_torch.models import model as M
from repro_torch.training import init_train_state
built = M.build(dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=2))
for name, fn in (("init_train_state", lambda: init_train_state(torch.Generator(), built)),
                 ("quickstart", lambda: quickstart.main([])),
                 ("train_resnet_butterfly",
                  lambda: train_resnet_butterfly.main(["--steps", "1"]))):
    try:
        fn()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit(f"{name} without a GPU did not raise")
print("ok")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    for extra, err in (([], "CUDA"), (["--lower-only", "--multi-pod"], None)):
        argv = ["train", "--steps", "1"] + extra
        proc = _run(BLOCKED + f"""
import runpy
sys.argv = {argv!r}
runpy.run_module("repro_torch.launch.train", run_name="__main__")
""")
        if err is None:
            assert proc.returncode == 0, proc.stderr
            assert "2x16x16" in proc.stdout and "OK" in proc.stdout
        else:
            assert proc.returncode != 0 and err in proc.stderr, proc.stderr
    proc = _run(BLOCKED + """
import runpy
sys.argv = ["train", "--lower-only"]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
""", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "build" / "dryrun" / "qwen3-8b_train_4k_1.json").exists()


def test_serving_launchers_need_a_gpu_and_the_dry_run_none(tmp_path):
    """``launch.serve`` (engine mode and ``--split``) and the split_serving
    example default to the card and raise without one; the dry run traces
    on meta tensors and touches no device."""
    for module, argv in (("repro_torch.launch.serve", ["serve"]),
                         ("repro_torch.launch.serve", ["serve", "--split"]),
                         ("repro_torch.examples.split_serving", ["split_serving"])):
        proc = _run(BLOCKED + f"""
import runpy
sys.argv = {argv!r}
runpy.run_module({module!r}, run_name="__main__")
""")
        assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr
    proc = _run(BLOCKED + """
import runpy
sys.argv = ["dryrun", "--arch", "qwen3-8b", "--shape", "decode_32k"]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
""", cwd=tmp_path)
    assert proc.returncode == 0 and proc.stdout.startswith("OK "), proc.stderr
    assert (tmp_path / "build" / "dryrun" / "qwen3-8b_decode_32k_1.json").exists()


@pytest.mark.parametrize("isolated", [False, True],
                         ids=["no-gpu", "alone-in-a-directory"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, isolated):
    if isolated:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    else:
        cwd, script = ROOT, ROOT / "chip_smoke.py"
    code = BLOCKED + f"""
import runpy
runpy.run_path({str(script)!r}, run_name="__main__")
"""
    proc = _run(code, cwd=cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "FAIL" in proc.stderr
