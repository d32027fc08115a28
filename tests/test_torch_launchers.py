"""The port's launchers and root examples against the JAX package's, and its
one-card dry run, on the CPU.

  * ``repro_torch.launch.serve`` in engine mode prints exactly what
    ``repro.launch.serve`` prints on one JAX-saved ``--checkpoint``;
  * its ``--split`` prints exactly what the JAX launcher's ``--split`` path
    prints on that checkpoint, run in a subprocess with two host devices
    on a ``jax.sharding.Mesh``-built mesh (``jax.make_mesh``, which the JAX
    launcher calls, gives Explicit axes under jax 0.9, on which JAX's
    ``make_split_pipeline`` cannot slice its result);
  * ``examples/load_adaptation.py`` and its port print the same bytes;
  * the ``split_serving`` example runs on the CPU within the JAX example
    test's bound (max |err| < 5e-3) with int8 crossings;
  * ``train --lower-only`` runs the dry run and writes its record;
  * the dry run's counts: on meta equal to those on real CPU tensors for
    every assigned family and step kind; the skipped pairs those that
    ``supports_shape`` refuses, in both packages; the prefill FLOPs of a
    reduced dense qwen3 without a butterfly equal to a closed form.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
PROMPTS = ["the quick brown fox", "once upon a time", "edge and cloud"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX checkpoints of the serve launcher's model, without and with its
    ``--split`` butterfly, from a seed other than the launchers' own."""
    import jax
    from repro.configs import get_config
    from repro.data import tokenizer as tok
    from repro.models import model as M
    from repro.training.checkpoint import save_checkpoint
    d = tmp_path_factory.mktemp("ckpt")
    cfg = get_config("qwen3-8b").reduced()
    cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, tok.VOCAB_SIZE))
    out = {}
    for name, c in (("engine", cfg), ("split", cfg.with_butterfly(1, 32))):
        params, _ = M.init_model(jax.random.key(7), M.build(c))
        out[name] = save_checkpoint(str(d / name), params, step=3,
                                    metadata={"arch": c.name})
    return out


def test_serve_engine_prints_what_jax_prints(checkpoints, capsys, monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    args = ["--checkpoint", checkpoints["engine"], "--max-new-tokens", "6",
            "--prompts", *PROMPTS]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    jserve.main()
    want = capsys.readouterr().out
    tserve.main(["--device", "cpu", *args])
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 1 + len(PROMPTS)


SPLIT_SERVE_CODE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.data import tokenizer as tok
from repro.models import model as M
from repro.serving.pipeline import make_split_pipeline, wire_stats
from repro.training.checkpoint import restore_checkpoint

# repro.launch.serve's --split path, on a Mesh-built (pod, data) mesh
ckpt, prompts = sys.argv[1], sys.argv[2:]
cfg = get_config("qwen3-8b").reduced()
cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, tok.VOCAB_SIZE))
cfg = cfg.with_butterfly(1, 32)
built = M.build(cfg)
params, _ = M.init_model(jax.random.key(0), built)
params, _, meta = restore_checkpoint(ckpt, params)
print("restored", meta)
mesh = Mesh(np.array(jax.devices()).reshape(2, 1), ("pod", "data"))
S = 32
toks = np.stack([np.resize(tok.encode(p), S) for p in prompts])
pipe = jax.jit(make_split_pipeline(built, mesh, len(prompts), S, 1))
logits = pipe(params, jnp.asarray(toks))
stats = wire_stats(cfg, 1, S)
print(f"split pipeline over pod axis: wire={stats['wire_bytes']}B/mb "
      f"raw={stats['raw_boundary_bytes']}B compression={stats['compression']:.1f}x")
for p, l in zip(prompts, logits):
    print(f"  {p!r} -> next-token id {int(jnp.argmax(l))}")
"""


@pytest.mark.subprocess
def test_serve_split_prints_what_jax_prints(checkpoints, capsys):
    from repro_torch.launch import serve as tserve
    res = subprocess.run([sys.executable, "-c", SPLIT_SERVE_CODE,
                          checkpoints["split"], *PROMPTS], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    tserve.main(["--device", "cpu", "--split", "--checkpoint",
                 checkpoints["split"], "--prompts", *PROMPTS])
    got = capsys.readouterr().out
    assert got == res.stdout
    assert sum("next-token id" in line for line in got.splitlines()) == len(PROMPTS)


def test_load_adaptation_prints_the_jax_scripts_bytes():
    run = lambda *cmd: subprocess.run([sys.executable, *cmd], env=_env(),
                                      cwd=ROOT, capture_output=True,
                                      timeout=300)
    want = run(os.path.join("examples", "load_adaptation.py"))
    got = run("-m", "repro_torch.examples.load_adaptation")
    assert want.returncode == 0 and got.returncode == 0, got.stderr[-3000:]
    assert got.stdout == want.stdout and len(got.stdout.splitlines()) > 30


def test_split_serving_example_on_the_cpu(capsys):
    from repro_torch.examples import split_serving
    split_serving.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    err = float(next(l for l in lines if "max |err|" in l).split()[-1])
    n_int8 = int(next(l for l in lines if "int8 crossings" in l).split()[-1])
    assert err < 5e-3
    assert n_int8 == 4                       # one wire a microbatch


def test_train_lower_only_writes_the_dry_run(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train
    monkeypatch.chdir(tmp_path)
    train.main(["--lower-only", "--arch", "qwen3-8b"])
    rec = json.loads((tmp_path / "build" / "dryrun" /
                      "qwen3-8b_train_4k_1.json").read_text())
    assert (rec["mesh"], rec["chips"], rec["device"]) == ("1", 1, "meta")
    assert rec["collective_s"] == 0 and rec["flops_per_device"] > 0
    assert 0 < rec["useful_ratio"] <= 1
    assert rec["memory_analysis"]["peak_memory_in_bytes"] >= \
        rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert capsys.readouterr().out.startswith("OK ")


KINDS = ["train", "prefill", "decode"]


@pytest.fixture
def one_thread():
    """The dry run's counts at the reduced size are many tiny ops: one
    thread keeps them from contending with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["qwen3-14b", "llama4-maverick-400b-a17b",
                                  "qwen3-moe-235b-a22b", "pixtral-12b",
                                  "whisper-base", "gemma-7b", "gemma3-12b",
                                  "qwen3-8b", "xlstm-125m", "zamba2-7b"])
def test_dry_run_counts_on_meta_equal_real_tensors(arch, kind, one_thread):
    """Reduced ``arch`` with a butterfly after layer 1, 2 x 32 tokens: the
    FLOPs, bytes and argument, output and peak live bytes counted on meta
    equal those counted on real CPU tensors."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    cfg = get_config(arch).reduced()
    if arch == "qwen3-moe-235b-a22b":
        cfg = dataclasses.replace(cfg, num_layers=3)
    built = M.build(cfg.with_butterfly(1, 16))
    shape = InputShape("t", 32, 2, kind)
    runs = []
    for device in ("meta", "cpu"):
        counter, memory = dryrun.count_step(built, shape, device)
        runs.append((counter.flops, counter.bytes, memory))
    assert runs[0] == runs[1]
    assert runs[0][0] > 0 and runs[0][2]["fits_device"]


def test_dry_run_skips_what_supports_shape_refuses(tmp_path, monkeypatch):
    from repro.configs import get_config as jget, supports_shape as jsupports
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.configs.all import ASSIGNED
    from repro_torch.launch import dryrun
    traced = []

    def count_step(built, shape, device="meta"):
        traced.append((built.cfg.name, shape.name))
        raise RuntimeError("not traced here")
    monkeypatch.setattr(dryrun, "count_step", count_step)
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 1
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    skipped = {(r["arch"], r["shape"]) for r in recs if "skipped" in r}
    want = {(a, s) for a in ASSIGNED for s, shape in INPUT_SHAPES.items()
            if not jsupports(jget(a), shape)[0]}
    assert skipped == want and len(want) > 0
    assert len(traced) == len(ASSIGNED) * len(INPUT_SHAPES) - len(want)


def test_dry_run_traces_the_production_grids(tmp_path, monkeypatch):
    """``--multi-pod`` traces rank 0 of the 2x16x16 grid and
    ``--both-meshes`` the 16x16 grid too (full-width gemma3-12b at
    long_500k: a batch of one, its caches' length over ``("data",
    "model")``, rings of the window's rows); ``launch/train.py
    --lower-only --multi-pod`` writes the train_4k record of the 2x16x16
    grid."""
    from repro_torch.launch import dryrun, train
    out = str(tmp_path)
    assert dryrun.main(["--arch", "gemma3-12b", "--shape", "long_500k",
                        "--multi-pod", "--out", out]) == 0
    assert dryrun.main(["--arch", "gemma3-12b", "--shape", "long_500k",
                        "--both-meshes", "--out", out]) == 0
    for mesh, chips in (("2-16-16", 512), ("16-16", 256)):
        rec = json.loads((tmp_path / f"gemma3-12b_long_500k_{mesh}.json").read_text())
        assert rec["chips"] == chips and rec["collectives"]["all-reduce"] > 0
    monkeypatch.setattr(dryrun, "OUT_DIR", out)
    train.main(["--lower-only", "--multi-pod"])
    rec = json.loads((tmp_path / "qwen3-8b_train_4k_2-16-16.json").read_text())
    assert rec["mesh"] == "2x16x16" and rec["collectives"]["all-reduce"] > 0


def test_dry_run_prefill_flops_equal_the_closed_form():
    """Reduced dense qwen3 without a butterfly, B x S = 2 x 32: every layer
    multiplies each token by its matmul weights (2 FLOPs a weight) and
    takes q k^T and p v over all S x S pairs (4 B S^2 H hd), and the head
    maps the last position of each row (2 B d V)."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    cfg = get_config("qwen3-8b").reduced()
    B, S = 2, 32
    d, H, K, hd, ff, V, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.d_ff, cfg.vocab_size,
                             cfg.num_layers)
    layer_weights = d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * ff
    want = L * (2 * B * S * layer_weights + 4 * B * S * S * H * hd) + 2 * B * d * V
    counter, _ = dryrun.count_step(M.build(cfg), InputShape("t", S, B, "prefill"))
    assert counter.flops == want
