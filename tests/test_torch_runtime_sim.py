"""The port's split-serving runtime simulator against the JAX package's.

Timing only (``--no-numerics``): ``repro_torch.launch.runtime_sim`` and
``repro.launch.runtime_sim`` print the same stdout (but for the module
name in the trace validator's command) and write byte-identical
``--json`` telemetry on the verify skill's runtime scenarios (the default
3g fleet, the entropy wire on each transport, adaptation under a load
ramp, a two-cell topology, a seeded fault schedule, a gateway, a Pareto
workload); the Chrome trace and metrics timeline are identical too, and
the port's record -> replay is byte-identical.

With numerics: the CLI's default model (reduced qwen3-8b, 4 layers, f32),
the JAX bank's backbone and per-split butterflies carried into the port's
bank through ``repro_torch.bridge``, the int8 and entropy wires on
``cache_handoff``, ``streamed`` and ``progressive``: the telemetry JSON is
byte-identical (bank cache counters included) and every request generates
the same ids; each entropy request's coded bytes are what the encoder
gives the bank's own edge codes.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.launch import runtime_sim as jcli
from repro.runtime.simulator import SimConfig as JSimConfig
from repro.runtime.simulator import Simulation as JSimulation
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import wire_codec
from repro_torch.launch import runtime_sim as tcli
from repro_torch.runtime.actors import EdgeDevice
from repro_torch.runtime.simulator import SimConfig as TSimConfig
from repro_torch.runtime.simulator import Simulation as TSimulation

TIMING = {
    "default": ["--network", "3g", "--devices", "4", "--requests", "16"],
    "entropy-handoff": ["--wire-mode", "entropy",
                        "--transport", "cache_handoff"],
    "entropy-streamed": ["--wire-mode", "entropy", "--transport", "streamed",
                         "--seq", "128", "--max-new-tokens", "16"],
    "entropy-progressive": ["--wire-mode", "entropy",
                            "--transport", "progressive"],
    "adapt-ramp": ["--adapt", "--load-ramp", "0:0,0.3:0.97", "--requests",
                   "48", "--rate", "40", "--max-new-tokens", "1",
                   "--cloud-x", "10"],
    "two-cells": ["--topology", "3g:4xjetson,wifi:4xphone", "--adapt",
                  "--transport", "auto", "--load-ramp", "0:0.95"],
    "faults": ["--faults", "random:7"],
    "gateway": ["--gateway", "priority,shed,slo=40/400,reserve=1,cache=64",
                "--workload", "flash:rate=10,n=64,interactive=0.5"],
    "pareto": ["--workload",
               "pareto:alpha=1.5,rate=20,n=64,interactive=0.25"],
}


def _cli(main, argv):
    """Run a runtime_sim ``main`` in this process; returns its stdout."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["runtime_sim"] + argv
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = saved
    return out.getvalue()


@pytest.mark.parametrize("name", list(TIMING))
def test_timing_only_cli_is_byte_identical(tmp_path, name):
    files = {flag: tmp_path / f"out{flag}" for flag in
             ("--json", "--trace-out", "--metrics-out")}
    argv = TIMING[name] + ["--no-numerics"]
    for flag, path in files.items():
        argv += [flag, str(path)]
    got = {}
    for pkg, main in (("jax", jcli.main), ("torch", tcli.main)):
        # the one line that names a module: the trace validator's
        stdout = _cli(main, argv).replace("python -m repro_torch.",
                                          "python -m repro.")
        got[pkg] = [stdout] + [p.read_bytes() for p in files.values()]
    assert got["torch"] == got["jax"]
    assert b'"n_requests"' in got["torch"][1]


def test_record_replay_is_byte_identical(tmp_path):
    trace, a, b = (tmp_path / n for n in ("t.jsonl", "a.json", "b.json"))
    common = ["--topology", "3g:2xjetson,wifi:2xphone", "--faults",
              "random:3", "--no-numerics"]
    _cli(tcli.main, common + ["--record-trace", str(trace), "--json", str(a)])
    _cli(tcli.main, common + ["--replay-trace", str(trace), "--json", str(b)])
    assert a.read_bytes() == b.read_bytes()
    _cli(jcli.main, common + ["--replay-trace", str(trace), "--json", str(b)])
    assert a.read_bytes() == b.read_bytes()


def test_cli_refuses_the_model_axis(tmp_path):
    """The CLI once refused ``--cloud-mp`` above 1.  Timing only, a model
    axis now only divides the cost model's stage times, and the port's
    stdout and telemetry equal the JAX package's, byte for byte, with no
    process started."""
    got = {}
    for pkg, main in (("jax", jcli.main), ("torch", tcli.main)):
        path = tmp_path / f"{pkg}.json"
        got[pkg] = (_cli(main, ["--no-numerics", "--cloud-mp", "4",
                                "--json", str(path)]).replace(str(path), ""),
                    path.read_bytes())
    assert got["torch"] == got["jax"]
    assert "cloud x4" in got["torch"][0]


# --------------------------------------------------------------- numerics
NUMERICS = dict(num_requests=4, seed=0)


def _cfgs():
    """The CLI's default model: reduced qwen3-8b at 4 layers."""
    return (dataclasses.replace(jget_config("qwen3-8b").reduced(), num_layers=4),
            dataclasses.replace(tget_config("qwen3-8b").reduced(), num_layers=4))


def _bridge(jsim, tsim):
    """The JAX bank's weights into the port's, before either runs."""
    to_np = lambda t: jax.tree.map(np.asarray, t)
    jb, tb = jsim.bank, tsim.bank
    tb.params = bridge.to_torch(to_np(jb.params), device="cpu")
    for split in tb.candidates:
        tb._butterfly[split] = bridge.to_torch(
            to_np(jb.butterfly_params(split)), device="cpu")


@pytest.mark.parametrize("transport", ["cache_handoff", "streamed",
                                       "progressive"])
@pytest.mark.parametrize("wire", ["int8", "entropy"])
def test_numerics_telemetry_and_ids_match_jax(wire, transport, monkeypatch):
    jcfg, tcfg = _cfgs()
    jsim = JSimulation(JSimConfig(cfg=jcfg, wire_mode=wire,
                                  transport=transport, **NUMERICS))
    tsim = TSimulation(TSimConfig(cfg=tcfg, wire_mode=wire,
                                  transport=transport, device="cpu",
                                  **NUMERICS))
    _bridge(jsim, tsim)
    # keep the port's edge codes, from which the entropy wire's coded bytes
    # are recomputed below
    codes = {}
    edge_batch = EdgeDevice._compute_edge_batch

    def keep_codes(device, req):
        edge_batch(device, req)
        for r in tsim.requests:
            if r.payload is not None and r.uid not in codes:
                codes[r.uid] = r.payload[0][0].numpy().copy()

    monkeypatch.setattr(EdgeDevice, "_compute_edge_batch", keep_codes)
    jtel, ttel = jsim.run(), tsim.run()
    assert ttel.to_json() == jtel.to_json()
    jids = [list(map(int, r.engine_req.generated)) for r in jsim.requests]
    tids = [list(map(int, r.engine_req.generated)) for r in tsim.requests]
    assert tids == jids and all(len(g) == 4 for g in tids)
    c = ttel.counters
    assert c["bank_jit_cache_misses"] > 0 and c["engine_decode_steps"] > 0
    if wire == "entropy":
        prior = wire_codec.WirePrior.default(tsim.bank.d_r, 8)
        for t in ttel.traces:
            S, d_r = t.prompt_len, tsim.bank.d_r
            want = min(len(wire_codec.encode(codes[t.uid], prior)) + 4 * S,
                       S * d_r + 4 * S)
            assert t.coded_bytes == want
