"""Split-serving runtime: an event-driven edge/cloud request simulator
(port of ``repro/runtime``; its virtual-clock telemetry is byte-identical
to the JAX package's, and its numerics run in PyTorch).

The paper's headline numbers come from *deploying* the butterfly split under
request traffic and adapting the partition point to server load (Sec. III-C).
This package provides the missing request-stream layer on top of the repo's
static pieces:

  clock.py       deterministic discrete-event loop (reproducible traces)
  wire.py        contended uplink + downlink, windowed goodput feedback
  telemetry.py   per-request breakdown, p50/p95/p99, per-cell fairness
  tracing.py     flight recorder: virtual-clock spans -> Chrome trace JSON
  metrics.py     counters/gauges/histograms, fixed-interval sampler,
                 opt-in wall-clock jit profiling, and the program's spans
                 (``metrics.SPANS``: the split halves' and the engine's
                 dispatches, each layer's mixer and FFN blocks, attention's
                 core), recorded only while a ``torch.profiler`` session
                 records, on its clock
  split_exec.py  real numerics for the edge/cloud halves + cost model
  transports.py  pluggable decode transports (cache handoff vs streamed rows)
  actors.py      edge-device fleets and the cloud continuous-batching server
  controller.py  per-cell adaptive split + transport control (pluggable
                 objectives: latency / energy / energy_under_slo)
  gateway.py     serving gateway: SLO classes, admission control, circuit
                 breakers, hedged retries, response cache, autoscaling
  simulator.py   multi-cell topologies (CellSpec grammar), workload specs
                 (Poisson/Pareto/diurnal/flash), arrival-trace
                 record/replay, and the runnable simulation

Entry point: ``repro_torch.launch.runtime_sim`` (CLI).

The package surface below is the JAX package's public API, name for name;
anything not exported here is an internal detail.  Each name is imported
at its first use, so the models import ``metrics`` without loading the
simulator.
"""
import importlib

# each exported name -> the module that defines it.  A name is imported at
# its first use (PEP 562), so that importing one module of this package
# (the models import ``metrics`` for their spans) does not load the
# simulator, whose modules import the models.
_HOME = {
    "CloudServer": "actors", "CloudSpec": "actors", "EdgeDevice": "actors",
    "EventLoop": "clock",
    "AdaptiveSplitController": "controller",
    "CircuitBreaker": "gateway", "Gateway": "gateway",
    "GatewayPolicy": "gateway", "JobQueue": "gateway",
    "ResponseCache": "gateway",
    "JitProfiler": "metrics", "MetricsRegistry": "metrics",
    "MetricsSampler": "metrics", "read_metrics_jsonl": "metrics",
    "Arrival": "simulator", "CellSpec": "simulator", "SimConfig": "simulator",
    "Simulation": "simulator", "Topology": "simulator",
    "WorkloadSpec": "simulator", "build_arrivals": "simulator",
    "diurnal_arrivals": "simulator", "flash_arrivals": "simulator",
    "pareto_arrivals": "simulator", "parse_topology": "simulator",
    "poisson_arrivals": "simulator", "record_arrivals": "simulator",
    "run_sim": "simulator", "trace_arrivals": "simulator",
    "RequestTrace": "telemetry", "Telemetry": "telemetry",
    "Tracer": "tracing", "validate_chrome_trace": "tracing",
    "DecodeTransport": "transports", "get_transport": "transports",
    "Wire": "wire",
}


def __getattr__(name: str):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    globals()[name] = value
    return value


__all__ = [
    # simulation driver + config
    "SimConfig", "Simulation", "run_sim",
    # topology + workload
    "Arrival", "CellSpec", "Topology", "parse_topology", "WorkloadSpec",
    "build_arrivals", "poisson_arrivals", "pareto_arrivals",
    "diurnal_arrivals", "flash_arrivals", "record_arrivals",
    "trace_arrivals",
    # actors + gateway
    "CloudServer", "CloudSpec", "EdgeDevice", "Gateway", "GatewayPolicy",
    "JobQueue", "CircuitBreaker", "ResponseCache",
    # control + transport + wire
    "AdaptiveSplitController", "DecodeTransport", "get_transport", "Wire",
    # clock + observability
    "EventLoop", "RequestTrace", "Telemetry", "Tracer",
    "validate_chrome_trace", "MetricsRegistry", "MetricsSampler",
    "JitProfiler", "read_metrics_jsonl",
]
