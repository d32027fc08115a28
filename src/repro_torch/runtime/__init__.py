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
  metrics.py     counters/gauges/histograms, fixed-interval sampler, and
                 opt-in wall-clock jit profiling
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
anything not exported here is an internal detail.
"""
from repro_torch.runtime.actors import CloudServer, CloudSpec, EdgeDevice
from repro_torch.runtime.clock import EventLoop
from repro_torch.runtime.controller import AdaptiveSplitController
from repro_torch.runtime.gateway import (CircuitBreaker, Gateway, GatewayPolicy,
                                   JobQueue, ResponseCache)
from repro_torch.runtime.metrics import (JitProfiler, MetricsRegistry,
                                   MetricsSampler, read_metrics_jsonl)
from repro_torch.runtime.simulator import (Arrival, CellSpec, SimConfig, Simulation,
                                     Topology, WorkloadSpec, build_arrivals,
                                     diurnal_arrivals, flash_arrivals,
                                     pareto_arrivals, parse_topology,
                                     poisson_arrivals, record_arrivals,
                                     run_sim, trace_arrivals)
from repro_torch.runtime.telemetry import RequestTrace, Telemetry
from repro_torch.runtime.tracing import Tracer, validate_chrome_trace
from repro_torch.runtime.transports import DecodeTransport, get_transport
from repro_torch.runtime.wire import Wire

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
