"""The split-serving simulation: a topology of cells + one shared cloud.

A :class:`Topology` is a tuple of :class:`CellSpec`s.  Each cell owns its
own radio (:class:`~repro_torch.runtime.wire.Wire` — link model + duplex), its
own fleet of one edge-device class (per-class
:class:`~repro_torch.core.profiler.HardwareProfile`, per-cell ``edge_mp`` and
arrival rate), and — when adaptation is on — its own
:class:`~repro_torch.runtime.controller.AdaptiveSplitController` routing that
cell's new arrivals to a per-cell ``(split, transport)`` pair.  Every cell
contends for ONE :class:`~repro_torch.runtime.actors.CloudServer`: cross-cell
congestion (the fleet's combined slot occupancy plus background tenants) is
the shared signal the per-cell controllers react to, while uplink goodput
feedback stays per cell.  The classic single-uplink configuration
(``SimConfig(network=..., num_devices=...)``) is exactly a 1-cell topology
— the same code path, not a parallel one.

All timing is virtual (deterministic for a fixed seed); numerics are real
PyTorch on ``SimConfig.device`` (the Hopper kernels on the card) when
``numerics=True`` and skipped entirely in timing-only mode (used by the
fast benchmark sweeps and scheduler tests), which builds no bank and
touches no device.

Serving modes:
  "split"  the paper: edge layers + butterfly reduce/quantize, compressed wire
  "cloud"  cloud-only offload: raw input features cross the wire
  "edge"   mobile-only: everything on the device, nothing crosses

Decode transports (split mode, multi-token requests — runtime/transports.py):
  "cache_handoff"  ship the edge stage-0 KV cache up; decode cloud-side
  "streamed"       edge keeps its cache; one (1, d_r) row up + one id down
                   per generated token
  "auto"           each cell's adaptive controller picks per request,
                   alongside the split (requires adapt=True)

Trace replay: any run's arrival stream (cell, device, t, prompt tokens) can
be recorded to JSONL (:meth:`Simulation.record_trace`) and rebuilt with
:func:`trace_arrivals`, making topology runs byte-for-byte reproducible and
letting real arrival logs drive the simulator.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.profiler import (GTX_1080TI, JETSON_TX2, HardwareProfile,
                                 get_device_class)
from repro_torch.runtime.actors import (CloudServer, CloudSpec, EdgeDevice,
                                  SimRequest)
from repro_torch.runtime.clock import EventLoop
from repro_torch.runtime.faults import FaultInjector, FaultSchedule, RecoveryPolicy
from repro_torch.runtime.gateway import Gateway, GatewayPolicy
from repro_torch.runtime.metrics import JitProfiler, MetricsRegistry, MetricsSampler
from repro_torch.runtime.split_exec import CostModel, SplitModelBank
from repro_torch.runtime.telemetry import RequestTrace, Telemetry
from repro_torch.runtime.tracing import NULL_TRACER, Tracer
from repro_torch.runtime.wire import Wire


def ramp_load(t0: float, t1: float, l0: float = 0.0,
              l1: float = 0.95) -> Callable[[float], float]:
    """Background cloud load ramping linearly from l0@t0 to l1@t1."""
    def f(t: float) -> float:
        if t <= t0:
            return l0
        if t >= t1:
            return l1
        return l0 + (l1 - l0) * (t - t0) / (t1 - t0)
    return f


# ---------------------------------------------------------------------------
# topology: cells of heterogeneous fleets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CellSpec:
    """One cell of a topology: a radio + a fleet of one device class.

    ``device`` is a device-class name from
    :data:`repro_torch.core.profiler.DEVICE_CLASSES` ("phone", "jetson", ...) or
    a :class:`HardwareProfile` directly.  ``None`` fields inherit the
    :class:`SimConfig` fleet-wide value.  ``wire`` names a wire group:
    cells sharing the same group name share ONE physical Wire (e.g. two
    fleets forced through a single congested uplink); by default each cell
    gets its own."""
    name: str
    network: str = "3g"
    num_devices: int = 4
    device: Union[str, HardwareProfile] = "jetson"
    duplex: Optional[str] = None             # None -> SimConfig.duplex
    edge_mp: int = 1
    arrival_rate: Optional[float] = None     # None -> SimConfig.arrival_rate
    num_requests: Optional[int] = None       # None -> even share of the total
    initial_split: Optional[int] = None      # None -> SimConfig.initial_split
    transport: Optional[str] = None          # None -> SimConfig.transport
    wire: Optional[str] = None               # wire-group key (shared uplink)

    def hardware(self) -> HardwareProfile:
        return get_device_class(self.device)


Topology = Tuple[CellSpec, ...]


def parse_topology(spec: str) -> Topology:
    """Inline topology grammar: comma-separated cells, each
    ``network[/duplex]:<N>x<class>[@rate]`` — e.g.
    ``"3g:4xphone,wifi:2xjetson"`` or ``"4g/shared:8xphone@30"``.  Cell
    names are ``<network><index>``."""
    cells: List[CellSpec] = []
    for i, part in enumerate(s.strip() for s in spec.split(",")):
        try:
            net, fleet = part.split(":")
            duplex = None
            if "/" in net:
                net, duplex = net.split("/")
            rate = None
            if "@" in fleet:
                fleet, rate_s = fleet.split("@")
                rate = float(rate_s)
            n, klass = fleet.split("x", 1)
            cells.append(CellSpec(
                name=f"{net}{i}", network=net, num_devices=int(n),
                device=klass, duplex=duplex, arrival_rate=rate))
        except ValueError:
            raise ValueError(
                f"bad cell spec {part!r}: expected "
                f"'network[/duplex]:<N>x<class>[@rate]' "
                f"(e.g. '3g:4xphone,wifi:2xjetson')") from None
        get_device_class(cells[-1].device)   # fail fast on unknown classes
    return tuple(cells)


class Cell:
    """Runtime state of one topology cell: its Wire, its cost model (edge
    device class x cloud), its device slice, and the (split, transport)
    pair its controller currently routes new arrivals to."""

    def __init__(self, spec: CellSpec, index: int, wire: Wire,
                 cost: CostModel, split: int, transport: str):
        self.spec = spec
        self.name = spec.name
        self.index = index
        self.wire = wire
        self.cost = cost
        self.dev_base = 0                    # set by the simulator
        self.current_split = split
        self.current_transport = transport
        self.controller: Optional[object] = None

    def set_split(self, split: int) -> None:
        self.current_split = split

    def set_transport(self, transport: str) -> None:
        self.current_transport = transport


# ---------------------------------------------------------------------------
# arrival traces: Poisson builder + JSONL record/replay
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Arrival:
    """One request of a pre-built arrival trace.  ``device`` is the global
    device index across the whole topology; ``cell`` the owning cell's
    index."""
    device: int
    t: float
    tokens: Optional[np.ndarray] = None      # prompt ids (numerics mode)
    cell: int = 0
    slo: str = "interactive"                 # SLO class (gateway.SLO_CLASSES)


def poisson_arrivals(*, num_devices: int, num_requests: int,
                     arrival_rate: float, prompt_len: int,
                     vocab_size: Optional[int] = None,
                     seed: int = 0, device_offset: int = 0,
                     cell: int = 0) -> List[Arrival]:
    """THE arrival-trace builder (shared by the simulator, the CLI and
    ``benchmarks.run runtime``): deterministic per-device Poisson
    inter-arrivals, plus prompt tokens when ``vocab_size`` is given.
    Building the trace once and passing it through ``SimConfig.arrivals``
    guarantees mode/wire/transport comparisons run the identical trace.
    ``device_offset`` shifts both the device ids and their rng streams, so
    each cell of a topology gets independent arrivals."""
    assert arrival_rate > 0, f"arrival_rate must be positive, got " \
        f"{arrival_rate} (quiesce a cell with num_requests=0 instead)"
    out: List[Arrival] = []
    per_dev = [num_requests // num_devices] * num_devices
    for i in range(num_requests % num_devices):
        per_dev[i] += 1
    for dev, n in enumerate(per_dev):
        rng = np.random.default_rng([seed, device_offset + dev])
        t = 0.0
        for _ in range(n):
            t += rng.exponential(1.0 / arrival_rate)
            tokens = None
            if vocab_size:
                tokens = rng.integers(0, vocab_size, size=(prompt_len,),
                                      dtype=np.int64).astype(np.int32)
            out.append(Arrival(device_offset + dev, t, tokens, cell))
    return out


# ---------------------------------------------------------------------------
# workload specs: the arrival-trace API
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkloadSpec:
    """What traffic hits the fleet — THE arrival API (DESIGN.md section
    17).  ``SimConfig(workload=...)`` takes a spec or its string grammar
    and overrides the legacy ``num_requests``/``arrival_rate``/
    ``prompt_len`` fields, which keep working as a deprecation shim that
    maps onto ``WorkloadSpec(kind="poisson")`` — old-style configs build
    the identical arrival list.  Grammar: ``"<kind>:key=value,..."``, e.g.

      "poisson:rate=20,n=16"
      "pareto:alpha=1.5,rate=20,n=100000,interactive=0.25"
      "diurnal:rate=20,n=500,period=2.0,depth=0.8"
      "flash:rate=10,n=1000,at=0.2,dur=0.3,burst=20,alpha=1.5"

    ``interactive`` splits requests between the gateway's SLO classes; the
    class stream is drawn from its own namespaced rng, so turning it on
    never perturbs arrival times or prompt tokens."""
    kind: str = "poisson"            # poisson | pareto | diurnal | flash
    rate: Optional[float] = None     # per-device mean arrivals/s
    n: Optional[int] = None          # total requests across the topology
    prompt_len: Optional[int] = None
    interactive: float = 1.0         # fraction assigned the interactive class
    alpha: Optional[float] = None    # Pareto tail index (->1 = heavier);
    #                                  None = exponential gaps (pareto: 1.5)
    period_s: float = 1.0            # diurnal cycle length
    depth: float = 0.8               # diurnal trough is rate*(1-depth)
    at: float = 0.2                  # flash-crowd onset (s)
    dur: float = 0.2                 # flash-crowd duration (s)
    burst: float = 10.0              # flash-crowd rate multiplier

    KINDS = ("poisson", "pareto", "diurnal", "flash")

    def __post_init__(self):
        assert self.kind in self.KINDS, \
            f"unknown workload kind {self.kind!r} (one of {self.KINDS})"
        assert 0.0 <= self.interactive <= 1.0, self.interactive
        assert self.alpha is None or self.alpha > 1.0, \
            "Pareto gaps need alpha > 1 for a finite mean inter-arrival"
        assert 0.0 <= self.depth < 1.0, self.depth
        assert self.burst >= 1.0, self.burst

    @classmethod
    def parse(cls, spec: str) -> "WorkloadSpec":
        kind, _, rest = spec.partition(":")
        floats = {"rate": "rate", "interactive": "interactive",
                  "alpha": "alpha", "period": "period_s", "depth": "depth",
                  "at": "at", "dur": "dur", "burst": "burst"}
        ints = {"n": "n", "prompt_len": "prompt_len"}
        kw = {}
        for part in (p.strip() for p in rest.split(",") if p.strip()):
            key, eq, val = part.partition("=")
            if eq and key in floats:
                kw[floats[key]] = float(val)
            elif eq and key in ints:
                kw[ints[key]] = int(val)
            else:
                raise ValueError(
                    f"bad workload token {part!r}: expected "
                    f"<kind>:key=value,... with keys "
                    f"{sorted(floats) + sorted(ints)}")
        return cls(kind=kind.strip(), **kw)


def _assign_classes(arrivals: List[Arrival], interactive: float,
                    seed: int, device_offset: int) -> List[Arrival]:
    """SLO classes from a namespaced rng stream SEPARATE from the
    inter-arrival/token draws, so a class split never changes the trace
    timing or prompts (the legacy byte-identity contract)."""
    if interactive >= 1.0:
        return arrivals
    rng = np.random.default_rng([0x57, seed, device_offset])
    return [replace(a, slo="interactive" if rng.random() < interactive
                    else "batch") for a in arrivals]


def _modulated_arrivals(rate_of: Callable[[float], float], *,
                        num_devices: int, num_requests: int,
                        prompt_len: int, vocab_size: Optional[int] = None,
                        seed: int = 0, device_offset: int = 0, cell: int = 0,
                        alpha: Optional[float] = None) -> List[Arrival]:
    """Shared non-homogeneous builder: per-device unit-mean gap draws
    rescaled by the instantaneous rate.  ``alpha`` swaps the base draw
    from exponential to Pareto(alpha) with the same unit mean — heavy
    tails under any rate envelope.  Same per-device rng namespacing as
    :func:`poisson_arrivals`."""
    out: List[Arrival] = []
    per_dev = [num_requests // num_devices] * num_devices
    for i in range(num_requests % num_devices):
        per_dev[i] += 1
    for dev, n in enumerate(per_dev):
        rng = np.random.default_rng([seed, device_offset + dev])
        t = 0.0
        for _ in range(n):
            unit = rng.pareto(alpha) * (alpha - 1.0) if alpha is not None \
                else rng.exponential(1.0)
            t += unit / max(rate_of(t), 1e-9)
            tokens = None
            if vocab_size:
                tokens = rng.integers(0, vocab_size, size=(prompt_len,),
                                      dtype=np.int64).astype(np.int32)
            out.append(Arrival(device_offset + dev, t, tokens, cell))
    return out


def pareto_arrivals(*, num_devices: int, num_requests: int,
                    arrival_rate: float, prompt_len: int,
                    alpha: float = 1.5, vocab_size: Optional[int] = None,
                    seed: int = 0, device_offset: int = 0,
                    cell: int = 0) -> List[Arrival]:
    """Heavy-tailed arrivals: Pareto(alpha) inter-arrival gaps scaled to
    the same 1/arrival_rate mean as the Poisson builder — bursts and long
    idle gaps, the traffic shape that actually stresses admission
    control."""
    assert arrival_rate > 0 and alpha > 1.0, (arrival_rate, alpha)
    return _modulated_arrivals(
        lambda t: arrival_rate, num_devices=num_devices,
        num_requests=num_requests, prompt_len=prompt_len,
        vocab_size=vocab_size, seed=seed, device_offset=device_offset,
        cell=cell, alpha=alpha)


def diurnal_arrivals(*, num_devices: int, num_requests: int,
                     arrival_rate: float, prompt_len: int,
                     period_s: float = 1.0, depth: float = 0.8,
                     alpha: Optional[float] = None,
                     vocab_size: Optional[int] = None, seed: int = 0,
                     device_offset: int = 0, cell: int = 0) -> List[Arrival]:
    """Diurnal load curve: the rate swings cosine-shaped between the peak
    ``arrival_rate`` (t=0) and the trough ``arrival_rate*(1-depth)`` every
    ``period_s`` virtual seconds."""
    assert arrival_rate > 0 and period_s > 0, (arrival_rate, period_s)

    def rate_of(t: float) -> float:
        return arrival_rate * (
            1.0 - depth * 0.5 * (1.0 - float(np.cos(
                2.0 * np.pi * t / period_s))))
    return _modulated_arrivals(
        rate_of, num_devices=num_devices, num_requests=num_requests,
        prompt_len=prompt_len, vocab_size=vocab_size, seed=seed,
        device_offset=device_offset, cell=cell, alpha=alpha)


def flash_arrivals(*, num_devices: int, num_requests: int,
                   arrival_rate: float, prompt_len: int, at: float = 0.2,
                   dur: float = 0.2, burst: float = 10.0,
                   alpha: Optional[float] = None,
                   vocab_size: Optional[int] = None, seed: int = 0,
                   device_offset: int = 0, cell: int = 0) -> List[Arrival]:
    """Flash crowd: baseline ``arrival_rate`` except a ``burst``-times
    spike over ``[at, at+dur)`` — the shed-or-melt scenario the gateway
    benchmark runs (optionally with Pareto gaps via ``alpha``)."""
    assert arrival_rate > 0 and dur > 0, (arrival_rate, dur)

    def rate_of(t: float) -> float:
        return arrival_rate * burst if at <= t < at + dur else arrival_rate
    return _modulated_arrivals(
        rate_of, num_devices=num_devices, num_requests=num_requests,
        prompt_len=prompt_len, vocab_size=vocab_size, seed=seed,
        device_offset=device_offset, cell=cell, alpha=alpha)


def build_arrivals(spec: WorkloadSpec, *, num_devices: int, prompt_len: int,
                   vocab_size: Optional[int] = None, seed: int = 0,
                   device_offset: int = 0, cell: int = 0) -> List[Arrival]:
    """One cell's arrival trace from a :class:`WorkloadSpec`.  The
    ``poisson`` kind routes through :func:`poisson_arrivals` unchanged, so
    the legacy shim is byte-identical; every kind then gets its SLO
    classes from the separate class stream."""
    assert spec.rate is not None and spec.n is not None, \
        f"workload needs rate and n resolved, got {spec}"
    common = dict(num_devices=num_devices, num_requests=spec.n,
                  arrival_rate=spec.rate, prompt_len=prompt_len,
                  vocab_size=vocab_size, seed=seed,
                  device_offset=device_offset, cell=cell)
    if spec.kind == "poisson":
        out = poisson_arrivals(**common)
    elif spec.kind == "pareto":
        out = pareto_arrivals(alpha=spec.alpha or 1.5, **common)
    elif spec.kind == "diurnal":
        out = diurnal_arrivals(period_s=spec.period_s, depth=spec.depth,
                               alpha=spec.alpha, **common)
    else:
        out = flash_arrivals(at=spec.at, dur=spec.dur, burst=spec.burst,
                             alpha=spec.alpha, **common)
    return _assign_classes(out, spec.interactive, seed, device_offset)


# v2 adds the optional "faults" key to the header (the run's FaultSchedule,
# so a recorded chaotic run replays its fault sequence byte-for-byte); v3
# the per-arrival "slo" class key (the gateway's SLO classes survive record
# -> replay).  v1/v2 traces stay readable — their arrivals default to
# interactive and carry no schedule.
TRACE_FORMAT = "arrival-trace-v3"
LEGACY_TRACE_FORMATS = ("arrival-trace-v1", "arrival-trace-v2")


def record_arrivals(arrivals: Sequence[Arrival], path: str,
                    faults=None) -> None:
    """Write an arrival stream to JSONL (one line per arrival, preceded by
    a format header).  Floats round-trip exactly (json uses shortest-repr),
    so record -> replay -> record is byte-identical.  ``faults`` (a
    :class:`~repro_torch.runtime.faults.FaultSchedule`) rides in the header —
    recorded even when empty, so the replay re-enables the fault layer."""
    header = {"format": TRACE_FORMAT, "n": len(arrivals)}
    if faults is not None:
        header["faults"] = faults.to_obj()
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for a in arrivals:
            tokens = None if a.tokens is None else \
                [int(x) for x in np.asarray(a.tokens)]
            f.write(json.dumps({"cell": a.cell, "device": a.device,
                                "slo": a.slo, "t": a.t, "tokens": tokens},
                               sort_keys=True) + "\n")


def trace_faults(path: str) -> Optional[FaultSchedule]:
    """The fault schedule recorded in a v2 trace header, or None for a
    fault-free (or v1) trace."""
    with open(path) as f:
        header = json.loads(f.readline())
    if "faults" not in header:
        return None
    return FaultSchedule.from_obj(header["faults"])


def trace_arrivals(path: str) -> List[Arrival]:
    """Rebuild the identical Arrival list from a recorded JSONL trace."""
    with open(path) as f:
        header = json.loads(f.readline())
        assert header.get("format") in (TRACE_FORMAT,) + \
            LEGACY_TRACE_FORMATS, \
            f"{path}: not an arrival trace (header {header!r})"
        out: List[Arrival] = []
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            tokens = rec.get("tokens")
            if tokens is not None:
                tokens = np.asarray(tokens, np.int32)
            out.append(Arrival(device=rec["device"], t=rec["t"],
                               tokens=tokens, cell=rec.get("cell", 0),
                               slo=rec.get("slo", "interactive")))
    assert len(out) == header["n"], \
        f"{path}: truncated trace ({len(out)} of {header['n']} arrivals)"
    return out


# ---------------------------------------------------------------------------
# simulation config + driver
# ---------------------------------------------------------------------------


@dataclass
class SimConfig:
    cfg: object                              # ModelConfig (butterfly optional)
    mode: str = "split"                      # split | cloud | edge
    wire_mode: str = "int8"                  # raw | reduced | int8 | int4 | entropy
    transport: str = "cache_handoff"         # cache_handoff | streamed | progressive | auto
    network: str = "3g"                      # 3g | 4g | wifi | inter_pod
    duplex: str = "split"                    # split | shared downlink FIFO
    num_devices: int = 4
    num_requests: int = 16                   # total across all cells
    arrival_rate: float = 20.0               # per device, requests/s
    prompt_len: int = 32
    max_new_tokens: int = 4
    d_r: int = 16
    initial_split: int = 1
    candidate_splits: Optional[Sequence[int]] = None
    edge: HardwareProfile = JETSON_TX2
    cloud: HardwareProfile = GTX_1080TI
    # a multi-cell topology overrides the single-uplink fields above
    # (network/duplex/num_devices/edge/edge_mp); the 1-cell default IS the
    # classic configuration, built through the same path
    topology: Optional[Sequence[CellSpec]] = None
    # model-axis degree of each half's stage (DESIGN.md section 11): timing
    # divides by the degree; with numerics a degree above 1 runs on that
    # many torch.distributed ranks, each running this simulation
    # (launch/runtime_sim spawns them)
    edge_mp: int = 1
    cloud_mp: int = 1
    background_load: Optional[Callable[[float], float]] = None
    adapt: bool = False
    control_interval_s: float = 0.05
    objective: str = "latency"               # a planner.SELECTION_OBJECTIVES key
    slo_ms: Optional[float] = None           # SLO for energy_under_slo
    max_concurrent: int = 8
    seed: int = 0
    numerics: bool = True
    arrivals: Optional[Sequence[Arrival]] = None   # overrides Poisson build
    # workload spec (a WorkloadSpec or its grammar string): THE arrival
    # API.  Its rate/n/prompt_len override the three legacy fields above,
    # which remain a deprecation shim onto WorkloadSpec(kind="poisson").
    workload: Optional[Union[str, WorkloadSpec]] = None
    # flight recorder (all opt-in; the default path is byte-identical to a
    # build without any of it)
    trace: bool = False                      # virtual-clock span tracing
    metrics: bool = False                    # fixed-interval metrics sampler
    metrics_interval_s: float = 0.01
    profile_jit: bool = False                # wall-clock jit attribution
    # where the bank's numerics run: "cuda" (the default, raising without a
    # card) or "cpu"; a timing-only run touches no device
    device: str = "cuda"
    # fault injection (runtime/faults.py): a FaultSchedule, a DSL string
    # ("leave@0.05:2,outage@0.3+0.1"), or None.  Setting either field
    # builds the FaultInjector (watchdog + retry state machine included);
    # with both None the fault layer is entirely absent and the run is
    # byte-identical to a build without the module.
    faults: Optional[object] = None
    recovery: Optional[RecoveryPolicy] = None
    # serving gateway (runtime/gateway.py): a GatewayPolicy, its grammar
    # string, or None.  The all-off GatewayPolicy() is byte-identical to
    # None (asserted in tests) — the same contract the fault layer makes.
    gateway: Optional[Union[str, GatewayPolicy]] = None


class Simulation:
    def __init__(self, sim_cfg: SimConfig):
        c = sim_cfg
        # resolve the workload spec first: its rate/n/prompt_len override
        # the legacy SimConfig fields everywhere downstream (max_len,
        # controllers, arrival builders all read the resolved values)
        self.workload: Optional[WorkloadSpec] = None
        if c.workload is not None:
            w = WorkloadSpec.parse(c.workload) \
                if isinstance(c.workload, str) else c.workload
            self.workload = w
            overrides = {k: v for k, v in (("arrival_rate", w.rate),
                                           ("num_requests", w.n),
                                           ("prompt_len", w.prompt_len))
                         if v is not None}
            if overrides:
                c = replace(c, **overrides)
        assert c.mode in ("split", "cloud", "edge"), c.mode
        assert c.transport in ("cache_handoff", "streamed", "progressive",
                               "auto"), c.transport
        if c.transport == "auto":
            assert c.adapt and c.mode == "split", \
                "transport='auto' needs the adaptive controller (split mode)"
        base = c.cfg
        if base.butterfly is not None:
            base = replace(base, butterfly=None)
        self.sim_cfg = c
        self.base_cfg = base
        self.loop = EventLoop()
        self.tracer = Tracer() if c.trace else NULL_TRACER
        self.registry = MetricsRegistry()
        self.telemetry = Telemetry(self.registry)
        self.candidates = list(c.candidate_splits) if c.candidate_splits \
            else list(range(1, base.num_layers))

        # every configuration is a topology; the classic single-uplink
        # SimConfig fields synthesize the 1-cell special case
        specs = tuple(c.topology) if c.topology else (CellSpec(
            name="cell0", network=c.network, num_devices=c.num_devices,
            device=c.edge, duplex=c.duplex, edge_mp=c.edge_mp),)
        names = [s.name for s in specs]
        assert len(set(names)) == len(names), f"duplicate cell names {names}"
        self.cells: List[Cell] = []
        wires = {}
        edge_mps = set()
        for i, spec in enumerate(specs):
            key = spec.wire or spec.name
            if key not in wires:
                wires[key] = Wire.named(spec.network,
                                        duplex=spec.duplex or c.duplex)
                wires[key].tracer = self.tracer
                # group key, not network name: two cells on the same network
                # still get distinct trace tracks
                wires[key].track_prefix = f"wire/{key}"
            else:
                assert wires[key].name == spec.network, \
                    f"wire group {key!r} spans networks " \
                    f"{wires[key].name!r} and {spec.network!r}"
            split = spec.initial_split if spec.initial_split is not None \
                else c.initial_split
            assert split in self.candidates, \
                f"cell {spec.name}: initial split {split} not in " \
                f"{self.candidates}"
            tp_mode = spec.transport or c.transport
            assert tp_mode in ("cache_handoff", "streamed", "progressive",
                               "auto"), tp_mode
            cost = CostModel(base, spec.hardware(), c.cloud,
                             edge_mp=spec.edge_mp, cloud_mp=c.cloud_mp)
            self.cells.append(Cell(
                spec, i, wires[key], cost, split,
                "cache_handoff" if tp_mode == "auto" else tp_mode))
            edge_mps.add(spec.edge_mp)

        self.wires = wires
        self.profiler = JitProfiler(c.device) \
            if (c.profile_jit and c.numerics) else None
        self.bank = SplitModelBank(base, c.d_r, wire_mode=c.wire_mode,
                                   seed=c.seed, edge_mp=min(edge_mps),
                                   cloud_mp=c.cloud_mp,
                                   profiler=self.profiler,
                                   device=c.device) \
            if c.numerics else None
        # cloud-side cost model (the server only charges cloud durations;
        # cell 0's is exact for the 1-cell configuration)
        self.cost = self.cells[0].cost
        self._remaining = 0
        self.server = CloudServer(
            CloudSpec(cost=self.cost, bank=self.bank, mode=c.mode,
                      d_r=c.d_r, max_concurrent=c.max_concurrent,
                      background_load=c.background_load, engine_seed=c.seed,
                      max_len=c.prompt_len + c.max_new_tokens + 2,
                      numerics_split=self.cells[0].current_split),
            loop=self.loop, telemetry=self.telemetry,
            wire=self.cells[0].wire, on_done=self._on_done)
        self.server.tracer = self.tracer
        self.devices: List[EdgeDevice] = []
        for cell in self.cells:
            cell.dev_base = len(self.devices)
            for i in range(cell.spec.num_devices):
                self.devices.append(EdgeDevice(
                    len(self.devices), loop=self.loop, cost=cell.cost,
                    uplink=cell.wire, server=self.server, bank=self.bank,
                    mode=c.mode, wire_mode=c.wire_mode, d_r=c.d_r,
                    telemetry=self.telemetry,
                    numerics_split=cell.current_split,
                    cell=cell.name, cell_index=cell.index))
                self.devices[-1].tracer = self.tracer
        self.server.devices = self.devices       # downlink delivery targets
        self.gateway: Optional[Gateway] = None
        if c.gateway is not None:
            policy = GatewayPolicy.parse(c.gateway) \
                if isinstance(c.gateway, str) else c.gateway
            if policy.autoscale:
                assert not c.numerics, \
                    "autoscaled replicas are a timing-only capacity model " \
                    "(the serving engines are built at a fixed max_batch)"
            self.gateway = Gateway(policy, loop=self.loop,
                                   server=self.server,
                                   telemetry=self.telemetry)
        self.controllers: List[object] = []
        if c.adapt and c.mode == "split":
            from repro_torch.runtime.controller import AdaptiveSplitController
            for cell in self.cells:
                spec = cell.spec
                tp_mode = spec.transport or c.transport
                # a cell whose breaker is open sees a ceilinged cloud load
                # (the gateway is refusing its traffic), so its controller
                # routes edge-heavy exactly as during a cloud outage
                cloud_load = self.gateway.cell_load_fn(cell.name) \
                    if self.gateway is not None else self.server.current_load
                cell.controller = AdaptiveSplitController(
                    loop=self.loop, uplink=cell.wire,
                    cloud_load=cloud_load,
                    cfg=base, d_r=c.d_r, seq=c.prompt_len,
                    candidate_splits=self.candidates,
                    edge=spec.hardware(), cloud=c.cloud,
                    wire_mode=c.wire_mode,
                    telemetry=self.telemetry,
                    set_split=cell.set_split,
                    get_split=lambda cell=cell: cell.current_split,
                    interval_s=c.control_interval_s,
                    handoff_bytes_per_layer=(
                        cell.cost.stage0_cache_bytes(c.prompt_len, 1)
                        if c.max_new_tokens > 1 else 0.0),
                    objective=c.objective,
                    slo_s=c.slo_ms / 1e3 if c.slo_ms else None,
                    transport_mode=tp_mode,
                    new_tokens=c.max_new_tokens,
                    set_transport=cell.set_transport,
                    get_transport=lambda cell=cell: cell.current_transport,
                    edge_mp=spec.edge_mp, cloud_mp=c.cloud_mp,
                    cell=cell.name, tracer=self.tracer)
                self.controllers.append(cell.controller)
                if self.gateway is not None:
                    # breaker open/close transitions nudge the cell's
                    # controller off-cycle, like a link handover does
                    self.gateway.pokes[cell.name] = cell.controller.poke
        self.injector: Optional[FaultInjector] = None
        self.fault_schedule: Optional[FaultSchedule] = None
        if c.faults is not None or c.recovery is not None:
            sched = c.faults
            if isinstance(sched, str):
                sched = FaultSchedule.parse(sched)
            elif sched is None:
                sched = FaultSchedule()
            self.fault_schedule = sched
            self.injector = FaultInjector(self, sched, c.recovery)
            self.server.injector = self.injector
            for d in self.devices:
                d.injector = self.injector
        self._register_tracks()
        self._in_flight = {cell.name: 0 for cell in self.cells}
        self.sampler = self._build_sampler() if c.metrics else None
        self.arrivals: List[Arrival] = (
            list(c.arrivals) if c.arrivals is not None
            else self._build_arrivals())
        self._validate_arrivals()
        self._remaining = len(self.arrivals)

    # ------------------------------------------------------------------ api
    @property
    def uplink(self) -> Wire:
        """Cell 0's Wire (THE uplink of a single-cell configuration)."""
        return self.cells[0].wire

    @property
    def current_split(self) -> int:
        return self.cells[0].current_split

    @property
    def current_transport(self) -> str:
        return self.cells[0].current_transport

    @property
    def controller(self) -> Optional[object]:
        return self.controllers[0] if self.controllers else None

    def cell_of(self, device: int) -> Cell:
        return self.cells[self.devices[device].cell_index]

    def record_trace(self, path: str) -> None:
        """Record this run's arrival stream (cell, device, t, prompt) to
        JSONL; :func:`trace_arrivals` rebuilds the identical list, so the
        replayed simulation is byte-for-byte identical.  A configured fault
        schedule rides in the header (:func:`trace_faults` recovers it)."""
        record_arrivals(self.arrivals, path, faults=self.fault_schedule)

    def run(self) -> Telemetry:
        self._schedule_arrivals()
        if self.injector is not None:
            self.injector.start()
        for ctl in self.controllers:
            ctl.start()
        if self.sampler is not None:
            self.sampler.start()
        if self.gateway is not None:
            self.gateway.start()
        self.loop.run()
        if self._remaining:
            # without the fault layer every request must complete; with it,
            # anything the watchdog missed is failed as lost — the loop
            # draining early must never leave a request unaccounted
            assert self.injector is not None, \
                f"{self._remaining} requests never completed"
            for req in self.requests:
                if not req.finished:
                    self.injector.fail(req, "lost")
        if self.bank is not None:
            c = self.telemetry.counters
            c["engine_decode_steps"] = sum(
                e.decode_steps for e in self.server._engines.values()) + sum(
                d._local_engine.decode_steps for d in self.devices
                if d._local_engine is not None)
            c["bank_jit_cache_entries"] = self.bank.jit_cache_entries
            c["bank_jit_cache_hits"] = self.bank.cache_hits
            c["bank_jit_cache_misses"] = self.bank.cache_misses
        if self.profiler is not None:
            self.telemetry.jit_profile = {
                "headline": self.profiler.headline(),
                "entries": self.profiler.summary()}
        return self.telemetry

    # ------------------------------------------------------------- internals
    def _register_tracks(self) -> None:
        """Pre-register every trace track in topology order so the exported
        file lists them deterministically (and readably) even for tracks
        that end up empty."""
        if not self.tracer.enabled:
            return
        for d in self.devices:
            self.tracer.track(d.track)
        for key, w in self.wires.items():
            self.tracer.track(f"{w.track_prefix}/up")
            self.tracer.track(f"{w.track_prefix}/down")
        self.tracer.track("cloud/accel")
        for i in range(self.sim_cfg.max_concurrent):
            self.tracer.track(f"cloud/slot{i}")
        for cell in self.cells:
            if cell.controller is not None:
                self.tracer.track(f"ctl/{cell.name}")
            self.tracer.track(f"req/{cell.name}")
        if self.injector is not None:
            self.tracer.track("faults/sched")

    def _build_sampler(self) -> MetricsSampler:
        """Wire the fixed-interval sampler to read-only views of runtime
        state: queue depths, per-direction wire occupancy + windowed
        goodput, cloud batch size/occupancy, per-cell in-flight counts."""
        sampler = MetricsSampler(self.loop, self.registry,
                                 interval_s=self.sim_cfg.metrics_interval_s)
        srv = self.server
        sampler.add_source("cloud/load", srv.current_load)
        sampler.add_source("cloud/active",
                           lambda now: float(srv.num_active))
        sampler.add_source("cloud/decoding",
                           lambda now: float(srv.num_decoding))
        sampler.add_source("cloud/pending",
                           lambda now: float(len(srv.pending)))
        sampler.add_source("cloud/available",
                           lambda now: 0.0 if now < srv.outage_until else 1.0)
        for key, w in self.wires.items():
            sampler.add_source(f"wire/{key}/up_backlog_s", w.up_backlog_s)
            sampler.add_source(f"wire/{key}/down_backlog_s",
                               w.down_backlog_s)
            sampler.add_source(f"wire/{key}/up_goodput_bps",
                               w.observed_bytes_per_s)
            sampler.add_source(f"wire/{key}/down_goodput_bps",
                               w.observed_down_bytes_per_s)
        for cell in self.cells:
            # membership resolves at sample time: devices that JOIN the cell
            # mid-run (fault layer churn) enter the gauge
            sampler.add_source(
                f"cell/{cell.name}/queue_depth",
                lambda now, ci=cell.index: float(sum(
                    d.queue_depth(now) for d in self.devices
                    if d.cell_index == ci)))
            sampler.add_source(
                f"cell/{cell.name}/in_flight",
                lambda now, name=cell.name: float(self._in_flight[name]))
        return sampler

    def _build_arrivals(self) -> List[Arrival]:
        """Per-cell arrival streams through the :class:`WorkloadSpec` path
        (the legacy rate/n fields synthesize the Poisson spec): explicit
        CellSpec.num_requests is honored, the rest of the fleet-wide total
        splits evenly (remainder to earlier cells) — the 1-cell Poisson
        case reduces to the classic builder byte-for-byte."""
        c = self.sim_cfg
        base_spec = self.workload or WorkloadSpec()
        explicit = sum(s.spec.num_requests or 0 for s in self.cells)
        open_cells = [cell for cell in self.cells
                      if cell.spec.num_requests is None]
        left = max(c.num_requests - explicit, 0)
        share = [left // len(open_cells)] * len(open_cells) if open_cells \
            else []
        for i in range(left % len(open_cells) if open_cells else 0):
            share[i] += 1
        shares = iter(share)
        out: List[Arrival] = []
        for cell in self.cells:
            spec = cell.spec
            n = spec.num_requests if spec.num_requests is not None \
                else next(shares)
            out.extend(build_arrivals(
                replace(base_spec, n=n,
                        rate=spec.arrival_rate
                        if spec.arrival_rate is not None else c.arrival_rate),
                num_devices=spec.num_devices, prompt_len=c.prompt_len,
                vocab_size=self.base_cfg.vocab_size if c.numerics else None,
                seed=c.seed, device_offset=cell.dev_base, cell=cell.index))
        return out

    def _validate_arrivals(self) -> None:
        for a in self.arrivals:
            assert 0 <= a.device < len(self.devices), \
                f"arrival device {a.device} outside the fleet " \
                f"({len(self.devices)} devices)"
            assert self.devices[a.device].cell_index == a.cell, \
                f"arrival routes device {a.device} to cell {a.cell} but it " \
                f"lives in cell {self.devices[a.device].cell_index} — " \
                f"replayed trace does not match this topology"

    def _on_done(self, req: SimRequest) -> None:
        self._remaining -= 1
        t = req.trace
        self._in_flight[t.cell] -= 1
        if self.tracer.enabled:
            self.tracer.async_span(
                f"req/{t.cell}", "request", t.uid, t.t_arrival, t.t_done,
                args={"uid": t.uid, "device": t.device, "split": t.split,
                      "transport": t.transport})
        if self._remaining == 0:
            for ctl in self.controllers:
                ctl.stop()
            if self.sampler is not None:
                self.sampler.stop()
            if self.injector is not None:
                self.injector.stop()    # cancel the watchdog: loop can drain
            if self.gateway is not None:
                self.gateway.stop()     # cancel the autoscale tick

    def _schedule_arrivals(self) -> None:
        c = self.sim_cfg
        self.requests: List[SimRequest] = []
        for uid, a in enumerate(self.arrivals):
            assert not c.numerics or a.tokens is not None, \
                "numerics mode needs prompt tokens in the arrival trace"
            trace = RequestTrace(
                uid=uid, device=a.device, mode=c.mode, wire_mode=c.wire_mode,
                split=0, prompt_len=c.prompt_len,
                cell=self.cells[a.cell].name, slo_class=a.slo)
            req = SimRequest(trace=trace, tokens=a.tokens,
                             max_new_tokens=c.max_new_tokens)
            self.requests.append(req)
            self.loop.schedule_at(a.t, self._make_arrival(a.device, req))

    def _make_arrival(self, dev: int, req: SimRequest) -> Callable[[], None]:
        def fire() -> None:
            # split and transport are pinned when the mobile starts the
            # request — the owning cell's latest controller decision governs
            # new arrivals only
            cell = self.cell_of(dev)
            self._in_flight[cell.name] += 1
            if self.sim_cfg.mode == "split":
                req.trace.split = cell.current_split
                req.trace.transport = cell.current_transport
            elif self.sim_cfg.mode == "edge":
                req.trace.split = self.base_cfg.num_layers
            else:
                req.trace.split = 0
            target = dev if self.injector is None else \
                self.injector.route(dev)
            if target < 0:                  # cell fully evicted: dead letter
                req.trace.t_arrival = self.loop.now
                self.injector.fail(req, "no_device_in_cell")
                return
            self.devices[target].on_arrival(req)
        return fire


def run_sim(sim_cfg: SimConfig) -> Telemetry:
    return Simulation(sim_cfg).run()
