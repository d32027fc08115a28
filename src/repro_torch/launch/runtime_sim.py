"""Split-serving runtime simulator CLI (port of ``repro.launch.runtime_sim``:
the same flags, the same stdout and ``--json`` telemetry, and ``--device``).

Streams Poisson requests from a fleet of simulated edge devices through the
butterfly split (edge half -> contended wireless uplink -> cloud
continuous-batching server) on a deterministic virtual clock, and prints the
per-request latency breakdown plus p50/p95/p99 aggregates.

Multi-cell topologies put heterogeneous fleets behind per-cell radios
(``--topology 3g:4xphone,wifi:2xjetson``): each cell gets its own Wire and
its own adaptive controller, all contending for one cloud.  Any run's
arrival stream can be recorded to JSONL (``--record-trace``) and replayed
byte-for-byte (``--replay-trace``).

The numerics run on ``--device`` (``cuda`` by default: the Hopper kernels on
the card; ``cpu`` runs the kernels' plain versions) and raise, never fall
back, when that device is missing; ``--no-numerics`` touches no device.
A model axis (``--edge-mp``/``--cloud-mp`` above 1) divides the cost model's
stage times in timing-only mode, with no process started, as in the JAX
package; with numerics the launcher spawns ``max(edge_mp, cloud_mp)`` ranks
on ``--device`` (``models/parallel.spawn``), each runs the simulation with
its shards, and rank 0 alone prints and writes the artifacts.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --network 3g --devices 4 --requests 16
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --device cpu --requests 4
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --mode cloud --network 3g
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --wire-mode raw --no-numerics
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --transport streamed \\
      --seq 128 --max-new-tokens 16 --no-numerics
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --adapt --load-ramp 0:0,0.3:0.97 \\
      --requests 64 --rate 40 --max-new-tokens 1 --no-numerics
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --topology 3g:4xjetson,wifi:4xphone \\
      --adapt --transport auto --load-ramp 0:0.95 --no-numerics \\
      --record-trace trace.jsonl
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --topology 3g:4xjetson,wifi:4xphone \\
      --adapt --transport auto --load-ramp 0:0.95 --no-numerics \\
      --replay-trace trace.jsonl
  PYTHONPATH=src python -m repro_torch.launch.runtime_sim --adapt \\
      --objective energy_under_slo --slo-ms 50 --no-numerics
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def parse_ramp(spec: str):
    """"t0:l0,t1:l1" -> piecewise-linear background-load schedule."""
    pts = []
    try:
        for part in spec.split(","):
            t, l = part.split(":")
            pts.append((float(t), float(l)))
    except ValueError:
        raise SystemExit(f"--load-ramp: expected 't0:l0,t1:l1,...', "
                         f"got {spec!r}")
    pts.sort()

    def f(t: float) -> float:
        if t <= pts[0][0]:
            return pts[0][1]
        for (t0, l0), (t1, l1) in zip(pts, pts[1:]):
            if t <= t1:
                return l0 + (l1 - l0) * (t - t0) / max(t1 - t0, 1e-12)
        return pts[-1][1]
    return f


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--layers", type=int, default=4,
                    help="override layer count of the reduced arch "
                         "(>=2; more layers = more candidate splits)")
    ap.add_argument("--heads", type=int, default=None,
                    help="override attention head count of the reduced arch "
                         "(model-parallel degrees must divide the heads)")
    ap.add_argument("--kv-heads", type=int, default=None,
                    help="override kv head count of the reduced arch")
    ap.add_argument("--mode", choices=("split", "cloud", "edge"),
                    default="split")
    ap.add_argument("--wire-mode",
                    choices=("raw", "reduced", "int8", "int4", "entropy"),
                    default="int8",
                    help="entropy = int8 codes rANS-coded against the "
                         "learned per-channel prior (core/wire_codec; "
                         "lossless, so numerics match int8 bitwise); "
                         "payload bytes become data-dependent and telemetry "
                         "gains coded_bytes/compression_ratio")
    ap.add_argument("--transport",
                    choices=("cache_handoff", "streamed", "progressive",
                             "auto"),
                    default="cache_handoff",
                    help="decode transport for multi-token split requests: "
                         "cache_handoff ships the edge stage-0 KV cache up "
                         "front; streamed keeps it on the edge and sends one "
                         "int8 (1, d_r) row per generated token (DESIGN.md "
                         "section 8.6); progressive is streamed with a "
                         "bitplane-split prefill upload (cloud prefill "
                         "starts on the coarse planes and overlaps the "
                         "refinement tail, DESIGN.md section 18); auto lets "
                         "each cell's adaptive controller pick per request "
                         "(requires --adapt)")
    ap.add_argument("--network", default="3g",
                    choices=("3g", "4g", "wifi", "inter_pod"))
    ap.add_argument("--duplex", choices=("split", "shared"), default="split",
                    help="uplink/downlink FIFO contention: independent per "
                         "direction (split) or one serial frontier (shared)")
    ap.add_argument("--topology", default=None,
                    help="multi-cell topology 'net[/duplex]:<N>x<class>"
                         "[@rate],...' (e.g. '3g:4xphone,wifi:2xjetson'; "
                         "classes: core/profiler.DEVICE_CLASSES); each cell "
                         "gets its own Wire + adaptive controller and "
                         "overrides --network/--duplex/--devices "
                         "(DESIGN.md section 12)")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16,
                    help="total requests across all cells")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson arrival rate per device (req/s)")
    ap.add_argument("--workload", default=None, metavar="SPEC",
                    help="workload spec '<kind>:key=value,...' (kinds: "
                         "poisson | pareto | diurnal | flash; e.g. "
                         "'pareto:alpha=1.5,rate=20,n=1000,"
                         "interactive=0.25'); its rate/n/prompt_len "
                         "override --rate/--requests/--seq "
                         "(DESIGN.md section 17)")
    ap.add_argument("--gateway", default=None, metavar="SPEC",
                    help="serving-gateway policy: comma list of "
                         "priority | shed | breaker | hedge[=delay_s] | "
                         "autoscale | slo=<int_ms>/<batch_ms|inf> | "
                         "reserve=<n> | cache=<n> | replicas=<n> | "
                         "spinup=<s> (DESIGN.md section 17; autoscale "
                         "needs --no-numerics)")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--d-r", type=int, default=16)
    ap.add_argument("--split", type=int, default=1,
                    help="initial partition point (layers on the edge)")
    ap.add_argument("--adapt", action="store_true",
                    help="enable the adaptive split controller (Sec. III-C); "
                         "topologies run one controller per cell")
    ap.add_argument("--objective", default="latency",
                    help="controller selection objective "
                         "(core/planner.SELECTION_OBJECTIVES): latency | "
                         "energy | energy_under_slo (needs --slo-ms)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO for --objective energy_under_slo")
    ap.add_argument("--control-interval", type=float, default=0.05)
    ap.add_argument("--load-ramp", default=None,
                    help='background cloud load "t0:l0,t1:l1,..."')
    ap.add_argument("--cloud-x", type=float, default=None,
                    help="cloud speed as a multiple of the edge platform "
                         "(default: paper's TX2 -> 1080Ti pairing)")
    ap.add_argument("--edge-mp", type=int, default=1,
                    help="model-axis degree of the edge half's stage "
                         "(DESIGN.md section 11); with numerics, one "
                         "process a rank")
    ap.add_argument("--cloud-mp", type=int, default=1,
                    help="model-axis degree of the cloud half's stage")
    ap.add_argument("--max-concurrent", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-numerics", action="store_true",
                    help="timing-only (skip the real computation; needs "
                         "no device)")
    ap.add_argument("--device", default="cuda",
                    help="where the numerics run: cuda (the default; "
                         "raises without a card) or cpu")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="inject a fault schedule: comma-separated "
                         "'kind@t[:arg][+dur]' events (leave@0.05:2, "
                         "join@0.2:<cell>, handover@0.1:<cell>><net>, "
                         "blackout@0.15:<cell>+0.05, outage@0.3+0.2) or "
                         "'random:<seed>' for a seeded chaos schedule over "
                         "the parsed topology (DESIGN.md section 15)")
    ap.add_argument("--record-trace", default=None, metavar="JSONL",
                    help="record this run's arrival stream (cell, device, t, "
                         "prompt) for later --replay-trace")
    ap.add_argument("--replay-trace", default=None, metavar="JSONL",
                    help="replay a recorded arrival stream instead of "
                         "building Poisson arrivals (byte-for-byte "
                         "reproducible; overrides --requests/--rate)")
    ap.add_argument("--json", default=None, help="write full trace JSON here")
    ap.add_argument("--trace-out", default=None, metavar="JSON",
                    help="write a Chrome trace-event file of the run "
                         "(virtual-clock spans; load in Perfetto / "
                         "chrome://tracing; validate with "
                         "'python -m repro_torch.runtime.tracing <file>')")
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="write the fixed-interval metrics timeline (queue "
                         "depths, wire occupancy/goodput, cloud batch, "
                         "per-cell in-flight) as JSONL")
    ap.add_argument("--metrics-interval", type=float, default=0.01,
                    help="sampler period in virtual seconds")
    ap.add_argument("--profile-jit", action="store_true",
                    help="wall-clock compile-vs-execute attribution per jit "
                         "cache entry (numerics mode; host-dependent, so "
                         "excluded from virtual-clock artifacts)")
    args = ap.parse_args()
    ranks = max(args.edge_mp, args.cloud_mp)
    if ranks > 1 and not args.no_numerics:
        from repro_torch import device as dev_lib
        from repro_torch.models import parallel
        parallel.spawn(_rank, ranks, (args,),
                       devices=dev_lib.resolve(args.device))
        return
    _simulate(args)


def _rank(rank: int, device, args) -> None:
    """One model rank of a numerics run: rank 0 prints and writes."""
    if rank:
        sys.stdout = open(os.devnull, "w")
        args = argparse.Namespace(**dict(
            vars(args), json=None, trace_out=None, metrics_out=None,
            record_trace=None))
    _simulate(args)


def _simulate(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.profiler import GTX_1080TI, JETSON_TX2
    from repro_torch.runtime.faults import FaultSchedule
    from repro_torch.runtime.simulator import (SimConfig, Simulation,
                                         parse_topology, trace_arrivals,
                                         trace_faults)

    cfg = get_config(args.arch).reduced()
    if args.layers and args.layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=max(2, args.layers))
    if args.heads:
        cfg = dataclasses.replace(cfg, num_heads=args.heads)
    if args.kv_heads:
        cfg = dataclasses.replace(cfg, num_kv_heads=args.kv_heads)
    edge = JETSON_TX2
    cloud = edge.scaled(args.cloud_x, "cloud_slice") if args.cloud_x \
        else GTX_1080TI
    topology = parse_topology(args.topology) if args.topology else None
    arrivals = None
    faults = None
    if args.replay_trace:
        arrivals = trace_arrivals(args.replay_trace)
        faults = trace_faults(args.replay_trace)
    if args.faults:
        if args.faults.startswith("random:"):
            seed = int(args.faults.split(":", 1)[1])
            cells = tuple(c.name for c in topology) if topology \
                else ("cell0",)
            n_dev = sum(c.num_devices for c in topology) if topology \
                else args.devices
            faults = FaultSchedule.random(seed, cells=cells,
                                          num_devices=n_dev)
        else:
            faults = FaultSchedule.parse(args.faults)
    sim_cfg = SimConfig(
        cfg=cfg, mode=args.mode, wire_mode=args.wire_mode,
        transport=args.transport, network=args.network, duplex=args.duplex,
        topology=topology, num_devices=args.devices,
        num_requests=args.requests, arrival_rate=args.rate,
        prompt_len=args.seq, max_new_tokens=args.max_new_tokens,
        d_r=args.d_r, initial_split=args.split,
        edge=edge, cloud=cloud,
        edge_mp=args.edge_mp, cloud_mp=args.cloud_mp,
        background_load=parse_ramp(args.load_ramp) if args.load_ramp else None,
        adapt=args.adapt, control_interval_s=args.control_interval,
        objective=args.objective, slo_ms=args.slo_ms,
        max_concurrent=args.max_concurrent, seed=args.seed,
        numerics=not args.no_numerics, arrivals=arrivals, faults=faults,
        workload=args.workload, gateway=args.gateway,
        trace=bool(args.trace_out), metrics=bool(args.metrics_out),
        metrics_interval_s=args.metrics_interval,
        profile_jit=args.profile_jit, device=args.device)

    sim = Simulation(sim_cfg)
    if args.record_trace:
        sim.record_trace(args.record_trace)
        print(f"# recorded {len(sim.arrivals)} arrivals -> "
              f"{args.record_trace}")
    tel = sim.run()

    mp_note = ""
    if args.edge_mp > 1 or args.cloud_mp > 1:
        mp_note = f", model-parallel edge x{args.edge_mp} / " \
                  f"cloud x{args.cloud_mp}"
    fleet_note = args.topology if args.topology else \
        f"{args.devices} devices on {args.network}"
    print(f"# {args.mode} serving, wire={args.wire_mode}, "
          f"transport={args.transport}, {fleet_note}, "
          f"{len(sim.arrivals)} requests, "
          f"arch={cfg.name} ({cfg.num_layers} layers, d_r={args.d_r})"
          f"{mp_note}")
    print(tel.table())
    s = tel.summary()
    print(f"\nlatency  p50 {s['latency_p50_ms']:9.2f} ms   "
          f"p95 {s['latency_p95_ms']:9.2f} ms   "
          f"p99 {s['latency_p99_ms']:9.2f} ms")
    print(f"ttft     p50 {s['ttft_p50_ms']:9.2f} ms   "
          f"mean wire {s['mean_wire_kb']:8.2f} kB   "
          f"mean mobile energy {s['mean_mobile_energy_mj']:8.1f} mJ")
    for cell in sim.cells:
        w = cell.wire
        print(f"[{cell.name}] uplink busy {w.stats.busy_s*1e3:.1f} ms, "
              f"wait {w.stats.wait_s*1e3:.1f} ms over "
              f"{w.stats.n_transfers} transfers; "
              f"downlink busy {w.down_stats.busy_s*1e3:.1f} ms, "
              f"wait {w.down_stats.wait_s*1e3:.1f} ms "
              f"({w.down_stats.bytes_sent:.0f} B of sampled ids)")
    if len(sim.cells) > 1:
        fair = tel.fairness()
        print(f"fairness: max/min mean latency "
              f"{fair['max_min_latency_ratio']:.2f}x, p95 spread "
              f"{fair['p95_spread_ms']:.2f} ms, Jain "
              f"{fair['jain_index']:.3f}")
        for name, row in tel.cell_summary().items():
            print(f"  [{name}] n={row['n_requests']:.0f} "
                  f"p50 {row['latency_p50_ms']:.2f} ms  "
                  f"p95 {row['latency_p95_ms']:.2f} ms  "
                  f"uplink wait {row['mean_uplink_wait_ms']:.2f} ms  "
                  f"energy {row['mean_mobile_energy_mj']:.1f} mJ")
    if s["mean_stream_rtt_ms"] > 0:
        print(f"streamed decode: mean per-token RTT "
              f"{s['mean_stream_rtt_ms']:.2f} ms "
              f"(row up + cloud turn + id down)")
    if sim.injector is not None:
        print(f"\nfaults ({len(sim.fault_schedule)} injected): "
              f"availability {s['availability_pct']:.1f}%  "
              f"done {s['n_done']:.0f}  failed {s['n_failed']:.0f}  "
              f"migrated {s['n_migrated']:.0f}  "
              f"retried {s['n_retried']:.0f}  "
              f"edge-fallback {s['n_fallback']:.0f}")
        for ev in sim.fault_schedule:
            tgt = ev.cell or (f"dev{ev.device}" if ev.device >= 0 else "cloud")
            extra = f" -> {ev.network}" if ev.network else ""
            extra += f" for {ev.duration*1e3:.0f} ms" if ev.duration else ""
            print(f"  {ev.t:7.3f}s  {ev.kind:<13} {tgt}{extra}")
    if sim.gateway is not None:
        c = tel.counters
        print(f"\ngateway ({args.gateway}): done {s['n_done']:.0f}  "
              f"failed {s['n_failed']:.0f}  shed {s['n_shed']:.0f}  "
              f"hedged {s['n_hedged']:.0f}  "
              f"cache hits {c['gateway_cache_hits']:.0f}  "
              f"breaker opens {c['gateway_breaker_opens']:.0f}  "
              f"scale-ups {c['gateway_scale_ups']:.0f}")
        for cls, row in tel.class_summary().items():
            print(f"  [{cls:<11}] n={row['n_requests']:.0f} "
                  f"done {row['n_done']:.0f} shed {row['n_shed']:.0f}  "
                  f"p50 {row['latency_p50_ms']:.2f} ms  "
                  f"p99 {row['latency_p99_ms']:.2f} ms")
    if tel.decisions:
        print("\ncontroller decisions (t, cell, cloud_load, split, "
              "transport):")
        for d in tel.decisions:
            mark = " <-- moved" if d.new_split != d.old_split else ""
            print(f"  {d.t:7.3f}s  [{d.cell}]  load={d.cloud_load:5.1%}  "
                  f"split={d.new_split}  {d.transport}{mark}")
    if args.profile_jit and tel.jit_profile:
        h = tel.jit_profile["headline"]
        print(f"\njit profile: {h['entries']} cache entries, "
              f"{h['calls']} dispatches, compile "
              f"{h['compile_wall_ms']:.1f} ms / steady "
              f"{h['steady_wall_ms']:.1f} ms "
              f"(compile fraction {h['compile_fraction']:.1%})")
        for key, row in sorted(tel.jit_profile["entries"].items()):
            print(f"  {key:<28} first {row['first_call_ms']:8.1f} ms  "
                  f"steady x{row['steady_calls']:<3.0f} "
                  f"mean {row['steady_mean_ms']:7.2f} ms")
    if args.json:
        with open(args.json, "w") as f:
            f.write(tel.to_json())
        print(f"\nwrote {args.json}")
    if args.trace_out:
        sim.tracer.write(args.trace_out)
        print(f"wrote {args.trace_out} "
              f"({len(sim.tracer.events)} trace events; validate with "
              f"'python -m repro_torch.runtime.tracing {args.trace_out}')")
    if args.metrics_out:
        sim.sampler.write(args.metrics_out)
        print(f"wrote {args.metrics_out} "
              f"({len(sim.sampler.rows)} samples x "
              f"{len(sim.sampler.sources)} sources)")


if __name__ == "__main__":
    main()
