"""Paper Sec. III-C: the partition point adapts to server load at runtime
(the port's counterpart of ``examples/load_adaptation.py``; its output is
that script's, byte for byte).

The mobile pings the server, gets its load level K_cloud, and re-runs
Algorithm 1's selection phase over the M hosted partitioned models —
congestion pushes the split deeper (more work stays on the edge) while still
offloading less data than the raw input.

This script sweeps cloud load 0% -> 97.5% for ResNet-50 (the paper's model,
with its published minimal D_r per split) and for a transformer (qwen3-8b on
the TPU edge/cloud profile), printing the selected split per (network, load),
then runs the *closed-loop* version: the split-serving runtime's adaptive
controller re-running the selection phase online against a live load ramp
(repro_torch/runtime — the one-shot sweep made continuous).

Every figure it prints comes from the planner's and the simulator's
models, not from a device: the ResNet sweep prices the paper's Jetson TX2
edge and GTX 1080 Ti cloud, the transformer sweep prices qwen3-8b on the
planner's TPU v5e profile (a simulated figure, not a measurement of this
port), and the runtimes run on a virtual clock with ``numerics=False``.
It touches no device.

Run:  PYTHONPATH=src python -m repro_torch.examples.load_adaptation
"""
from repro_torch.configs import get_config
from repro_torch.configs.resnet50 import PAPER_MIN_DR, resnet50
from repro_torch.core import costs
from repro_torch.core.planner import (TrainingPhaseResult,
                                      plan_transformer_split, profiling_phase,
                                      selection_phase)
from repro_torch.core.profiler import GTX_1080TI, JETSON_TX2, TPU_V5E
from repro_torch.core.wireless import INTER_POD, NETWORKS

LOADS = [0.0, 0.5, 0.9, 0.975]


def resnet_sweep():
    cfg = resnet50()
    trained = [TrainingPhaseResult(s, PAPER_MIN_DR[s], 0.74)
               for s in range(1, 17)]

    def split_costs(split, d_r):
        ef, cf, wire = costs.resnet_split_flops(cfg, split, d_r)
        return ef, ef / 10, cf, cf / 10, wire

    print("ResNet-50 (paper's model), selected split vs cloud load:")
    print(f"  {'load':>6s} " + " ".join(f"{n:>6s}" for n in NETWORKS))
    for load in LOADS:
        profiles = profiling_phase(trained, split_costs, JETSON_TX2,
                                   GTX_1080TI, cloud_load=load)
        row = [selection_phase(profiles, net, "latency").split
               for net in NETWORKS.values()]
        print(f"  {load:6.1%} " + " ".join(f"RB{r:<4d}" for r in row))
    print("  (congestion pushes the split deeper, exactly Sec III-C)\n")


def transformer_sweep():
    cfg = get_config("qwen3-8b")
    print("qwen3-8b on the pod boundary (edge pod <-> cloud pod, d_r=256):")
    print(f"  {'load':>6s} {'split':>6s} {'latency':>10s} {'wire':>10s} "
          f"{'compression':>12s}")
    for load in LOADS:
        best, _ = plan_transformer_split(
            cfg, seq=2048, batch=8, edge=TPU_V5E, cloud=TPU_V5E,
            interconnect=INTER_POD, d_r=256,
            candidate_splits=list(range(1, cfg.num_layers)),
            cloud_load=load)
        print(f"  {load:6.1%} {best['split']:>6d} "
              f"{best['latency_s']*1e3:9.2f}ms {best['wire_bytes']/1e6:9.2f}MB "
              f"{best['compression']:11.1f}x")


def runtime_closed_loop():
    """Sec. III-C as a running system: Poisson traffic, a background load
    ramp, and the controller moving the split between arrivals."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.profiler import JETSON_TX2
    from repro_torch.runtime.simulator import SimConfig, Simulation, ramp_load

    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=4)
    sc = SimConfig(cfg=cfg, network="3g", num_devices=4, num_requests=64,
                   arrival_rate=40.0, prompt_len=32, max_new_tokens=1,
                   d_r=16, adapt=True, control_interval_s=0.02,
                   cloud=JETSON_TX2.scaled(10, "cloud_slice"),
                   background_load=ramp_load(0.0, 0.25, 0.0, 0.97),
                   numerics=False, metrics=True, metrics_interval_s=0.05)
    sim = Simulation(sc)
    tel = sim.run()
    print("\nclosed-loop runtime (4-layer qwen3, cloud = 10x edge, "
          "load ramp 0 -> 97%):")
    print(f"  {'t':>7s} {'load':>7s} {'split':>6s}")
    last = None
    for d in tel.decisions:
        if d.new_split != last:
            print(f"  {d.t:6.2f}s {d.cloud_load:7.1%} {d.new_split:>6d}")
            last = d.new_split
    # the same ramp seen through the metrics sampler (SimConfig(metrics=True)):
    # queue depth and uplink goodput around the moment the controller moves
    wire_key = next(iter(sim.wires))
    print(f"  metrics timeline ({len(sim.sampler.rows)} samples @ "
          f"{sc.metrics_interval_s*1e3:.0f}ms):")
    print(f"  {'t':>7s} {'load':>7s} {'queue':>6s} {'in_flight':>9s} "
          f"{'goodput':>12s}")
    cell = sim.cells[0].name
    for row in sim.sampler.rows:
        print(f"  {row['t']:6.2f}s {row['cloud/load']:7.1%} "
              f"{row[f'cell/{cell}/queue_depth']:6.0f} "
              f"{row[f'cell/{cell}/in_flight']:9.0f} "
              f"{row[f'wire/{wire_key}/up_goodput_bps']/1e3:9.1f} kB/s")
    s = tel.summary()
    print(f"  {s['n_requests']:.0f} requests, latency p50 "
          f"{s['latency_p50_ms']:.2f} ms, p99 {s['latency_p99_ms']:.2f} ms "
          "(the controller holds RB-shallow until congestion makes the "
          "derated cloud slower than the edge, then goes deep)")


def topology_closed_loop():
    """Multi-cell topologies (DESIGN.md section 12): heterogeneous fleets on
    per-cell radios, per-cell controllers, one congested cloud — the cells
    settle on different (split, transport) pairs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.runtime.simulator import (SimConfig, Simulation,
                                               parse_topology)

    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=4)
    sc = SimConfig(cfg=cfg, topology=parse_topology("3g:4xjetson,wifi:4xphone"),
                   num_requests=48, prompt_len=64, max_new_tokens=8, d_r=16,
                   adapt=True, transport="auto", control_interval_s=0.02,
                   background_load=lambda t: 0.95, numerics=False)
    sim = Simulation(sc)
    tel = sim.run()
    print("\nmulti-cell topology (jetson gateways on 3g + phones on wifi, "
          "cloud at 95% load):")
    per_cell = tel.cell_summary()
    for cell in sim.cells:
        d = [d for d in tel.decisions if d.cell == cell.name][-1]
        row = per_cell[cell.name]
        print(f"  [{cell.name:8s}] split={d.new_split} {d.transport:13s} "
              f"p50 {row['latency_p50_ms']:7.2f} ms  "
              f"energy {row['mean_mobile_energy_mj']:5.1f} mJ")
    f = tel.fairness()
    print(f"  fairness: max/min {f['max_min_latency_ratio']:.2f}x, "
          f"Jain {f['jain_index']:.3f} "
          "(per-cell controllers diverge on their own conditions)")


if __name__ == "__main__":
    resnet_sweep()
    transformer_sweep()
    runtime_closed_loop()
    topology_closed_loop()
