"""Algorithm 1 from the paper: the three-phase DNN partitioning algorithm.

  Training phase  — for each candidate split P_j, find (linear search) the
                    minimal D_r whose end-to-end-trained butterfly model
                    reaches the accuracy target.
  Profiling phase — per split: edge latency/power, uplink time F_j/NB,
                    cloud latency (under load levels K_mobile, K_cloud).
  Selection phase — argmin end-to-end latency or mobile energy.

The training phase takes a callback (train at small scale, or the paper's
published Fig. 7 results); profiling uses core/profiler roofline models or
the paper's published Table IV; selection is exact.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.profiler import HardwareProfile, SplitProfile, profile_split
from repro_torch.core.wireless import NETWORKS, WirelessNetwork

# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------


@dataclass
class TrainingPhaseResult:
    split: int
    d_r: int
    accuracy: float


def training_phase(
    candidate_splits: Sequence[int],
    channel_sizes: Dict[int, int],
    train_and_eval: Callable[[int, int], float],
    accuracy_target: float,
    max_loss: float = 0.02,
    dr_schedule: Optional[Sequence[int]] = None,
) -> List[TrainingPhaseResult]:
    """Paper Algorithm 1 lines 15-25: linear search of minimal D_r per split.

    ``train_and_eval(split, d_r) -> accuracy``; ``channel_sizes[j]`` is C_{P_j}
    (the upper bound of the search).  ``dr_schedule`` optionally thins the
    linear search (the paper sweeps 1..C; we allow 1,2,3,... subsets for
    small-scale runs)."""
    results = []
    floor = accuracy_target - max_loss
    for j in candidate_splits:
        found = None
        grid = dr_schedule if dr_schedule is not None else range(1, channel_sizes[j] + 1)
        for d_r in grid:
            if d_r > channel_sizes[j]:
                break
            acc = train_and_eval(j, d_r)
            if acc >= floor:
                found = TrainingPhaseResult(split=j, d_r=d_r, accuracy=acc)
                break
        if found is None:
            found = TrainingPhaseResult(split=j, d_r=channel_sizes[j],
                                        accuracy=float("nan"))
        results.append(found)
    return results


# ---------------------------------------------------------------------------
# profiling phase
# ---------------------------------------------------------------------------


def profiling_phase(
    trained: Sequence[TrainingPhaseResult],
    split_costs: Callable[[int, int], tuple],
    edge: HardwareProfile,
    cloud: HardwareProfile,
    edge_load: float = 0.0,
    cloud_load: float = 0.0,
) -> List[SplitProfile]:
    """``split_costs(split, d_r) -> (edge_flops, edge_bytes, cloud_flops,
    cloud_bytes, wire_bytes)``."""
    profiles = []
    for t in trained:
        ef, eb, cf, cb, wb = split_costs(t.split, t.d_r)
        profiles.append(profile_split(
            t.split, t.d_r, edge_flops=ef, edge_bytes=eb, cloud_flops=cf,
            cloud_bytes=cb, wire_bytes=wb, edge=edge, cloud=cloud,
            edge_load=edge_load, cloud_load=cloud_load))
    return profiles


# ---------------------------------------------------------------------------
# selection phase
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Selection:
    split: int
    d_r: int
    latency_s: float
    energy_mj: float
    objective: str
    network: str


def selection_phase(profiles: Sequence[SplitProfile],
                    network: WirelessNetwork,
                    objective: str = "latency") -> Selection:
    assert objective in ("latency", "energy")
    key = (lambda p: p.latency(network)) if objective == "latency" else \
        (lambda p: p.mobile_energy_mj(network))
    best = min(profiles, key=key)
    return Selection(split=best.split, d_r=best.d_r,
                     latency_s=best.latency(network),
                     energy_mj=best.mobile_energy_mj(network),
                     objective=objective, network=network.name)


def select_from_table(table: Dict[int, Dict[str, float]],
                      objective: str = "latency") -> int:
    """Selection phase over a published profile table (paper Table IV):
    {split: {latency_ms, energy_mj}} -> chosen split."""
    key = "latency_ms" if objective == "latency" else "energy_mj"
    return min(table, key=lambda j: table[j][key])


# ---------------------------------------------------------------------------
# end-to-end plan for a transformer arch on the pod mesh
# ---------------------------------------------------------------------------


def plan_transformer_split(cfg, seq: int, batch: int, *,
                           edge: HardwareProfile, cloud: HardwareProfile,
                           interconnect, d_r: int,
                           candidate_splits: Optional[Sequence[int]] = None,
                           objective: str = "latency",
                           edge_load: float = 0.0, cloud_load: float = 0.0):
    """Run profiling+selection for a transformer with the butterfly at each
    candidate layer boundary (training phase assumed done / d_r given).

    Returns (Selection-like dict, per-split profile rows)."""
    from repro_torch.core import costs
    from repro_torch.core.butterfly import butterfly_wire_bytes

    n = cfg.num_layers
    splits = list(candidate_splits) if candidate_splits else list(range(1, n))
    rows = []
    act_bytes = 2  # bf16 activations
    for j in splits:
        ef = costs.stack_flops(cfg, seq, 0, j) * batch
        ef += 2 * batch * seq * cfg.d_model * d_r            # reduction unit
        cf = costs.stack_flops(cfg, seq, j, n) * batch
        cf += 2 * batch * seq * d_r * cfg.d_model            # restoration
        cf += costs.embed_flops(cfg, seq) * batch
        eb = ef / max(cfg.d_model, 1)                        # rough bytes proxy
        cb = cf / max(cfg.d_model, 1)
        wire = butterfly_wire_bytes(batch, seq, d_r)
        t_edge = edge.latency_s(ef, eb) / max(1e-9, 1 - edge_load)
        t_cloud = cloud.latency_s(cf, cb) / max(1e-9, 1 - cloud_load)
        t_up = interconnect.uplink_seconds(wire)
        raw_wire = batch * seq * cfg.d_model * act_bytes
        rows.append({
            "split": j, "d_r": d_r, "edge_s": t_edge, "uplink_s": t_up,
            "cloud_s": t_cloud, "latency_s": t_edge + t_up + t_cloud,
            "wire_bytes": wire, "raw_bytes": raw_wire,
            "compression": raw_wire / wire,
            "energy_mj": t_edge * edge.compute_power_w * 1e3 +
                         interconnect.uplink_energy_mj(wire),
        })
    key = "latency_s" if objective == "latency" else "energy_mj"
    best = min(rows, key=lambda r: r[key])
    return best, rows


# ---------------------------------------------------------------------------
# online selection (paper Sec. III-C): re-run the selection phase at runtime
# against *observed* conditions — the split-serving runtime's control law
# ---------------------------------------------------------------------------


# Pluggable selection objectives: each maps the scored (split, transport)
# rows to the winning row.  Registered by name so runtime controllers (and
# the CLI's --objective flag) can pick them without the planner knowing who
# is asking; register_objective() admits project-specific policies.
SELECTION_OBJECTIVES: Dict[str, Callable] = {}


def register_objective(name: str, fn: Callable) -> None:
    """``fn(rows, *, slo_s=None) -> row`` over select_split_online's scored
    rows (each has latency_s / energy_mj / split / transport)."""
    SELECTION_OBJECTIVES[name] = fn


def _objective_latency(rows, *, slo_s=None):
    return min(rows, key=lambda r: r["latency_s"])


def _objective_energy(rows, *, slo_s=None):
    return min(rows, key=lambda r: r["energy_mj"])


def _objective_energy_under_slo(rows, *, slo_s=None):
    """Min mobile energy subject to predicted latency <= SLO.  When no
    candidate meets the SLO the best-effort fallback is the latency winner
    (the least-infeasible pick) rather than an arbitrary energy row."""
    assert slo_s is not None and slo_s > 0, \
        "objective 'energy_under_slo' needs an SLO (--slo-ms)"
    feasible = [r for r in rows if r["latency_s"] <= slo_s]
    if not feasible:
        return _objective_latency(rows)
    return min(feasible, key=lambda r: r["energy_mj"])


register_objective("latency", _objective_latency)
register_objective("energy", _objective_energy)
register_objective("energy_under_slo", _objective_energy_under_slo)


def resolve_objective(name: str) -> Callable:
    try:
        return SELECTION_OBJECTIVES[name]
    except KeyError:
        raise KeyError(f"unknown selection objective {name!r}; known: "
                       f"{sorted(SELECTION_OBJECTIVES)}") from None


def wire_mode_bytes(cfg, seq: int, d_r: int, wire_mode: str,
                    batch: int = 1) -> float:
    """Uplink payload per request for each wire ablation mode.

    "raw"     the boundary activation in model dtype (prior-work CI offload)
    "reduced" butterfly reduction, no wire quantization
    "int8"    the paper: int8 codes + per-row f32 scales
    "int4"    beyond-paper: nibble-packed codes (2/byte) + f32 scales
    "entropy" int8 codes rANS-coded against the learned per-channel prior
              (predicted at the trained-prior nominal rate; the runtime
              charges *actual* coded bytes when real codes exist), raw f32
              scales, plus the per-payload stream overhead.  Never predicted
              worse than int8: the edge ships raw codes when coding would
              expand the payload — which is why single decode rows stay
              fixed-rate int8 (the ~12 B/lane state flush dwarfs them).
    """
    from repro_torch.core import wire_codec
    from repro_torch.core.quantization import wire_bytes

    act_bytes = 2 if cfg.dtype == "bfloat16" else 4
    if wire_mode == "raw":
        return float(batch * seq * cfg.d_model * act_bytes)
    if wire_mode == "reduced":
        return float(batch * seq * d_r * act_bytes)
    if wire_mode == "int8":
        return float(wire_bytes((batch, seq, d_r), 8))
    if wire_mode == "int4":
        return float(wire_bytes((batch, seq, d_r), 4))
    if wire_mode == "entropy":
        n = batch * seq * d_r
        coded = wire_codec.predicted_code_bytes(n) \
            + wire_codec.payload_overhead_bytes(d_r)
        return float(min(coded, n) + batch * seq * 4)
    raise ValueError(f"unknown wire_mode {wire_mode!r}")


def select_split_online(cfg, seq: int, d_r: int, *,
                        candidate_splits: Sequence[int],
                        edge: HardwareProfile, cloud: HardwareProfile,
                        link_bytes_per_s: float, cloud_load: float = 0.0,
                        edge_load: float = 0.0, wire_mode: str = "int8",
                        link_energy_mj_per_byte: float = 0.0,
                        handoff_bytes_per_layer: float = 0.0,
                        objective: str = "latency",
                        transports: Sequence[str] = ("cache_handoff",),
                        new_tokens: int = 1,
                        downlink_bytes_per_s: Optional[float] = None,
                        downlink_energy_mj_per_byte: float = 0.0,
                        edge_mp: int = 1, cloud_mp: int = 1,
                        slo_s: Optional[float] = None,
                        pipeline_depth: int = 1):
    """One online iteration of Algorithm 1's selection phase.

    Unlike :func:`plan_transformer_split` this takes the *measured* state the
    runtime's controller observes — effective uplink throughput (nominal
    bandwidth derated by contention) and current server load — and scores
    every hosted partition point against it.  When ``transports`` names more
    than one decode transport, every (split, transport) pair is scored, so
    the controller picks the transport alongside the split:

    * ``cache_handoff`` pays ``handoff_bytes_per_layer`` split-proportional
      extra uplink (the stage-0 KV handoff for multi-token requests), then
      decodes cloud-side and ships all ``new_tokens`` sampled ids down once.
    * ``streamed`` ships only the prefill codes, then pays one wire row up,
      one cloud turn and one id down per generated token — an RTT x tokens
      term against the observed link rates, with uplink bytes flat in the
      prompt length.  With ``pipeline_depth >= 2`` (the decode-pipelined
      mesh: >= 2 in-flight microbatches rotating through the (pod, model)
      pipeline) the per-token cadence is the *slowest stage* — max(edge
      step, wire row + id, cloud step) — instead of their sum, because the
      edge computes microbatch k+1 while the cloud serves microbatch k.
    * ``progressive`` is ``streamed`` with a bitplane-split prefill upload:
      the coarse chunk (high-order planes + scales) ships first, cloud
      prefill starts on it, and the refinement tail of the upload overlaps
      that prefill — TTFT pays max(refine, cloud prefill) instead of their
      sum.  Decode then streams rows exactly like ``streamed``.

    ``objective`` names a registered selection objective
    (:data:`SELECTION_OBJECTIVES`): ``latency``, ``energy``, or
    ``energy_under_slo`` (min energy s.t. predicted latency <= ``slo_s``).

    Returns ``(best_row, rows)``; rows carry a ``transport`` field on top of
    the offline planner's schema."""
    from repro_torch.core import costs

    pick = resolve_objective(objective)
    n = cfg.num_layers
    T = max(int(new_tokens), 1)
    base_wire = wire_mode_bytes(cfg, seq, d_r, wire_mode)
    row_bytes = wire_mode_bytes(cfg, 1, d_r, wire_mode)
    down_bps = downlink_bytes_per_s if downlink_bytes_per_s else float("inf")
    token_down_s = costs.TOKEN_BYTES / down_bps
    link_bps = max(link_bytes_per_s, 1e-9)
    rows = []
    for j in candidate_splits:
        assert 0 < j < n, f"split {j} out of range for {n} layers"
        ef = costs.stack_flops(cfg, seq, 0, j)
        ef += 2 * seq * cfg.d_model * d_r               # reduction unit
        cf = costs.stack_flops(cfg, seq, j, n)
        cf += 2 * seq * d_r * cfg.d_model               # restoration
        cf += costs.embed_flops(cfg, seq)
        eb = ef / max(cfg.d_model, 1)
        cb = cf / max(cfg.d_model, 1)
        # model-parallel stages: each half's compute divides by its degree,
        # matching what the runtime's CostModel charges (DESIGN.md sec. 11)
        ef, eb = costs.model_parallel_share((ef, eb), edge_mp)
        cf, cb = costs.model_parallel_share((cf, cb), cloud_mp)
        t_edge = edge.latency_s(ef, eb) / max(1e-9, 1 - edge_load)
        t_cloud = cloud.latency_s(cf, cb) / max(1e-9, 1 - cloud_load)
        esf, esb = costs.model_parallel_share(
            costs.edge_decode_step_cost(cfg, j, d_r), edge_mp)
        csf, csb = costs.model_parallel_share(
            costs.cloud_decode_step_cost(cfg, j, d_r), cloud_mp)
        t_edge_step = edge.latency_s(esf, esb) / max(1e-9, 1 - edge_load)
        t_cloud_step = cloud.latency_s(csf, csb) / max(1e-9, 1 - cloud_load)
        # a handoff decode turn runs the FULL hosted model cloud-side (the
        # engine's fused edge+wire+cloud step) — split-invariant, and what
        # the runtime's CostModel.decode_step_s actually charges
        hf, hb = costs.model_parallel_share(
            costs.full_decode_step_cost(cfg), cloud_mp)
        t_handoff_step = cloud.latency_s(hf, hb) / max(1e-9, 1 - cloud_load)
        down_bytes = T * costs.TOKEN_BYTES
        for tp in transports:
            if tp == "cache_handoff":
                wire = base_wire + j * handoff_bytes_per_layer
                t_up = wire / link_bps
                edge_total = t_edge
                lat = t_edge + t_up + t_cloud + \
                    (T - 1) * t_handoff_step + down_bytes / down_bps
            elif tp == "streamed":
                wire = base_wire + (T - 1) * row_bytes
                t_up = base_wire / link_bps
                rtt = t_edge_step + row_bytes / link_bps + t_cloud_step + \
                    token_down_s
                if pipeline_depth >= 2:
                    # pipelined decode: stages overlap across microbatches,
                    # so steady state ticks at the slowest stage's rate
                    cadence = max(t_edge_step, t_cloud_step,
                                  row_bytes / link_bps + token_down_s)
                else:
                    cadence = rtt
                edge_total = t_edge + (T - 1) * t_edge_step
                lat = t_edge + t_up + t_cloud + token_down_s + \
                    (T - 1) * cadence
            elif tp == "progressive":
                from repro_torch.core import wire_codec
                scale_bytes = seq * 4
                code_bytes = max(int(base_wire) - scale_bytes, 0)
                coarse, refine = wire_codec.split_coarse_refine(
                    code_bytes, scale_bytes)
                wire = float(coarse + refine) + (T - 1) * row_bytes
                t_up = (coarse + refine) / link_bps
                rtt = t_edge_step + row_bytes / link_bps + t_cloud_step + \
                    token_down_s
                if pipeline_depth >= 2:
                    cadence = max(t_edge_step, t_cloud_step,
                                  row_bytes / link_bps + token_down_s)
                else:
                    cadence = rtt
                edge_total = t_edge + (T - 1) * t_edge_step
                # cloud prefill overlaps the refinement tail of the upload;
                # the first token waits for whichever finishes last
                lat = t_edge + coarse / link_bps + \
                    max(refine / link_bps, t_cloud) + token_down_s + \
                    (T - 1) * cadence
            else:
                raise ValueError(f"unknown transport {tp!r}")
            rows.append({
                "split": j, "transport": tp, "d_r": d_r,
                "edge_s": edge_total, "uplink_s": t_up,
                "cloud_s": t_cloud, "latency_s": lat,
                "wire_bytes": wire, "downlink_bytes": down_bytes,
                "energy_mj": edge_total * edge.compute_power_w * 1e3 +
                             wire * link_energy_mj_per_byte +
                             down_bytes * downlink_energy_mj_per_byte,
            })
    best = pick(rows, slo_s=slo_s)
    return best, rows
