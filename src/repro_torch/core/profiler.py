"""Latency/energy profiling for the partitioning algorithm.

The paper measures wall-clock on a Jetson TX2 + GTX 1080 Ti (INA226 power
sensor).  This container has no such hardware, so profiles come from a
roofline cost model: t = max(flops / peak_flops, bytes / mem_bw), plus the
wireless (or interconnect) uplink term.  The paper's own published per-split
profile (Table IV) is also encoded so Algorithm 1's selection phase can be
validated against Table V exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.wireless import NETWORKS, WirelessNetwork


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops: float                 # peak FLOP/s at compute dtype
    mem_bw: float                # bytes/s
    compute_power_w: float = 0.0  # average power while computing (edge energy)

    def latency_s(self, flops: float, nbytes: float) -> float:
        return max(flops / self.flops, nbytes / self.mem_bw)

    def scaled(self, factor: float, name: Optional[str] = None) -> "HardwareProfile":
        """A platform ``factor``x this one (compute and bandwidth alike) —
        e.g. the cloud slice a single request sees on a shared server."""
        return HardwareProfile(name or f"{self.name}_x{factor:g}",
                               self.flops * factor, self.mem_bw * factor,
                               self.compute_power_w)


# paper platforms (Tables I/II): TX2 ~1.33 TFLOP/s FP16, 59.7 GB/s;
# GTX 1080 Ti ~ 30x the TX2 per the paper's own characterization.
JETSON_TX2 = HardwareProfile("jetson_tx2", 1.33e12, 59.7e9, compute_power_w=7.5)
GTX_1080TI = HardwareProfile("gtx_1080ti", 1.33e12 * 30, 484e9, compute_power_w=250.0)
# TPU v5e target (assignment constants)
TPU_V5E = HardwareProfile("tpu_v5e", 197e12, 819e9, compute_power_w=170.0)
# phone-class NPU (mid-range smartphone DSP/NPU slice: ~1/4 of a TX2 at a
# fraction of the power budget) — the weak end of a heterogeneous fleet
PHONE_NPU = HardwareProfile("phone_npu", 0.35e12, 25.6e9, compute_power_w=2.5)

# edge-device classes a multi-cell topology's fleets draw from (CellSpec
# names a class per cell; runtime_sim's --topology grammar uses the keys)
DEVICE_CLASSES: Dict[str, HardwareProfile] = {
    "phone": PHONE_NPU,
    "jetson": JETSON_TX2,
}


def get_device_class(name) -> HardwareProfile:
    """Resolve a device-class name (or pass a HardwareProfile through)."""
    if isinstance(name, HardwareProfile):
        return name
    try:
        return DEVICE_CLASSES[name]
    except KeyError:
        raise KeyError(f"unknown device class {name!r}; known: "
                       f"{sorted(DEVICE_CLASSES)}") from None


@dataclass(frozen=True)
class SplitProfile:
    """Per-candidate-split measurements: the planner's profiling-phase row."""
    split: int                   # partition point id (e.g. residual block)
    d_r: int                     # minimal bottleneck width for the split
    edge_seconds: float          # TM_j
    edge_power_w: float          # PM_j
    cloud_seconds: float         # TC_j
    wire_bytes: int              # F_{P_j} after reduction+quant

    def latency(self, network: WirelessNetwork) -> float:
        return self.edge_seconds + network.uplink_seconds(self.wire_bytes) + \
            self.cloud_seconds

    def mobile_energy_mj(self, network: WirelessNetwork) -> float:
        compute = self.edge_seconds * self.edge_power_w * 1e3
        return compute + network.uplink_energy_mj(self.wire_bytes)


def profile_split(split: int, d_r: int, *, edge_flops: float, edge_bytes: float,
                  cloud_flops: float, cloud_bytes: float, wire_bytes: int,
                  edge: HardwareProfile, cloud: HardwareProfile,
                  edge_load: float = 0.0, cloud_load: float = 0.0) -> SplitProfile:
    """Roofline-model profiling of one candidate split.  ``*_load`` in [0,1)
    derates the platform (the paper's K_mobile / K_cloud congestion knobs)."""
    t_edge = edge.latency_s(edge_flops, edge_bytes) / max(1e-9, 1.0 - edge_load)
    t_cloud = cloud.latency_s(cloud_flops, cloud_bytes) / max(1e-9, 1.0 - cloud_load)
    return SplitProfile(split=split, d_r=d_r, edge_seconds=t_edge,
                        edge_power_w=edge.compute_power_w,
                        cloud_seconds=t_cloud, wire_bytes=wire_bytes)


# ---------------------------------------------------------------------------
# The paper's own measured profile (Table IV + Table V rows), for validating
# the selection phase against published numbers.
# ---------------------------------------------------------------------------

PAPER_TABLE4 = {
    # rb: (offloaded_kb, lat3g_ms, en3g_mj, lat4g_ms, en4g_mj, latwifi_ms, enwifi_mj)
    1: (3.1, 23.7, 21.6, 5.2, 9.8, 2.4, 4.8),
    2: (3.1, 24.7, 22.4, 6.1, 11.6, 3.3, 6.8),
    3: (3.1, 25.6, 23.3, 6.9, 13.2, 4.1, 8.7),
    4: (1.6, 15.0, 13.7, 5.8, 10.9, 4.3, 9.1),
    5: (1.6, 15.9, 14.4, 6.7, 12.7, 5.2, 11.2),
    6: (1.6, 16.8, 15.4, 7.6, 14.3, 6.1, 13.1),
    7: (1.6, 17.7, 16.2, 8.5, 15.9, 7.0, 14.9),
    8: (1.0, 14.3, 13.1, 8.6, 12.6, 7.7, 12.1),
    9: (1.0, 15.4, 13.9, 9.6, 13.1, 8.6, 12.7),
    10: (1.0, 16.2, 14.7, 10.5, 14.3, 9.4, 13.9),
    11: (1.0, 17.1, 15.5, 11.2, 15.2, 10.7, 14.8),
    12: (1.0, 17.9, 16.4, 12.1, 16.3, 11.1, 15.5),
    13: (1.0, 18.8, 17.2, 13.1, 17.0, 12.2, 16.3),
    14: (0.5, 16.1, 14.8, 13.1, 14.4, 12.9, 14.1),
    15: (0.5, 17.1, 15.7, 14.2, 16.8, 13.8, 16.1),
    16: (0.5, 17.9, 16.6, 15.1, 17.2, 14.7, 16.6),
}

PAPER_CLOUD_ONLY = {"3g": (1101.0, 1047.4), "4g": (208.4, 528.3),
                    "wifi": (98.1, 342.1)}   # (latency ms, energy mJ)
PAPER_MOBILE_ONLY = (15.7, 20.5)
PAPER_INPUT_BYTES = 150528                    # 224*224*3


def paper_profiles() -> Dict[str, Dict[int, Dict[str, float]]]:
    """{network: {rb: {latency_ms, energy_mj, wire_bytes}}} from Table IV."""
    out: Dict[str, Dict[int, Dict[str, float]]] = {"3g": {}, "4g": {}, "wifi": {}}
    for rb, (kb, l3, e3, l4, e4, lw, ew) in PAPER_TABLE4.items():
        out["3g"][rb] = {"latency_ms": l3, "energy_mj": e3, "wire_bytes": kb * 1e3}
        out["4g"][rb] = {"latency_ms": l4, "energy_mj": e4, "wire_bytes": kb * 1e3}
        out["wifi"][rb] = {"latency_ms": lw, "energy_mj": ew, "wire_bytes": kb * 1e3}
    return out
