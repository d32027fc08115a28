"""Wireless network + power models from the paper (Tables III), used by the
faithful reproduction benchmarks, plus the TPU interconnect profile used by
the deployment planner.

Paper's uplink power model (Huang et al., MobiSys'12): P_u = alpha_u * t_u + beta
with t_u the uplink throughput in Mbps and P in mW.  The same source gives the
downlink coefficients (P_d = alpha_d * t_d + beta), which the split runtime's
streamed decode transport uses to charge the mobile for receiving one sampled
token per generation step.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WirelessNetwork:
    name: str
    uplink_mbps: float
    alpha_mw_per_mbps: float
    beta_mw: float
    # downlink side; 0.0 falls back to the uplink figures (symmetric link)
    downlink_mbps: float = 0.0
    alpha_d_mw_per_mbps: float = 0.0

    def uplink_seconds(self, nbytes: float) -> float:
        return nbytes * 8.0 / (self.uplink_mbps * 1e6)

    def uplink_power_mw(self) -> float:
        return self.alpha_mw_per_mbps * self.uplink_mbps + self.beta_mw

    def uplink_energy_mj(self, nbytes: float) -> float:
        return self.uplink_seconds(nbytes) * 1e3 * self.uplink_power_mw() * 1e-3

    @property
    def _down_mbps(self) -> float:
        return self.downlink_mbps if self.downlink_mbps > 0 else self.uplink_mbps

    def downlink_seconds(self, nbytes: float) -> float:
        return nbytes * 8.0 / (self._down_mbps * 1e6)

    def downlink_power_mw(self) -> float:
        alpha = self.alpha_d_mw_per_mbps if self.alpha_d_mw_per_mbps > 0 \
            else self.alpha_mw_per_mbps
        return alpha * self._down_mbps + self.beta_mw

    def downlink_energy_mj(self, nbytes: float) -> float:
        return self.downlink_seconds(nbytes) * 1e3 * \
            self.downlink_power_mw() * 1e-3


# Table III (average US 3G/4G/Wi-Fi, opensignal/speedtest 2017); downlink
# throughput from the same surveys, alpha_d from Huang et al. MobiSys'12
NETWORKS = {
    "3g": WirelessNetwork("3g", 1.1, 868.98, 817.88,
                          downlink_mbps=3.15, alpha_d_mw_per_mbps=122.12),
    "4g": WirelessNetwork("4g", 5.85, 438.39, 1288.04,
                          downlink_mbps=16.31, alpha_d_mw_per_mbps=51.97),
    "wifi": WirelessNetwork("wifi", 18.88, 283.17, 132.86,
                            downlink_mbps=54.97, alpha_d_mw_per_mbps=137.01),
}


@dataclass(frozen=True)
class Interconnect:
    """TPU-deployment analogue of the wireless link: the slow boundary the
    butterfly compresses.  bytes/s and an energy proxy (pJ/byte).
    Symmetric: downlink == uplink."""
    name: str
    bytes_per_s: float
    pj_per_byte: float = 10.0

    def uplink_seconds(self, nbytes: float) -> float:
        return nbytes / self.bytes_per_s

    def uplink_energy_mj(self, nbytes: float) -> float:
        return nbytes * self.pj_per_byte * 1e-9

    def downlink_seconds(self, nbytes: float) -> float:
        return self.uplink_seconds(nbytes)

    def downlink_energy_mj(self, nbytes: float) -> float:
        return self.uplink_energy_mj(nbytes)


# inter-pod boundary: ~1 ICI link worth of bandwidth per device pair crossing
# pods (DCN-class in real deployments; we use the assignment's 50 GB/s/link).
INTER_POD = Interconnect("inter_pod", 50e9)
INTRA_POD = Interconnect("intra_pod_ici", 50e9 * 4)   # 4 links per chip


def get_link(name: str):
    """Uplink model by name — wireless (paper Table III) or interconnect.

    Anything with ``uplink_seconds``/``uplink_energy_mj`` works as a link
    model for the split-serving runtime (runtime/wire.py)."""
    if name in NETWORKS:
        return NETWORKS[name]
    if name == INTER_POD.name:
        return INTER_POD
    if name == INTRA_POD.name:
        return INTRA_POD
    known = sorted(NETWORKS) + [INTER_POD.name, INTRA_POD.name]
    raise KeyError(f"unknown link {name!r}; known: {known}")
