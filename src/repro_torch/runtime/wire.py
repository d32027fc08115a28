"""The Wire: a contended serial mobile/cloud link over the core/wireless
link models.

Any object exposing ``uplink_seconds(nbytes)`` / ``uplink_energy_mj(nbytes)``
(``WirelessNetwork`` from the paper's Table III, or the TPU ``Interconnect``)
backs a :class:`Wire`; link models that also expose ``downlink_seconds`` /
``downlink_energy_mj`` get asymmetric downlink figures, otherwise the
downlink mirrors the uplink.  Each direction is a FIFO pipe: when several
edge devices share it, a transfer waits until the link drains — that
queueing delay is the contention term that only appears at the
request-stream level (JointDNN Sec. V observes the same effect on shared
cellular uplinks).  ``duplex="split"`` (the default, full-duplex radio)
gives each direction its own FIFO; ``duplex="shared"`` makes both
directions contend for one serial frontier (half-duplex).

The downlink carries sampled tokens back to the mobile: one batch of ids at
request completion for the cache-handoff decode transport, one id per
generation step for the streamed transport — which is what makes the
per-token RTT (uplink row + cloud turn + downlink id) a first-class
quantity here (:meth:`Wire.rtt_s`).

Goodput feedback is *windowed*: :meth:`observed_bytes_per_s` reports the
effective rate over the trailing ``window_s`` seconds, so a load transient
that saturated the link stops poisoning the controller's signal once it
drains (the lifetime totals stay in ``stats``/``down_stats`` for
telemetry).  In a multi-cell topology each cell owns its own Wire, so the
contention — and this feedback — is per cell.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple

from repro_torch.core.wireless import get_link
from repro_torch.runtime.tracing import NULL_TRACER


@dataclass
class LinkStats:
    bytes_sent: float = 0.0
    busy_s: float = 0.0               # time the link actually transmitted
    wait_s: float = 0.0               # total contention wait across transfers
    energy_mj: float = 0.0            # mobile radio energy (paper power model)
    n_transfers: int = 0


class Wire:
    """Serial FIFO link pair (uplink + downlink) shared by a fleet of edge
    devices.  ``stats`` accounts the uplink, ``down_stats`` the downlink."""

    def __init__(self, link_model, name: Optional[str] = None,
                 duplex: str = "split", window_s: float = 0.5):
        assert duplex in ("split", "shared"), duplex
        self.model = link_model
        self.name = name or getattr(link_model, "name", "link")
        self.duplex = duplex
        self.window_s = window_s
        self.free_at = 0.0                  # uplink frontier
        self.down_free_at = 0.0             # downlink frontier
        self.stats = LinkStats()
        self.down_stats = LinkStats()
        # trailing-window samples per direction: (done, nbytes, occupied_s)
        self._recent_up: Deque[Tuple[float, float, float]] = deque()
        self._recent_down: Deque[Tuple[float, float, float]] = deque()
        # flight recorder: the simulation swaps in a live tracer and a
        # topology-unique track prefix (wires of different cells can share
        # a link name)
        self.tracer = NULL_TRACER
        self.track_prefix = f"wire/{self.name}"

    @classmethod
    def named(cls, name: str, duplex: str = "split",
              window_s: float = 0.5) -> "Wire":
        return cls(get_link(name), name=name, duplex=duplex,
                   window_s=window_s)

    # ------------------------------------------------------------- faults
    def handover(self, network: str) -> None:
        """Swap the underlying link model mid-run (e.g. 3g → wifi).  Frames
        already admitted keep their old completion times (they were cut at
        the old rate); the goodput windows reset so the controller's next
        decision sees the new link, not a blend."""
        self.model = get_link(network)
        self.name = network
        self._recent_up.clear()
        self._recent_down.clear()

    def blackout(self, now: float, duration: float) -> None:
        """Push both frontiers past a dark window: transfers admitted during
        the blackout start after it lifts.  The fault layer separately
        cancels deliveries already in flight (``cancel_owner``) — those
        frames are lost, not delayed."""
        self.free_at = max(self.free_at, now) + duration
        self.down_free_at = max(self.down_free_at, now) + duration

    # ------------------------------------------------------------- durations
    def transfer_seconds(self, nbytes: float) -> float:
        return self.model.uplink_seconds(nbytes)

    def downlink_seconds(self, nbytes: float) -> float:
        f = getattr(self.model, "downlink_seconds", None)
        return f(nbytes) if f is not None else self.model.uplink_seconds(nbytes)

    def transfer_energy_mj(self, nbytes: float) -> float:
        return self.model.uplink_energy_mj(nbytes)

    def downlink_energy_mj(self, nbytes: float) -> float:
        f = getattr(self.model, "downlink_energy_mj", None)
        return f(nbytes) if f is not None \
            else self.model.uplink_energy_mj(nbytes)

    def rtt_s(self, up_bytes: float, down_bytes: float) -> float:
        """Nominal (contention-free) round trip: ship ``up_bytes`` up and
        ``down_bytes`` back — the streamed transport's per-token wire cost."""
        return self.transfer_seconds(up_bytes) + \
            self.downlink_seconds(down_bytes)

    # ------------------------------------------------------------- transfers
    def transfer(self, nbytes: float, now: float, *,
                 uid: Optional[int] = None,
                 tag: str = "xfer") -> Tuple[float, float]:
        """Enqueue ``nbytes`` on the uplink at virtual time ``now``; returns
        ``(start, done)`` — ``start > now`` means the link was busy.  ``uid``
        and ``tag`` only label the trace span (request id; ``prefill`` /
        ``handoff`` / ``row`` ...)."""
        start = max(now, self.free_at)
        if self.duplex == "shared":
            start = max(start, self.down_free_at)
        dur = self.transfer_seconds(nbytes)
        done = start + dur
        self.free_at = done
        if self.duplex == "shared":
            self.down_free_at = done
        self._account(self.stats, self._recent_up, done, nbytes, dur,
                      start - now, self.transfer_energy_mj(nbytes))
        self._span(f"{self.track_prefix}/up", tag, start, done, uid, nbytes,
                   start - now)
        return start, done

    def transfer_down(self, nbytes: float, now: float, *,
                      uid: Optional[int] = None,
                      tag: str = "xfer") -> Tuple[float, float]:
        """Enqueue ``nbytes`` on the downlink at virtual time ``now``."""
        start = max(now, self.down_free_at)
        if self.duplex == "shared":
            start = max(start, self.free_at)
        dur = self.downlink_seconds(nbytes)
        done = start + dur
        self.down_free_at = done
        if self.duplex == "shared":
            self.free_at = done
        self._account(self.down_stats, self._recent_down, done, nbytes, dur,
                      start - now, self.downlink_energy_mj(nbytes))
        self._span(f"{self.track_prefix}/down", tag, start, done, uid, nbytes,
                   start - now)
        return start, done

    def _span(self, track: str, tag: str, start: float, done: float,
              uid: Optional[int], nbytes: float, wait: float) -> None:
        if not self.tracer.enabled:
            return
        args = {"bytes": nbytes, "wait_ms": wait * 1e3}
        if uid is not None:
            args["uid"] = uid
        self.tracer.complete(track, tag, start, done, cat="wire", args=args)

    @staticmethod
    def _account(s: LinkStats, recent: Deque[Tuple[float, float, float]],
                 done: float, nbytes: float, dur: float, wait: float,
                 energy: float) -> None:
        s.bytes_sent += nbytes
        s.busy_s += dur
        s.wait_s += wait
        s.energy_mj += energy
        s.n_transfers += 1
        recent.append((done, nbytes, dur + wait))

    # ------------------------------------------------------------- occupancy
    def up_backlog_s(self, now: float) -> float:
        """Seconds of queued uplink work ahead of a transfer enqueued *now*
        (0 = idle link) — the metrics sampler's wire-occupancy gauge."""
        return max(0.0, self.free_at - now)

    def down_backlog_s(self, now: float) -> float:
        return max(0.0, self.down_free_at - now)

    # ------------------------------------------------------------- goodput
    def nominal_bytes_per_s(self) -> float:
        return 1.0 / max(self.model.uplink_seconds(1.0), 1e-30)

    def nominal_down_bytes_per_s(self) -> float:
        return 1.0 / max(self.downlink_seconds(1.0), 1e-30)

    def observed_bytes_per_s(self, now: float) -> float:
        """Effective per-request uplink goodput including contention waits
        over the trailing ``window_s`` — what a device experiences *right
        now*, and what the adaptive controller feeds back into the selection
        phase.  A quiet link (no transfers in the window) reads nominal: a
        cleared transient no longer drags a lifetime average behind it."""
        return self._observed(self._recent_up, self.nominal_bytes_per_s(),
                              now)

    def observed_down_bytes_per_s(self, now: float) -> float:
        return self._observed(self._recent_down,
                              self.nominal_down_bytes_per_s(), now)

    def _observed(self, recent: Deque[Tuple[float, float, float]],
                  nominal: float, now: float) -> float:
        horizon = now - self.window_s
        while recent and recent[0][0] < horizon:
            recent.popleft()
        nbytes = sum(b for _, b, _ in recent)
        occupied = sum(o for _, _, o in recent)
        if not recent or occupied <= 0:
            return nominal
        return nbytes / occupied
