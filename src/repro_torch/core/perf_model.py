"""LogP-inspired NIC-counter performance model — paper §2.4.

The model predicts the time between a PUT/GET command reaching the sender's
NIC and the last flit arriving at the receiver's NIC, **from NIC counters
only** (no host-side delays), which is the property §3.3 of the paper needs.

Quantities (paper notation):
    L    packet latency in NIC cycles (counter: cumulative latency / packets)
    s    mean stall cycles a ready-to-forward flit waits (counter: stalled
         cycles / request flits)
    k    flits per packet (5 for PUT: 1 header + 4 payload; 1 for GET)
    f    flits of the whole application message
    p    packets of the whole application message (1 per 64B)

Eq. (1):  T_msg = L/2 + f*(s+1)
Eq. (2):  T_msg ~= (p+512)/1024 * L + f*(s+1)
          (Aries NICs allow 1024 outstanding packets; one latency stall every
          1024 packets in the best case, plus the initial L/2 ~ averaged into
          the (p+512)/1024 coefficient.)

The same two-term structure is reused for the TPU adaptation: L ↦ phase/hop
latency of a collective schedule, f*(s+1) ↦ serialization time inflated by
the observed occupancy factor. See repro/collectives/selector.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# --- Aries constants (paper §2.1/§2.4) -------------------------------------
PACKET_PAYLOAD_BYTES = 64     # one request packet per 64 bytes
PUT_FLITS_PER_PACKET = 5      # 1 header + up to 4 payload flits
GET_FLITS_PER_PACKET = 1      # request carries no payload
MAX_OUTSTANDING_PACKETS = 1024
NIC_CLOCK_GHZ = 1.0           # cycle<->ns conversion used by counters


@dataclass(frozen=True)
class MessageShape:
    """Flit/packet decomposition of one application message."""

    size_bytes: int
    is_put: bool = True

    @property
    def packets(self) -> int:
        return max(1, math.ceil(self.size_bytes / PACKET_PAYLOAD_BYTES))

    @property
    def flits_per_packet(self) -> int:
        return PUT_FLITS_PER_PACKET if self.is_put else GET_FLITS_PER_PACKET

    @property
    def flits(self) -> int:
        # Last packet may carry fewer payload flits; the paper's model uses
        # the aggregate f, so account for the possibly-short tail packet.
        if not self.is_put:
            return self.packets
        full, rem = divmod(self.size_bytes, PACKET_PAYLOAD_BYTES)
        tail = 1 + math.ceil(rem / 16) if rem else 0  # 16B per payload flit
        return full * PUT_FLITS_PER_PACKET + tail


def flits_and_packets(size_bytes: int, is_put: bool = True) -> tuple[int, int]:
    m = MessageShape(size_bytes, is_put)
    return m.flits, m.packets


def flits_and_packets_vec(size_bytes, is_put: bool = True):
    """Vectorized MessageShape over an int array (same values as the
    scalar path; integer ceilings avoid float rounding)."""
    import numpy as np

    size = np.asarray(size_bytes, dtype=np.int64)
    packets = np.maximum(1, (size + PACKET_PAYLOAD_BYTES - 1)
                         // PACKET_PAYLOAD_BYTES)
    if not is_put:
        return packets, packets
    full, rem = np.divmod(size, PACKET_PAYLOAD_BYTES)
    tail = np.where(rem > 0, 1 + (rem + 15) // 16, 0)  # 16B per payload flit
    return full * PUT_FLITS_PER_PACKET + tail, packets


def transmission_cycles_eq1(latency_cycles: float, stalls_per_flit: float,
                            flits: int) -> float:
    """Eq. (1): T = L/2 + f*(s+1)."""
    return latency_cycles / 2.0 + flits * (stalls_per_flit + 1.0)


def transmission_cycles_eq2(latency_cycles: float, stalls_per_flit: float,
                            flits: int, packets: int) -> float:
    """Eq. (2): T ~= (p+512)/1024 * L + f*(s+1)."""
    window = (packets + MAX_OUTSTANDING_PACKETS // 2) / MAX_OUTSTANDING_PACKETS
    return window * latency_cycles + flits * (stalls_per_flit + 1.0)


def predict_transmission_cycles(size_bytes: int, latency_cycles: float,
                                stalls_per_flit: float, *,
                                is_put: bool = True) -> float:
    """Eq. (2) from a message size and the two NIC counters."""
    f, p = flits_and_packets(size_bytes, is_put)
    return transmission_cycles_eq2(latency_cycles, stalls_per_flit, f, p)


def flit_threshold(l_a: float, s_a: float, l_b: float, s_b: float,
                   packets: int) -> float:
    """Eq. (4): the flit count below which mode *b* (higher-bias / lower-
    latency) beats mode *a* (adaptive / lower-stall).

        f < (L_a - L_b) / (s_b - s_a) * (p+512)/1024

    Returns +inf when b dominates on both terms, -inf (well, 0-crossing)
    semantics are handled by the caller comparing f < threshold; if
    s_b <= s_a and L_b >= L_a the threshold is 0 (never switch)."""
    window = (packets + MAX_OUTSTANDING_PACKETS // 2) / MAX_OUTSTANDING_PACKETS
    dl = l_a - l_b
    ds = s_b - s_a
    if ds <= 0.0:
        # Outside Eq.(4)'s validity domain (the paper's setting is
        # s_b > s_a: the minimal-biased mode stalls more).  b dominates
        # when it is no worse on BOTH terms; otherwise the caller must
        # compare Eq.(3) directly (AppAwareRouter does).
        return math.inf if dl >= 0.0 else 0.0
    return dl / ds * window


@dataclass(frozen=True)
class AriesNICModel:
    """Bundles the model with a clock so callers can speak seconds."""

    clock_ghz: float = NIC_CLOCK_GHZ

    def cycles_to_us(self, cycles: float) -> float:
        return cycles / (self.clock_ghz * 1e3)

    def us_to_cycles(self, us: float) -> float:
        return us * self.clock_ghz * 1e3

    def predict_us(self, size_bytes: int, latency_us: float,
                   stalls_per_flit: float, *, is_put: bool = True) -> float:
        lat_cyc = self.us_to_cycles(latency_us)
        cyc = predict_transmission_cycles(
            size_bytes, lat_cyc, stalls_per_flit, is_put=is_put)
        return self.cycles_to_us(cyc)
