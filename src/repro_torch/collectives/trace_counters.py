"""Trace-backed NIC counters: the card's counterpart of Aries counters.

Counterpart of ``repro/collectives/hlo_counters.py`` (``HloCounterBackend``),
fed by the costs of a traced step (:mod:`repro_torch.analysis.
trace_costs`) where the reference reads a compiled module's HLO.  For one
executed step it synthesizes the paper's four counters:

  request flits            <- wire bytes / 64B "packets" * 5 flits (PUT)
  request packets          <- wire bytes / 64B
  stalled cycles           <- serialization excess on the bottleneck link
                              class: cycles the NIC would wait because the
                              offered collective bytes exceed what the link
                              moves in the step's compute window
  cumulative latency (us)  <- per-collective phase latency (hop count x
                              per-hop latency) summed over executions

This gives Algorithm 1 the same (L, s) observables it reads on Aries,
derived from the traced step instead of hardware registers.  The link
figures are ``hw``'s, the datasheet ``H100`` by default.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.roofline import H100, HwSpec, classify_collective
from repro_torch.core.counters import InMemoryBackend, NICCounters

#: per-hop latency of one collective phase (us): link hop + switch overhead
PHASE_LATENCY_US = {"intra": 1.0, "cross_pod": 5.0}


@dataclass
class TraceCounterBackend:
    """CounterBackend over successive traced steps."""

    mesh_shape: tuple
    hw: HwSpec = H100
    _mem: InMemoryBackend = None

    def __post_init__(self):
        if self._mem is None:
            self._mem = InMemoryBackend()

    # -- CounterBackend protocol --
    def read_counters(self) -> NICCounters:
        return self._mem.read_counters()

    def now_s(self) -> float:
        return self._mem.now_s()

    # -- feeding --
    def observe_step(self, costs, *, compute_window_s: float):
        """Account one executed step of the traced program (``costs``: a
        :class:`~repro_torch.analysis.trace_costs.TraceCosts`, or anything
        with its ``collectives``)."""
        intra_b = 0.0
        cross_b = 0.0
        lat_us = 0.0
        n_packets = 0.0
        for c in costs.collectives:
            wb = c.wire_bytes() * c.multiplier
            cls = classify_collective(c.group0_devices, self.mesh_shape)
            if cls == "cross_pod":
                cross_b += wb
            else:
                intra_b += wb
            # phases ~ ring steps = group_size - 1
            hops = max(c.group_size - 1, 1)
            lat_us += PHASE_LATENCY_US[cls] * hops * c.multiplier
            n_packets += wb / 64.0
        # stall estimate: serialization time beyond the compute window
        ser_s = intra_b / self.hw.ici_bw + cross_b / self.hw.dcn_bw
        flits = n_packets * 5.0
        excess_s = max(0.0, ser_s - compute_window_s)
        stall_cycles = excess_s * 1e9  # 1 GHz NIC-cycle convention
        self._mem.counters.observe(
            flits=int(flits),
            stalled_cycles=int(stall_cycles),
            packets=int(n_packets),
            latency_us_total=lat_us,
        )
        self._mem.advance(max(compute_window_s, ser_s))
