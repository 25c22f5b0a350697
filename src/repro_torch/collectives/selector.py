"""Application-aware collective-schedule selection — Algorithm 1 on the
port's collective schedules.

A copy of ``repro/collectives/selector.py`` with its imports retargeted
to ``repro_torch`` and the cost model's default spec the port's
``H100`` (the reference's ``V5E`` is a TPU spec).  Given equal
``HwSpec`` values its predictions equal the reference's to the bit.
At ``H100`` both link classes drain faster than the 12.8 GB/s flit
clock, so the stall term is 0 for both modes at every size and the
selector settles on DIRECT (ROADMAP C, the H100 cost-model finding).


`AppAwareSelector` is a thin adapter over the unified policy API
(repro_torch.policy.PolicyEngine + AppAwarePolicy): mode_a (the
"adaptive"/spread schedule) = HIERARCHICAL, mode_b (the minimal/low-latency
schedule) = DIRECT.  Small messages are latency-bound -> DIRECT (fewest
phases), exactly like the paper's 4 KiB high-bias gate; large messages are
bandwidth-bound on the slow pod links -> HIERARCHICAL wins once
bytes/dcn_bw dominates the extra phase latency.

`ICICostModel` supplies the a-priori (L, s) estimates per mode the same
way the paper's λ/σ scaling factors do; live observations (HLO counters or
measured step times) refine them through the engine's TelemetryBus.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.collectives.modes import CollectiveMode
from repro_torch.core.strategies import ModePerformance
from repro_torch.analysis.roofline import H100, HwSpec
from repro_torch.policy import (AppAwareConfig, AppAwarePolicy,
                                DecisionBatch, KIND_ALLTOALL, KIND_PT2PT,
                                PolicyEngine)

NS_PER_CYCLE = 1.0  # 1 GHz NIC-cycle convention, matching hlo_counters


@dataclass(frozen=True)
class MeshSpec:
    n_pods: int
    inner_chips: int          # chips per pod participating in the collective

    @property
    def total(self) -> int:
        return self.n_pods * self.inner_chips


@dataclass
class ICICostModel:
    mesh: MeshSpec
    hw: HwSpec = H100
    #: per-phase software+switch latency (cycles @1GHz = ns)
    phase_latency_intra: float = 1_000.0
    phase_latency_cross: float = 5_000.0

    def predict(self, size_bytes: int, mode: CollectiveMode,
                kind: str = "all-reduce") -> ModePerformance:
        """(L, s) estimate for transferring `size_bytes` with `mode`.

        L (latency cycles): number of phases x per-phase latency — DIRECT
        has a single phase whose ring spans pods (cross latency); the
        HIERARCHICAL schedule pays 3 phases (RS + cross-AR + AG).
        s (stall cycles/flit): serialization occupancy of the bottleneck
        link class — flits wait when the slow link is the bottleneck.
        """
        n, p, i = self.mesh.total, self.mesh.n_pods, self.mesh.inner_chips
        if mode == CollectiveMode.DIRECT:
            phases_lat = self.phase_latency_cross if p > 1 \
                else self.phase_latency_intra
            # full ring share crosses the slowest link class
            wire_slow = 2.0 * (n - 1) / n * size_bytes if p > 1 else 0.0
            wire_fast = 2.0 * (n - 1) / n * size_bytes
        else:
            phases_lat = (2.0 * self.phase_latency_intra
                          + self.phase_latency_cross)
            wire_fast = 2.0 * (i - 1) / i * size_bytes * 2.0  # RS + AG
            wire_slow = 2.0 * (p - 1) / p * (size_bytes / max(i, 1)) \
                if p > 1 else 0.0
        # stall model: cycles per flit = how much slower the bottleneck
        # link class drains than the NIC flit clock (1 flit/cycle @ 1 GHz)
        t_slow = wire_slow / self.hw.dcn_bw
        t_fast = wire_fast / self.hw.ici_bw
        t_ser = max(t_slow, t_fast)
        flits = max(size_bytes / 64.0 * 5.0, 1.0)
        t_flit_clock = flits * 1e-9          # stall-free serialization (s)
        s = max(0.0, t_ser / t_flit_clock - 1.0)
        return ModePerformance(latency_cycles=phases_lat,
                               stall_cycles_per_flit=s)


@dataclass
class AppAwareSelector:
    """Thin adapter: the legacy per-call scalar API over a PolicyEngine.

    Batched callers (grad_comm's per-step bucket list) should use
    `decide_batch`; `select`/`observe*` keep the seed's scalar protocol
    for existing call sites."""

    cost_model: ICICostModel
    engine: PolicyEngine = None
    #: traffic log (size, mode), mirrors Fig. 8's %-default reporting
    decisions: list = field(default_factory=list)

    def __post_init__(self):
        if self.engine is None:
            lam, sig = self._calibrate_scaling()
            self.engine = PolicyEngine(AppAwarePolicy(AppAwareConfig(
                mode_a=CollectiveMode.HIERARCHICAL,
                mode_a_alltoall=CollectiveMode.HIERARCHICAL,
                mode_b=CollectiveMode.DIRECT,
                lambda_latency=lam, sigma_stalls=sig,
            ), granularity="message"))

    def _calibrate_scaling(self):
        """λ, σ from the cost model at a reference size (the paper derives
        them as median ratios over microbenchmark sweeps)."""
        ref = 16 * 1024 * 1024
        a = self.cost_model.predict(ref, CollectiveMode.HIERARCHICAL)
        b = self.cost_model.predict(ref, CollectiveMode.DIRECT)
        lam = (b.latency_cycles / a.latency_cycles
               if a.latency_cycles else 1.0)
        sig = (b.stall_cycles_per_flit / a.stall_cycles_per_flit
               if a.stall_cycles_per_flit > 1e-9 else 2.0)
        # clamp away degenerate single-pod calibrations (0 or inf ratios)
        lam = min(max(lam, 0.05), 20.0)
        sig = min(max(sig, 0.05), 20.0)
        return lam, sig

    # ------------------------------------------------------------ batch API
    def decide_batch(self, sizes_bytes, *, site="default",
                     alltoall: bool = False):
        """One engine call for a batch of collective payloads."""
        kind = KIND_ALLTOALL if alltoall else KIND_PT2PT
        modes = self.engine.decide(
            DecisionBatch.of(sizes_bytes, site=site, kind=kind))
        self.decisions.extend(
            (float(sz), m) for sz, m in zip(sizes_bytes, modes))
        return modes

    def update_predicted(self, sizes_bytes) -> None:
        """Self-feed the last-decided batch with the cost model (dry-run
        path, where no wall-clock exists)."""
        modes = self.engine.last_modes
        if modes is None:
            return
        perfs = [self.cost_model.predict(int(sz), m)
                 for sz, m in zip(sizes_bytes, modes)]
        self.engine.bus.publish_flow_arrays(
            [p.latency_cycles / 1e3 for p in perfs],  # cycles->us @1GHz
            [p.stall_cycles_per_flit for p in perfs],
            source="model")

    # ----------------------------------------------------------- scalar API
    def select(self, size_bytes: int, *, alltoall: bool = False
               ) -> CollectiveMode:
        kind = KIND_ALLTOALL if alltoall else KIND_PT2PT
        mode = self.engine.decide(
            DecisionBatch.single(size_bytes, kind=kind))[0]
        self.decisions.append((size_bytes, mode))
        return mode

    def observe(self, latency_cycles: float, stalls_per_flit: float):
        self.engine.bus.publish(
            self.engine.bus.from_mode_performance(ModePerformance(
                latency_cycles, stalls_per_flit), source="nic"))

    def observe_predicted(self, size_bytes: int):
        """Self-feed with the cost model (used in the dry-run, where no
        wall-clock exists): predicted (L, s) for the mode just used."""
        modes = self.engine.last_modes
        if modes is None or len(modes) == 0:
            return
        perf = self.cost_model.predict(size_bytes, modes[-1])
        self.observe(perf.latency_cycles, perf.stall_cycles_per_flit)

    def traffic_fraction_direct(self) -> float:
        return self.engine.traffic_fraction(CollectiveMode.DIRECT)
