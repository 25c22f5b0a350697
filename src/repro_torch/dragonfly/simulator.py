"""Flow-level ("fluid") congestion simulator for the Aries Dragonfly.

Design (DESIGN.md §8): a per-phase fixed-point congestion model rather than
a cycle-accurate flit simulator (which the paper itself avoids, §7: "
simulating the exact tiled structure of Dragonfly would be too costly").

One *phase* = a set of concurrent flows (e.g. one alltoall round, one
ping-pong direction).  For each phase the simulator:
  1. draws 2 minimal + 2 non-minimal candidate paths per flow (§2.2),
  2. scores candidates with *stale, noisy* queue estimates (phantom
     congestion, Won et al. [46]) plus the routing mode's minimal bias,
  3. spreads each flow's bytes over candidates via softmin (fluid packet
     spraying),
  4. solves a small fixed point: byte loads -> link utilization -> phase
     duration -> utilization,
  5. derives per-flow NIC observables — latency L (hop + queuing delays)
     and stall ratio s (bottleneck-utilization excess) — and plugs them
     into the paper's Eq. (2) for the message time,
  6. updates persistent link queues and the allocation's NIC counters.

Background ("other job") traffic with Pareto-sized flows shares the links,
producing the heavy outlier tails of Fig. 3.  All randomness is seeded.

Port of ``repro/dragonfly/simulator.py`` to PyTorch.  The host halves of
a phase (``_phase_begin``: every random draw, from the NumPy generator;
``_phase_finish``: Eq. (2), queues, notifications, NIC counters) are the
reference's, draw for draw.  The fixed point in between
(``_run_kernel``) always runs the float32 torch pipeline of
:mod:`repro_torch.dragonfly.torch_backend` on the simulator's device —
the CUDA card unless ``device="cpu"`` is passed, with the link-load sums
in a hand-written CUDA kernel.  There is no NumPy kernel and no backend
switch: the reference's NumPy backend is the oracle the tests hold this
port against.

Repeated traffic patterns can reuse a :class:`PhasePlan` (candidate
tensor, validity masks, NIC ids, packet counts) via ``sim.plan_for(...)``
/ ``run_phase(..., plan=...)``; the plan also pins its tensors on the
device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from repro_torch.core.counters import NICCounters
from repro_torch.core.perf_model import MAX_OUTSTANDING_PACKETS
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly.routing import (RoutingPolicy,
                                           apply_notifications,
                                           row_bias_terms)
from repro_torch.dragonfly.topology import (PAD, Allocation, Topology,
                                            make_topology)
from repro_torch.dragonfly.torch_backend import (batch_signature,
                                                 fixed_point_torch,
                                                 fixed_point_torch_batch)
from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class SimParams:
    seed: int = 0
    #: minimal candidates = 4 (fluid union of Aries' per-packet 2-min draws
    #: over the K global links); non-minimal = 2 as per §2.2
    n_min_candidates: int = 4
    n_nonmin_candidates: int = 2
    #: statistical cap: phases with more flows are subsampled (bytes scaled)
    max_flows: int = 120_000
    #: fraction of a round's residual queue that persists to the next phase
    queue_carryover: float = 0.35
    #: phantom congestion (Won et al. [46]): credit-based estimates are
    #: STALE — the router sees a mix of the current queue and an EMA memory
    #: of past queues (drained hotspots look congested, fresh ones are
    #: missed), times a lognormal factor, plus exponential "ghosts".
    phantom_sigma: float = 0.45
    phantom_ghost_s: float = 25e-6
    est_staleness: float = 0.6         # weight of the stale memory
    est_memory_decay: float = 0.5       # EMA decay of the stale memory
    #: a packet waits behind only part of a queue (spraying interleaves it):
    qwait_fraction: float = 0.6
    #: stalls: a flow whose bottleneck link is offered `o` times its capacity
    #: during the serialization window stalls s = stall_gain*max(0, o - thr)
    #: cycles per flit (o>1 == credit backpressure; thr<1 == near-saturation
    #: queueing effects).
    stall_gain: float = 1.2
    rho_threshold: float = 0.85
    #: queuing delay added per hop per unit utilization excess (ns)
    queue_delay_ns: float = 900.0
    #: utilization is measured over at least this window: short messages do
    #: not self-congest (credit buffers absorb them), sustained flows do.
    min_phase_window_s: float = 50e-6
    #: NIC flit serialization: one 64B-packet = 5 flits = 5 cycles @1GHz
    flit_ns_per_byte: float = 5.0 / 64.0
    #: within-phase adaptive feedback: packets later in the message react to
    #: queues built by earlier packets (real-time local queue sensing on
    #: Aries).  Scores get + max(0, rho - feedback_rho0)*window per link and
    #: spray weights re-equilibrate this many times.
    route_feedback_iters: int = 4
    feedback_rho0: float = 0.9
    #: background traffic (other jobs): Pareto-sized flows concentrated on
    #: a slowly-rotating set of "hot" groups -> heavy outlier tails (Fig. 3)
    bg_flows_per_phase: int = 16
    bg_pareto_alpha: float = 1.1
    bg_bytes_scale: float = 2.5e6
    bg_hot_groups: int = 3
    bg_hot_prob: float = 0.65
    bg_rotate_phases: int = 50
    bg_enable: bool = True
    #: host-side constant per phase (not network noise! §3.3) — us
    host_overhead_us: float = 1.5
    host_noise_sigma: float = 0.25     # lognormal sigma of host-side jitter
    nic_clock_ghz: float = 1.0
    #: topology spec resolved by make_topology when the simulator is built
    #: without an explicit Topology instance: a registered name ("aries",
    #: "dragonfly", "dragonfly_plus", "fattree") optionally with kwargs,
    #: e.g. "dragonfly:p=2,a=4,h=2".  docs/topology.md.
    topology: str = "aries"
    #: reroute-or-drop penalty (us) charged to a flow whose every
    #: candidate path crosses a dead link (or whose NIC link is dead)
    #: under an active fault schedule — models the retransmit/timeout
    #: cost of losing all routes.  docs/faults.md.
    fault_penalty_us: float = 500.0
    #: congestion-notification channel (docs/policy_api.md; Rocher-
    #: Gonzalez et al. 2502.00616).  A link whose noisy queue estimate
    #: `est_queue_s` crosses notify_threshold_s raises a flag that
    #: becomes visible to source routers notify_delay_phases later
    #: (propagation delay) and clears — hysteresis — only once the
    #: estimate drops below notify_clear_frac * notify_threshold_s.
    #: Visible flags charge notify_penalty_s of predicted delay to
    #: every candidate crossing the link (routing.apply_notifications)
    #: and surface per flow in FlowResult.notified / per allocation in
    #: the NIC notification counter.  The default threshold (inf)
    #: disables the channel: no flag ever raises, no extra RNG draws or
    #: float ops happen, and the simulator is BIT-identical to the
    #: notification-free fast path (tests/test_dragonfly_fastpath.py).
    notify_threshold_s: float = float("inf")
    notify_clear_frac: float = 0.5
    notify_delay_phases: int = 1
    notify_penalty_s: float = 300e-6
    #: accumulate per-stage wall times into sim.stage_time_s (perf_sim.py)
    profile_stages: bool = False

    @property
    def notify_enabled(self) -> bool:
        """True when the notification channel can ever raise a flag."""
        return bool(np.isfinite(self.notify_threshold_s))


@dataclass
class FlowResult:
    """Per-flow observables for one phase."""

    t_us: np.ndarray            # Eq.(2) message time
    latency_us: np.ndarray      # L
    stalls_per_flit: np.ndarray  # s
    flits: np.ndarray
    packets: np.ndarray
    nonmin_fraction: float      # byte fraction routed non-minimally
    #: multi-tenant breakdown (run_phase(tenants=...) only; see
    #: repro.tenancy / docs/interference.md), else None:
    #:   tenant_of            [n_app]  tenant index of each app flow row
    #:   tenant_link_loads    [K+1, n_links] backlog bytes per tenant
    #:                        (row K = background traffic)
    #:   link_load_q          [n_links] global backlog bytes (the sum)
    #:   tenant_nonmin_fraction [K] per-tenant non-minimal byte fraction
    tenant_of: np.ndarray | None = None
    tenant_link_loads: np.ndarray | None = None
    link_load_q: np.ndarray | None = None
    tenant_nonmin_fraction: np.ndarray | None = None
    #: fault path (docs/faults.md): bool [n_app], True for app flows with
    #: zero surviving candidate paths this phase (charged the
    #: reroute-or-drop penalty); None when no fault was active
    stranded: np.ndarray | None = None
    #: notification channel (SimParams.notify_*): float [n_app] in
    #: [0, 1], the fraction of each app flow's sprayed bytes that
    #: crossed a link under a VISIBLE congestion flag this phase; None
    #: when the channel is disabled (threshold=inf, the default)
    notified: np.ndarray | None = None

    @property
    def phase_time_us(self) -> float:
        return float(self.t_us.max()) if self.t_us.size else 0.0

    @property
    def n_stranded(self) -> int:
        return int(self.stranded.sum()) if self.stranded is not None else 0

    def tenant_slice(self, k: int) -> np.ndarray:
        """Row indices of tenant `k`'s app flows (post-subsample order)."""
        if self.tenant_of is None:
            raise ValueError("not a multi-tenant result (tenants= not set)")
        return np.flatnonzero(self.tenant_of == k)


@dataclass(frozen=True)
class TenantSegments:
    """Flow-segment map of one flattened multi-tenant phase.

    The tenancy engine (repro.tenancy) concatenates K tenants' flows into
    ONE app batch; this object tells run_phase where each tenant's
    segment lives so per-allocation NIC counters and the per-tenant
    link-load breakdown can be split back out with the same bincount
    segment-sum machinery the fast path uses for links (tenant-id
    segment offsets instead of link ids).

    allocations: K Allocations, tenant order == segment order.
    offsets:     int64 [K+1]; tenant k owns app-flow rows
                 [offsets[k], offsets[k+1]) of the PRE-subsample batch.
    """

    allocations: tuple
    offsets: np.ndarray

    @staticmethod
    def of(allocations, counts) -> "TenantSegments":
        """Build from per-tenant flow counts (tenant order)."""
        off = np.concatenate([[0], np.cumsum(np.asarray(counts,
                                                        dtype=np.int64))])
        return TenantSegments(tuple(allocations), off)

    def __len__(self) -> int:
        return len(self.allocations)

    @property
    def n_flows(self) -> int:
        return int(self.offsets[-1])

    def tenant_of_flows(self) -> np.ndarray:
        """[n_flows] tenant index per pre-subsample app-flow row."""
        return np.searchsorted(self.offsets, np.arange(self.n_flows),
                               side="right").astype(np.int64) - 1

    @cached_property
    def union_allocation(self) -> Allocation:
        """Union of every tenant's nodes — the background-traffic
        disjointness pool (other jobs share nodes with NO tenant)."""
        nodes = np.unique(np.concatenate(
            [np.asarray(a.nodes, dtype=np.int64)
             for a in self.allocations])) if self.allocations \
            else np.empty(0, dtype=np.int64)
        ids = ",".join(a.allocation_id for a in self.allocations)
        return Allocation(allocation_id=f"mix({ids})",
                          nodes=tuple(int(x) for x in nodes))


def _pair_compress(links: np.ndarray, valid: np.ndarray):
    """Flatten the PAD-padded [n, ncand, hops] candidate-link tensor into
    the fast path's (link, flow-candidate) pair lists.

    Returns (pair_links [P], pair_fc [P]): for every *valid* hop entry,
    the link id and the flat ``flow * ncand + cand`` index whose spray
    weight scales the bytes offered to that link.  ``np.bincount`` over
    these pairs is the segment-sum replacing ``np.add.at`` — skipping
    the PAD zero-contributions keeps the per-bin accumulation order (and
    therefore the float64 sums) bit-identical.
    """
    idx = np.flatnonzero(valid.ravel())
    return links.ravel()[idx], idx // links.shape[2]


@dataclass
class PhasePlan:
    """Precomputed, reusable tensors for one app traffic pattern.

    Repeated collective rounds (fig7/fig8/fig10 ping-pong & alltoall,
    train/serve step loops) re-send the same (src, dst, bytes) pattern
    every iteration; a plan freezes everything ``run_phase`` would
    otherwise rebuild per call: the candidate-path draw, validity masks,
    the bincount pair lists, NIC ids and packet counts.

    Reuse contract (docs/performance.md): a plan's candidate paths (and,
    for oversized phases, the statistical subsample) are drawn ONCE from
    the simulator RNG at plan creation and then FROZEN — replaying a
    plan consumes fewer RNG draws than planless calls, so plan-reused
    runs are seeded-deterministic but not draw-for-draw identical to
    planless ones.  Background traffic, phantom noise and spray noise
    stay fresh per phase.  Plans are immutable and topology-bound; they
    may be shared across policies/modes but not across simulators with
    different topologies.
    """

    src: np.ndarray             # [n] app flow sources (post-subsample)
    dst: np.ndarray
    size: np.ndarray            # [n] bytes (subsample-scaled)
    n_flows_in: int             # flow count the plan was built from
    subsample_idx: np.ndarray | None   # rows kept when n_flows_in > cap
    links: np.ndarray           # [n, ncand, hops] PAD-padded link ids
    valid: np.ndarray
    safe: np.ndarray
    hops: np.ndarray            # [n, ncand]
    is_nonmin: np.ndarray       # [ncand]
    pair_links: np.ndarray
    pair_fc: np.ndarray
    nic_ids: np.ndarray         # [n] injection link per flow
    packets: np.ndarray         # [n] request packets per flow
    ser_s_app: float            # clean serialization time of largest msg
    #: the plan's phase-invariant tensors pinned on the simulator's
    #: device (filled lazily by torch_backend._device_plan; their
    #: lifetime is the plan's, and `plan_for`'s cache key — topology
    #: spec + fault epoch + notify epoch + pattern — keys them too)
    device_tensors: dict | None = field(default=None, repr=False,
                                        compare=False)

    @property
    def n_flows(self) -> int:
        return int(self.src.shape[0])


class DragonflySimulator:
    def __init__(self, topo: Topology | None = None,
                 params: SimParams = SimParams(), faults=None, *,
                 device=None):
        #: where the phase pipeline runs: the CUDA card unless the caller
        #: passes device="cpu"; raises when CUDA is requested but absent
        self.device = resolve_device(device)
        # topo=None resolves params.topology ("aries", "dragonfly:p=2,...",
        # any registered family spec) through make_topology
        self.topo = topo = make_topology(topo if topo is not None
                                         else params.topology)
        self.params = params
        self.rng = np.random.default_rng(params.seed)
        self.link_queue_s = np.zeros(topo.n_links)  # seconds-to-drain units
        self.est_memory_s = np.zeros(topo.n_links)  # stale estimate memory
        #: congestion-notification state (SimParams.notify_*): per-link
        #: phase age of the active flag — -1 means no flag, and a flag
        #: becomes visible to source routers once its age reaches
        #: notify_delay_phases.  Lives alongside link_queue_s /
        #: est_memory_s and follows the same lifecycle: cleared by
        #: reset_queues() and by fault-epoch resets (dead links never
        #: notify, docs/faults.md).
        self.link_notify_age = np.full(topo.n_links, -1, dtype=np.int64)
        self._notify_epoch = 0              # bumps when the visible set changes
        self._notify_fault_epoch = 0        # last fault epoch seen by the channel
        self.counters: dict[str, NICCounters] = {}
        self.clock_s: float = 0.0
        self.total_flits_all_jobs: float = 0.0
        self._phase_count = 0
        self._hot_groups = self.rng.choice(
            topo.n_groups,
            size=min(params.bg_hot_groups, topo.n_groups),
            replace=False)
        self._plan_cache: dict = {}
        #: accumulated per-stage wall time (params.profile_stages)
        self.stage_time_s: dict[str, float] = {}
        #: fault injection (docs/faults.md): phase index of the NEXT
        #: run_phase call, and the bound schedule (None = healthy machine)
        self.phase_index = 0
        self.faults = None
        if faults is not None:
            self.set_faults(faults)

    def set_faults(self, schedule) -> None:
        """Install a :class:`repro.faults.FaultSchedule` (binding it to
        this simulator's topology).  An empty/None schedule restores the
        healthy machine — output is then bit-identical to a fault-free
        simulator, seed-for-seed (tests/test_faults.py)."""
        if schedule and not hasattr(schedule, "state_at"):
            schedule = schedule.bind(self.topo)   # FaultSchedule -> bound
        self.faults = schedule or None

    def fault_epoch(self) -> int:
        """Fault epoch of the NEXT phase (keys the plan cache)."""
        return self.faults.epoch_at(self.phase_index) \
            if self.faults is not None else 0

    def notify_epoch(self) -> int:
        """Notification epoch: increments whenever the set of VISIBLE
        congestion flags changes between phases (keys the plan cache —
        a mirror of fault_epoch()).  Always 0 while the channel is
        disabled."""
        return self._notify_epoch

    @property
    def notified_links(self) -> np.ndarray:
        """Bool [n_links]: flags visible to source routers on the NEXT
        phase (raised at least notify_delay_phases ago, not yet
        cleared by the hysteresis low-water mark)."""
        return self.link_notify_age >= self.params.notify_delay_phases

    # --------------------------------------------------------- counter API
    def backend_for(self, allocation_id: str):
        """CounterBackend view for one allocation's NICs."""
        sim = self

        class _Backend:
            def read_counters(_s) -> NICCounters:
                return sim.counters.setdefault(allocation_id, NICCounters())

            def now_s(_s) -> float:
                return sim.clock_s

        return _Backend()

    # ------------------------------------------------------------- internals
    def _stage(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.stage_time_s[name] = self.stage_time_s.get(name, 0.0) + t1 - t0
        return t1

    def _bg_flows(self, allocation: Allocation | None = None):
        p = self.params
        n = p.bg_flows_per_phase
        if not p.bg_enable or n == 0:
            return None
        tp = self.topo
        self._phase_count += 1
        if self._phase_count % max(1, p.bg_rotate_phases) == 0:
            self._hot_groups = self.rng.choice(
                tp.n_groups, size=min(p.bg_hot_groups, tp.n_groups),
                replace=False)
        nodes_per_group = tp.nodes_per_group
        ours = np.asarray(allocation.nodes) if allocation is not None \
            else np.empty(0, dtype=np.int64)
        # nodes outside the allocation (the disjointness fallback pool);
        # empty only in the degenerate whole-machine-allocation case
        free = None

        def draw(size):
            nonlocal free
            hot = self.rng.random(size) < p.bg_hot_prob
            grp = np.where(
                hot,
                self.rng.choice(self._hot_groups, size=size),
                self.rng.integers(0, tp.n_groups, size=size))
            off = self.rng.integers(0, nodes_per_group, size=size)
            out = grp * nodes_per_group + off
            # batch systems do not share nodes between jobs: other-job flows
            # never originate/terminate on the allocation's nodes.  Resample
            # to DISJOINTNESS (bounded, seeded): a few general redraws, then
            # any survivor is drawn from the complement directly, so overlap
            # cannot silently persist
            for _ in range(3):
                bad = np.isin(out, ours)
                if not bad.any():
                    return out
                out[bad] = self.rng.integers(0, tp.n_nodes, size=bad.sum())
            bad = np.isin(out, ours)
            if bad.any():
                if free is None:
                    free = np.setdiff1d(np.arange(tp.n_nodes), ours)
                if free.size:
                    out[bad] = self.rng.choice(free, size=bad.sum())
            return out

        src = draw(n)
        dst = draw(n)
        dst = np.where(dst == src, (dst + 1) % tp.n_nodes, dst)
        # the +1 shift above can re-land on the allocation (or on src):
        # walk forward deterministically until outside both (no RNG draws,
        # so the stream matches the pre-fix code whenever it was correct)
        bad = np.isin(dst, ours) | (dst == src)
        for _ in range(int(tp.n_nodes)):
            if not bad.any():
                break
            dst = np.where(bad, (dst + 1) % tp.n_nodes, dst)
            bad = np.isin(dst, ours) | (dst == src)
        size = (self.rng.pareto(p.bg_pareto_alpha, size=n) + 1.0) \
            * p.bg_bytes_scale
        return src, dst, size

    @staticmethod
    def _flits_packets(bytes_: np.ndarray):
        packets = np.maximum(1, np.ceil(bytes_ / 64.0))
        flits = packets * 5.0  # PUT: 1 header + 4 payload flits
        return flits, packets

    # --------------------------------------------------------------- plans
    def make_plan(self, src_nodes, dst_nodes, bytes_) -> PhasePlan:
        """Build a reusable PhasePlan for one app traffic pattern.

        Consumes RNG draws for the candidate paths (and the statistical
        subsample if the phase exceeds ``max_flows``) exactly once; see
        the PhasePlan reuse contract."""
        p = self.params
        src = np.asarray(src_nodes, dtype=np.int64)
        dst = np.asarray(dst_nodes, dtype=np.int64)
        size = np.asarray(bytes_, dtype=np.float64)
        n_in = int(src.shape[0])
        sub_idx = None
        if n_in > p.max_flows:
            sub_idx = self.rng.choice(n_in, size=p.max_flows, replace=False)
            scale = n_in / p.max_flows
            src, dst, size = src[sub_idx], dst[sub_idx], size[sub_idx] * scale
        links, is_nonmin = self.topo.candidate_paths(
            src, dst, self.rng,
            n_min=p.n_min_candidates, n_nonmin=p.n_nonmin_candidates)
        valid = links != PAD
        pair_links, pair_fc = _pair_compress(links, valid)
        return PhasePlan(
            src=src, dst=dst, size=size, n_flows_in=n_in,
            subsample_idx=sub_idx,
            links=links, valid=valid, safe=np.where(valid, links, 0),
            hops=valid.sum(axis=-1), is_nonmin=is_nonmin,
            pair_links=pair_links, pair_fc=pair_fc,
            nic_ids=np.asarray(self.topo.nic_link(src)),
            packets=np.maximum(1, np.ceil(size / 64.0)),
            ser_s_app=(float(size.max() * p.flit_ns_per_byte) * 1e-9
                       if size.size else 0.0),
        )

    def plan_for(self, src_nodes, dst_nodes, bytes_) -> PhasePlan:
        """Content-addressed plan cache: repeated (src, dst, bytes)
        patterns get one shared PhasePlan per simulator.

        The key also covers the topology spec and the CURRENT fault
        epoch: a plan drawn on the healthy machine must not be replayed
        once a fault changes the link set (its frozen candidate paths
        would silently keep routing into dead links), so every fault
        epoch recomputes — the plan-level half of rerouting."""
        import hashlib

        src = np.asarray(src_nodes, dtype=np.int64)
        dst = np.asarray(dst_nodes, dtype=np.int64)
        size = np.asarray(bytes_, dtype=np.float64)
        h = hashlib.sha1()
        h.update(self.topo.spec_str().encode())
        h.update(str(self.fault_epoch()).encode())
        # notification epoch: the key is a superset of everything
        # run_phase reads, so a reactive arm never replays a plan keyed
        # to a different visible-flag set (cheap insurance mirroring the
        # fault epoch — always 0, hence free, while the channel is off)
        h.update(str(self._notify_epoch).encode())
        for a in (src, dst, size):
            h.update(a.tobytes())
        key = h.digest()
        plan = self._plan_cache.get(key)
        if plan is None:
            if len(self._plan_cache) >= 64:     # bounded: drop the oldest
                self._plan_cache.pop(next(iter(self._plan_cache)))
            plan = self._plan_cache[key] = self.make_plan(src, dst, size)
        return plan

    # ------------------------------------------------------------- run_phase
    def run_phase(self, src_nodes, dst_nodes, bytes_, policy: RoutingPolicy,
                  allocation: Allocation | None = None,
                  modes: np.ndarray | None = None,
                  plan: PhasePlan | None = None,
                  tenants: TenantSegments | None = None) -> FlowResult:
        """Simulate one phase of concurrent flows routed with `policy`.

        `modes` (optional, [n_app] object array of RoutingModes) is the
        PolicyEngine path: per-flow modes from one vectorized
        engine.decide() call bias each flow individually; `policy` then
        only supplies the calibration constants (bias_unit_s etc.).

        `plan` (optional) replays a precomputed PhasePlan for the app
        flows (src/dst/bytes args are then ignored); candidate paths are
        not redrawn — see the PhasePlan reuse contract.

        `tenants` (optional, repro.tenancy path) declares the app batch
        as K concatenated tenant segments: NIC counters are credited per
        tenant allocation, background flows avoid the UNION of tenant
        nodes, and the result carries the per-tenant link-load breakdown
        (FlowResult.tenant_*).  Mutually exclusive with `allocation` —
        a K=1 TenantSegments is bit-identical to passing that tenant's
        Allocation directly (tests/test_tenancy.py)."""
        ctx = self._phase_begin(src_nodes, dst_nodes, bytes_, policy,
                                allocation=allocation, modes=modes,
                                plan=plan, tenants=tenants)
        if ctx["result"] is not None:
            return ctx["result"]
        return self._phase_finish(ctx, self._run_kernel(ctx))

    def _phase_begin(self, src_nodes, dst_nodes, bytes_,
                     policy: RoutingPolicy,
                     allocation: Allocation | None = None,
                     modes: np.ndarray | None = None,
                     plan: PhasePlan | None = None,
                     tenants: TenantSegments | None = None) -> dict:
        """Host half #1 of run_phase, up to the kernel boundary.

        Draws ALL of the phase's randomness (bg flows, candidate paths,
        phantom noise, Gumbel spray noise) from the simulator RNG and
        assembles the kernel inputs into a context dict; `_run_kernel`
        and `_phase_finish` complete the phase.  The score base and the
        NIC loads are left to the device pipeline, as on the reference's
        jax path."""
        p = self.params
        topo = self.topo
        prof = p.profile_stages
        t0 = time.perf_counter() if prof else 0.0
        if tenants is not None and allocation is not None:
            raise ValueError("pass either allocation= or tenants=, not both")
        tenant_of = None

        # --- fault state for this phase (docs/faults.md) -------------------
        # None = healthy machine: every fault-path branch below is skipped
        # and the phase is bit-identical to a fault-free simulator.
        fstate = self.faults.state_at(self.phase_index) \
            if self.faults is not None else None
        if self.faults is not None:
            ep = self.faults.epoch_at(self.phase_index)
            if ep != self._notify_fault_epoch:
                # fault-epoch reset: the link set just changed, so flags
                # raised on the OLD machine describe paths that no
                # longer exist — the whole channel restarts (mirror of
                # the est_memory_s reset contract)
                self._notify_fault_epoch = ep
                if (self.link_notify_age >= 0).any():
                    if self.notified_links.any():
                        self._notify_epoch += 1
                    self.link_notify_age[:] = -1
        self.phase_index += 1
        if fstate is not None and fstate.any_dead:
            # a downed link holds no backlog and leaves no stale estimate
            self.link_queue_s[fstate.dead] = 0.0
            self.est_memory_s[fstate.dead] = 0.0
            # ... and never notifies: an active flag dies with its link
            # instead of demoting paths the mask already removed
            self.link_notify_age[fstate.dead] = -1

        # --- app flows: from the plan, or validated + subsampled fresh ----
        if plan is not None:
            if modes is not None and np.shape(modes)[0] != plan.n_flows_in:
                raise ValueError("modes must have one entry per app flow")
            if modes is not None and plan.subsample_idx is not None:
                modes = modes[plan.subsample_idx]
            if tenants is not None:
                if tenants.n_flows != plan.n_flows_in:
                    raise ValueError("tenant segments must cover the plan's "
                                     "app flows")
                tenant_of = tenants.tenant_of_flows()
                if plan.subsample_idx is not None:
                    tenant_of = tenant_of[plan.subsample_idx]
            src, dst, size = plan.src, plan.dst, plan.size
            n_app = plan.n_flows
        else:
            src = np.asarray(src_nodes, dtype=np.int64)
            dst = np.asarray(dst_nodes, dtype=np.int64)
            size = np.asarray(bytes_, dtype=np.float64)
            n_app = src.shape[0]
            if modes is not None and np.shape(modes)[0] != n_app:
                raise ValueError("modes must have one entry per app flow")
            if tenants is not None:
                if tenants.n_flows != n_app:
                    raise ValueError("tenant segments must cover the app "
                                     "flows")
                tenant_of = tenants.tenant_of_flows()
            if n_app > p.max_flows:
                idx = self.rng.choice(n_app, size=p.max_flows, replace=False)
                scale = n_app / p.max_flows
                src, dst, size = src[idx], dst[idx], size[idx] * scale
                if modes is not None:
                    modes = modes[idx]
                if tenant_of is not None:
                    tenant_of = tenant_of[idx]
                n_app = p.max_flows
        if n_app == 0 and not (p.bg_enable and p.bg_flows_per_phase):
            return {"result": FlowResult(*(np.zeros(0),) * 5, 0.0)}

        bg = self._bg_flows(tenants.union_allocation if tenants is not None
                            else allocation)

        # --- candidate tensors (planless: one joint draw, as pre-refactor;
        #     plan: frozen app tensors + a fresh draw for the bg flows) ----
        if plan is None:
            if bg is not None:
                src_all = np.concatenate([src, bg[0]])
                size_all = np.concatenate([size, bg[2]])
                dst_all = np.concatenate([dst, bg[1]])
            else:
                src_all, dst_all, size_all = src, dst, size
            links, is_nonmin = topo.candidate_paths(
                src_all, dst_all, self.rng,
                n_min=p.n_min_candidates, n_nonmin=p.n_nonmin_candidates)
            valid = links != PAD
            safe = np.where(valid, links, 0)
            hops = valid.sum(axis=-1)
            pair_links, pair_fc = _pair_compress(links, valid)
            nic_ids = np.asarray(topo.nic_link(src_all))
            packets_all = np.maximum(1, np.ceil(size_all / 64.0))
            ser_s_app = float(size[:n_app].max() * p.flit_ns_per_byte) \
                * 1e-9 if n_app else 0.0
        else:
            is_nonmin = plan.is_nonmin
            ser_s_app = plan.ser_s_app
            if bg is not None:
                bg_links, _ = topo.candidate_paths(
                    bg[0], bg[1], self.rng,
                    n_min=p.n_min_candidates, n_nonmin=p.n_nonmin_candidates)
                bg_valid = bg_links != PAD
                bg_pl, bg_fc = _pair_compress(bg_links, bg_valid)
                ncand = bg_links.shape[1]
                valid = np.concatenate([plan.valid, bg_valid])
                safe = np.concatenate(
                    [plan.safe, np.where(bg_valid, bg_links, 0)])
                hops = np.concatenate([plan.hops, bg_valid.sum(axis=-1)])
                pair_links = np.concatenate([plan.pair_links, bg_pl])
                pair_fc = np.concatenate(
                    [plan.pair_fc, bg_fc + n_app * ncand])
                size_all = np.concatenate([size, bg[2]])
                nic_ids = np.concatenate(
                    [plan.nic_ids, np.asarray(topo.nic_link(bg[0]))])
                packets_all = np.concatenate(
                    [plan.packets, np.maximum(1, np.ceil(bg[2] / 64.0))])
            else:
                valid, safe, hops = plan.valid, plan.safe, plan.hops
                pair_links, pair_fc = plan.pair_links, plan.pair_fc
                size_all, nic_ids = size, plan.nic_ids
                packets_all = plan.packets
        n_all = safe.shape[0]
        ncand = safe.shape[1]

        # --- fault masking: kill candidates that cross dead links ----------
        # Vectorized through the same PAD-masked tensors as the fast path:
        # one gather of the dead-link flags over `safe` (PAD entries gather
        # link 0 but are ANDed away by `valid`).  A row whose injection or
        # ejection NIC link is down (router_down takes its hosted nodes
        # along) loses every candidate; rows with no survivor are
        # `stranded` — they spray nowhere and pay fault_penalty_us.
        cand_mask = stranded = None
        if fstate is not None and fstate.any_dead:
            fdead = fstate.dead
            if plan is None:
                dst_all_nodes = dst_all
            elif bg is not None:
                dst_all_nodes = np.concatenate([plan.dst, bg[1]])
            else:
                dst_all_nodes = plan.dst
            row_dead = fdead[nic_ids] \
                | fdead[np.asarray(topo.nic_link(dst_all_nodes))]
            cand_mask = ~((fdead[safe] & valid).any(axis=-1)) \
                & ~row_dead[:, None]
            stranded = ~cand_mask.any(axis=-1)
        if prof:
            t0 = self._stage("candidates", t0)

        # --- stale & noisy congestion estimate (phantom congestion) --------
        noise = self.rng.lognormal(0.0, p.phantom_sigma, size=topo.n_links)
        ghosts = self.rng.exponential(p.phantom_ghost_s, size=topo.n_links)
        a = p.est_staleness
        est_queue_s = ((1.0 - a) * self.link_queue_s
                       + a * self.est_memory_s) * noise + ghosts

        # --- congestion notifications (SimParams.notify_*) -----------------
        # Flags raised on a past phase become visible after the propagation
        # delay and demote every candidate crossing them via the
        # routing-layer penalty (folded into the estimate BEFORE the
        # hoisted score base, so the base gather, the feedback re-gathers
        # and the device pipeline see one consistent per-link cost).  The raw
        # estimate is kept for the end-of-phase raise/clear update: the
        # penalty must not feed back into the hysteresis comparison or a
        # flagged link could never clear.  Disabled (threshold=inf) this
        # block is skipped entirely — no RNG draws, no float ops — keeping
        # the phase bit-identical to the notification-free simulator.
        notify_vis = est_notify = None
        if p.notify_enabled:
            est_notify = est_queue_s
            notify_vis = self.link_notify_age >= p.notify_delay_phases
            if fstate is not None and fstate.any_dead:
                notify_vis &= ~fstate.dead      # dead links never notify
            if notify_vis.any():
                est_queue_s = apply_notifications(
                    est_queue_s, notify_vis, p.notify_penalty_s)

        # --- contention window: the APP phase's clean serialization time ---
        # (stall-free flit serialization of the largest app message; floored
        # so transient small messages do not self-congest)
        window_s = max(ser_s_app, p.min_phase_window_s)
        cap_gbs = topo.capacity_gbs
        if fstate is not None:
            # degraded links keep a fraction of their capacity; DEAD links
            # keep the nominal value (they carry zero load thanks to the
            # candidate mask, and 0-capacity would poison rho with inf)
            cap_gbs = cap_gbs * np.where(fstate.dead, 1.0,
                                         fstate.capacity_scale)
        cap_bps = cap_gbs * 1e9
        bg_policy = RoutingPolicy(RoutingMode.ADAPTIVE_0)

        # --- loop-invariant score base + fused per-row spray constants -----
        # (queue gather + hop latency + bias hoisted OUT of the feedback
        # loop; per-flow modes become one int-code bias lookup per phase)
        bias_rows, posinf, neginf = row_bias_terms(n_app, policy, modes)
        hl_rows = np.full(n_app, policy.hop_latency_s)
        t_rows = np.full(n_app, max(policy.spray_temperature_s, 1e-12))
        if n_all > n_app:
            n_bg = n_all - n_app
            bb, bp_, bn = row_bias_terms(n_bg, bg_policy)
            bias_rows = np.concatenate([bias_rows, bb])
            posinf = np.concatenate([posinf, bp_])
            neginf = np.concatenate([neginf, bn])
            hl_rows = np.concatenate(
                [hl_rows, np.full(n_bg, bg_policy.hop_latency_s)])
            t_rows = np.concatenate(
                [t_rows,
                 np.full(n_bg, max(bg_policy.spray_temperature_s, 1e-12))])
        noise_scale = (t_rows * 0.9)[:, None] \
            / np.sqrt(np.maximum(packets_all, 1.0))[:, None]
        # whole-phase spray noise, drawn up-front: one (iters, n, ncand)
        # block consumes the stream exactly like the per-iteration
        # app-then-bg draws did (Gumbel is one double per variate)
        n_spray = max(1, p.route_feedback_iters)
        gnoise = self.rng.gumbel(0.0, 1.0, size=(n_spray, n_all, ncand))
        if prof:
            t0 = self._stage("estimate", t0)
        return {
            "result": None,
            "n_app": n_app, "n_all": n_all, "ncand": ncand,
            "plan": plan, "safe": safe, "valid": valid, "hops": hops,
            "is_nonmin": is_nonmin, "pair_links": pair_links,
            "pair_fc": pair_fc, "nic_ids": nic_ids,
            "size": size, "size_all": size_all,
            "est_queue_s": est_queue_s, "hl_rows": hl_rows,
            "bias_rows": bias_rows, "posinf": posinf, "neginf": neginf,
            "t_rows": t_rows, "noise_scale": noise_scale,
            "gnoise": gnoise, "window_s": window_s, "cap_bps": cap_bps,
            "cap_window": cap_bps * window_s,
            "cand_mask": cand_mask, "stranded": stranded,
            "fstate": fstate, "notify_vis": notify_vis,
            "est_notify": est_notify,
            "tenants": tenants, "tenant_of": tenant_of,
            "allocation": allocation, "t0": t0,
        }

    def _run_kernel(self, ctx: dict):
        """Fixed point + observables for one prepared phase context, on
        ``self.device``."""
        return fixed_point_torch(self, ctx)

    def _phase_finish(self, ctx: dict, out) -> FlowResult:
        """Host half #2: notified exposure, Eq.(2) times, queue and
        notification-state updates, NIC counters, tenant breakdown."""
        p = self.params
        topo = self.topo
        prof = p.profile_stages
        t0 = ctx["t0"]
        n_app, ncand = ctx["n_app"], ctx["ncand"]
        safe, valid, is_nonmin = ctx["safe"], ctx["valid"], ctx["is_nonmin"]
        pair_links, pair_fc = ctx["pair_links"], ctx["pair_fc"]
        size, size_all = ctx["size"], ctx["size_all"]
        window_s, cap_bps = ctx["window_s"], ctx["cap_bps"]
        fstate, stranded = ctx["fstate"], ctx["stranded"]
        notify_vis, est_notify = ctx["notify_vis"], ctx["est_notify"]
        tenants, tenant_of = ctx["tenants"], ctx["tenant_of"]
        allocation = ctx["allocation"]
        w, rho, load_q, lat_us, s_flit = out
        w_app = w[:n_app]
        # per-flow notified exposure: the fraction of each app flow's
        # sprayed bytes that crossed a visibly-flagged link (all zero on
        # quiet phases so reactive policies can tell "enabled, calm"
        # from "disabled"=None)
        flow_notified = None
        if notify_vis is not None:
            flow_notified = np.zeros(n_app)
            if n_app and notify_vis.any():
                cand_flag = (notify_vis[safe[:n_app]]
                             & valid[:n_app]).any(axis=-1)
                flow_notified = (cand_flag * np.asarray(w_app)).sum(axis=-1)
        if prof:
            t0 = self._stage("fixed_point", t0)

        flits, packets = self._flits_packets(size_all)
        win = (packets + MAX_OUTSTANDING_PACKETS // 2) \
            / MAX_OUTSTANDING_PACKETS
        lat_cycles = lat_us * 1e3 * p.nic_clock_ghz
        t_cycles = win * lat_cycles + flits * (s_flit + 1.0)
        t_us = t_cycles / (1e3 * p.nic_clock_ghz)
        if stranded is not None and stranded.any():
            # reroute-or-drop: a flow with zero surviving paths sprays
            # nowhere (all-inf softmin row -> zero weights) and its message
            # time is the retransmit/timeout penalty on top of the local
            # serialization cost — surfaced in t_us so phase durations,
            # victim slowdown, and recovery metrics all see the fault
            t_us = t_us + stranded * p.fault_penalty_us
        duration_s = max(float(t_us[:n_app].max()) * 1e-6, 1e-7) \
            if n_app else window_s
        # "network tile" aggregate: every job's flits on the wire (what a
        # tile counter would see; §3.2's correlation trap)
        self.total_flits_all_jobs += float(flits.sum())

        # --- persistent queues (seconds-to-drain beyond this phase) --------
        excess_s = np.maximum(0.0, load_q / cap_bps
                              - max(duration_s, window_s))
        self.est_memory_s = (self.est_memory_s * p.est_memory_decay
                             + self.link_queue_s * (1 - p.est_memory_decay))
        self.link_queue_s = self.link_queue_s * p.queue_carryover + excess_s
        self.clock_s += duration_s

        # --- notification raise / age / clear (threshold + hysteresis) -----
        # Driven by the RAW estimate (est_notify, penalty-free): a link
        # raises at the threshold high-water mark, an active flag ages one
        # phase at a time toward visibility, and it clears only once the
        # estimate drops below the notify_clear_frac low-water mark — the
        # two-level hysteresis of 2502.00616 that keeps flags from
        # chattering around a single threshold.
        if notify_vis is not None:
            age = self.link_notify_age
            raised = est_notify >= p.notify_threshold_s
            if fstate is not None and fstate.any_dead:
                raised &= ~fstate.dead          # dead links never notify
            low = est_notify < p.notify_clear_frac * p.notify_threshold_s
            active = age >= 0
            age[active & low & ~raised] = -1    # hysteresis clear
            age[active & (raised | ~low)] += 1  # surviving flags age
            age[~active & raised] = 0           # fresh flags start hidden
            if not np.array_equal(self.notified_links, notify_vis):
                self._notify_epoch += 1         # visible set changed

        # --- NIC counters (§2.3): one allocation, or per tenant segment ----
        app_flits, app_packets = flits[:n_app], packets[:n_app]
        app_lat, app_stalls = lat_us[:n_app], s_flit[:n_app]
        # NIC-visible notification events: app flows whose sprayed bytes
        # touched a flagged link (allocation-scoped like every other
        # counter — §3.2: users cannot see other jobs' notifications)
        notif_flows = (flow_notified > 0.0) if flow_notified is not None \
            else None
        # counter_dropout fault: the allocation's NIC telemetry goes dark —
        # no observe(), so readers see a frozen snapshot and the
        # PolicyEngine staleness guard (docs/faults.md) eventually trips
        def _dark(aid):
            return fstate is not None and fstate.counters_blocked(aid)

        if tenants is not None:
            # each tenant sees ONLY its own NICs (§3.2: users cannot see
            # other jobs' counters) — K masked observes, one per segment
            for k, alloc_k in enumerate(tenants.allocations):
                if _dark(alloc_k.allocation_id):
                    continue
                mk = tenant_of == k
                c = self.counters.setdefault(alloc_k.allocation_id,
                                             NICCounters())
                c.observe(
                    flits=int(app_flits[mk].sum()),
                    stalled_cycles=int((app_flits[mk]
                                        * app_stalls[mk]).sum()),
                    packets=int(app_packets[mk].sum()),
                    latency_us_total=float((app_lat[mk]
                                            * app_packets[mk]).sum()),
                    notifications=int(notif_flows[mk].sum())
                    if notif_flows is not None else 0,
                )
        elif allocation is not None and not _dark(allocation.allocation_id):
            c = self.counters.setdefault(allocation.allocation_id,
                                         NICCounters())
            c.observe(
                flits=int(app_flits.sum()),
                stalled_cycles=int((app_flits * app_stalls).sum()),
                packets=int(app_packets.sum()),
                latency_us_total=float((app_lat * app_packets).sum()),
                notifications=int(notif_flows.sum())
                if notif_flows is not None else 0,
            )

        nonmin_bytes = float(
            (size_all[:n_app, None] * w_app * is_nonmin[None, :]).sum())

        # --- per-tenant link-load breakdown (tenancy path only) ------------
        # One flattened bincount over (tenant-id * n_links + link) segment
        # offsets — the pair-list machinery with the tenant id as an
        # extra segment axis; row K is the background job's share, and the
        # rows sum to the global backlog load_q (tests/test_tenancy.py).
        t_loads = t_nonmin = None
        if tenants is not None:
            K = len(tenants)
            w_np = np.asarray(w)
            fc_rows = pair_fc // ncand
            seg = np.full(pair_fc.shape[0], K, dtype=np.int64)
            app_pair = fc_rows < n_app
            seg[app_pair] = tenant_of[fc_rows[app_pair]]
            vals_q = (size_all[:, None] * w_np).ravel()[pair_fc]
            t_loads = np.bincount(
                seg * topo.n_links + pair_links, weights=vals_q,
                minlength=(K + 1) * topo.n_links,
            ).reshape(K + 1, topo.n_links)
            nm_flow = (size[:n_app, None] * w_app
                       * is_nonmin[None, :]).sum(axis=1)
            nm_t = np.bincount(tenant_of, weights=nm_flow, minlength=K)
            bytes_t = np.bincount(tenant_of, weights=size[:n_app],
                                  minlength=K)
            t_nonmin = nm_t / np.maximum(bytes_t, 1e-9)
        if prof:
            self._stage("finalize", t0)
        return FlowResult(
            t_us=t_us[:n_app],
            latency_us=app_lat,
            stalls_per_flit=app_stalls,
            flits=app_flits,
            packets=app_packets,
            nonmin_fraction=nonmin_bytes / max(float(size[:n_app].sum()), 1e-9),
            tenant_of=tenant_of,
            tenant_link_loads=t_loads,
            link_load_q=np.asarray(load_q) if tenants is not None else None,
            tenant_nonmin_fraction=t_nonmin,
            stranded=stranded[:n_app] if stranded is not None else None,
            notified=flow_notified,
        )

    # ----------------------------------------------------------------- misc
    def reset_queues(self, *, include_estimates: bool = True) -> None:
        """Clear the network's residual congestion state.

        Shared-vs-isolated contract (docs/interference.md): ONE simulator
        models ONE physical network, so back-to-back ``run_phase`` calls
        SHARE link queues and the stale-estimate memory BY DESIGN — that
        sharing is exactly how co-running allocations become each other's
        noise in the tenancy engine.  For ISOLATED experiments (run-alone
        baselines, reusing a simulator across independent scenarios) call
        ``reset_queues()`` between them: it clears BOTH the persistent
        link queues and the stale congestion-estimate memory (otherwise a
        previous allocation's drained hotspots would still
        phantom-congest the next allocation's estimates).  Pass
        ``include_estimates=False`` for the partial reset that keeps the
        estimate memory.  Per-allocation NIC counters
        are already isolated per allocation_id and never leak."""
        self.link_queue_s[:] = 0.0
        # notification flags are congestion state like the queues that
        # raised them: an isolated experiment must not inherit a previous
        # scenario's visible flags (the same leak class as a kept
        # est_memory_s)
        if (self.link_notify_age >= 0).any():
            if self.notified_links.any():
                self._notify_epoch += 1
            self.link_notify_age[:] = -1
        if include_estimates:
            self.est_memory_s[:] = 0.0


def run_phase_batch(calls) -> list:
    """Run several simulators' phases, fusing compatible pipelines.

    ``calls``: sequence of ``(sim, kwargs)`` pairs — each ``kwargs`` is
    one `DragonflySimulator.run_phase` argument dict; one simulator may
    not appear twice in a batch (raises ValueError).  Per-sim host
    halves (`_phase_begin` / `_phase_finish`) run exactly as in
    sequential ``run_phase`` calls, in call order — same RNG draws, same
    state updates — while phases whose
    :func:`~repro_torch.dragonfly.torch_backend.batch_signature`s agree
    (same device, same shapes) are evaluated through ONE batched
    pipeline dispatch (`torch_backend.fixed_point_torch_batch`).  A
    phase alone in its group runs its pipeline per-sim.  Returns the
    [FlowResult] list in call order.

    This is the tenancy lockstep driver's primitive: whole sweep
    columns (same mix, different victim arms) advance round-for-round
    with every cell's phase batched into one dispatch."""
    if len({id(sim) for sim, _ in calls}) != len(calls):
        raise ValueError("run_phase_batch: a simulator appears twice in "
                         "one batch")
    ctxs = [sim._phase_begin(**kw) for sim, kw in calls]
    outs: dict = {}
    groups: dict = {}
    for i, ((sim, _), ctx) in enumerate(zip(calls, ctxs)):
        if ctx["result"] is None:
            groups.setdefault(batch_signature(sim, ctx), []).append(i)
    for idxs in groups.values():
        if len(idxs) < 2:
            continue
        batch = [(calls[i][0], ctxs[i]) for i in idxs]
        for i, o in zip(idxs, fixed_point_torch_batch(batch)):
            outs[i] = o
    results = []
    for i, ((sim, _), ctx) in enumerate(zip(calls, ctxs)):
        if ctx["result"] is not None:
            results.append(ctx["result"])
            continue
        out = outs.get(i)
        if out is None:
            out = sim._run_kernel(ctx)
        results.append(sim._phase_finish(ctx, out))
    return results
