"""InterferenceEngine — K co-running jobs on ONE batched simulator.

Each round interleaves every tenant's next phase into a single flattened
flow batch (`TenantSegments` marks the per-tenant segments), runs it
through `DragonflySimulator.run_phase(tenants=...)` — one fixed point
over the SHARED links, whose link loads go through the segment sum —
and splits the observables back out per tenant: completion time, NIC
counters, latency/stall feedback to each tenant's PolicyEngine, and the
per-tenant link-load breakdown.

Victim slowdown (the interference matrix's cell metric) is the mix time
divided by a run-alone baseline: the same tenant, same allocation, same
seed, on a FRESH simulator with nobody else on the machine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.counters import NICCounters
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.simulator import (DragonflySimulator, SimParams,
                                       TenantSegments)
from repro_torch.dragonfly.topology import Topology, make_topology
from repro_torch.dragonfly.traffic import PATTERN_KIND, engine_for_arm
from repro_torch.policy import DecisionBatch, KIND_PT2PT
from repro_torch.runtime import resolve_device
from repro_torch.tenancy.spec import TenancyMix, Workload


def arm_label(arm) -> str:
    """Stable display/JSON label of a routing arm."""
    return arm if isinstance(arm, str) else getattr(arm, "name", str(arm))


@dataclass
class TenantReport:
    """One tenant's observables over a mix run."""

    name: str
    arm: str
    time_us: float                    # sum of per-round completion + host
    mean_latency_us: float
    mean_stalls: float
    nonmin_fraction: float            # byte-weighted, from the breakdown
    nic: NICCounters                  # this allocation's counter snapshot
    alone_time_us: float | None = None
    #: per-round completion + host time (recovery metrics need the
    #: trajectory, not just the sum)
    round_times_us: list = field(default_factory=list)
    #: app flows that lost every candidate path to faults, summed over
    #: rounds (docs/faults.md)
    stranded_flows: int = 0
    #: fault recovery (run_mix(faults=...) only, docs/faults.md):
    #: rounds after the last fault clears until the per-round time is
    #: back within tolerance of the pre-fault baseline, and the time
    #: spent above baseline getting there.  -1 = never recovered within
    #: the run; None = no faults / faults never clear.
    recovery_rounds: int | None = None
    recovery_time_us: float | None = None

    @property
    def slowdown(self) -> float | None:
        """Mix time over run-alone time (1.0 == no interference)."""
        if self.alone_time_us is None or self.alone_time_us <= 0.0:
            return None
        return self.time_us / self.alone_time_us


@dataclass
class MixResult:
    """One (mix, policy, placement) cell of the interference matrix."""

    mix: str
    rounds: int
    victim: int
    tenants: list                     # [TenantReport], tenant order
    #: [K+1, n_links] mean per-round backlog bytes (row K = background)
    tenant_link_loads: np.ndarray | None = None
    #: fault schedule summary when run with run_mix(faults=...), else None
    faults: list | None = None

    @property
    def victim_report(self) -> TenantReport:
        return self.tenants[self.victim]

    @property
    def victim_slowdown(self) -> float | None:
        return self.victim_report.slowdown


class InterferenceEngine:
    """Run TenancyMix instances and score per-tenant interference.

    shared_engine: tenants whose arm is the SAME policy name share one
    PolicyEngine; their per-site learned state stays separate because
    decision sites are namespaced ``(tenant_name, pattern)`` — recover a
    tenant's view with `repro_torch.policy.scoped_site_filter(tenant_name)`.
    Default is one engine per tenant (independent jobs).
    """

    #: §5.1 counter-read overhead paid per phase by engine-driven arms
    counter_read_overhead_us: float = 0.35

    def __init__(self, topo: Topology | str | None = None,
                 params: SimParams | None = None, *,
                 seed: int = 0, shared_engine: bool = False, device=None):
        #: where every simulator this engine builds runs its phase
        #: pipeline: the CUDA card unless device="cpu" (raises when CUDA
        #: is requested but absent)
        self.device = resolve_device(device)
        self.params = params or SimParams()
        # topo may be a Topology, a make_topology spec string, or None
        # (resolve SimParams.topology); a mix's own `topology` overrides
        self.topo = make_topology(topo if topo is not None
                                  else self.params.topology)
        self.seed = seed
        self.shared_engine = shared_engine
        self._base_policy = RoutingPolicy(RoutingMode.ADAPTIVE_0)

    # ----------------------------------------------------------- internals
    def _engines_for(self, workloads: Sequence[Workload],
                     sim: DragonflySimulator) -> dict:
        """tenant index -> PolicyEngine for every named-policy arm."""
        engines: dict = {}
        by_name: dict = {}
        for k, w in enumerate(workloads):
            if not w.is_engine_arm:
                continue
            if self.shared_engine and w.arm in by_name:
                engines[k] = by_name[w.arm]
                continue
            eng = engine_for_arm(w.arm, sim, seed=self.seed + k)
            engines[k] = by_name[w.arm] = eng
        return engines

    def _topo_for(self, mix: TenancyMix) -> Topology:
        """The machine a mix runs on: its own topology spec, else ours."""
        return make_topology(mix.topology) if mix.topology else self.topo

    def _run(self, workloads: Sequence[Workload], allocs: Sequence,
             rounds: int, topo: Topology | None = None, faults=None):
        """Core loop: returns ([TenantReport], mean tenant_link_loads).

        Sequential driver over `_run_steps` — one run_phase per yielded
        request.  `run_mixes_lockstep` drives the same generator with
        phases batched across cells; both orderings are identical per
        cell because each generator owns its simulator and RNG."""
        gen = self._run_steps(workloads, allocs, rounds, topo=topo,
                              faults=faults)
        res = None
        while True:
            try:
                sim, kwargs = gen.send(res)
            except StopIteration as stop:
                return stop.value
            res = sim.run_phase(**kwargs)

    def _run_steps(self, workloads: Sequence[Workload], allocs: Sequence,
                   rounds: int, topo: Topology | None = None, faults=None):
        """Core loop as a generator: yields ``(sim, run_phase kwargs)``
        per round, receives the FlowResult back via ``send``, and
        returns ([TenantReport], mean tenant_link_loads).

        Builds a FRESH simulator (deterministic in SimParams.seed), so a
        K=1 call is the run-alone baseline of that tenant on the same
        nodes — and is bit-identical, round for round, to driving
        run_phase(allocation=...) by hand (tests/test_tenancy.py).

        `faults` (optional FaultSchedule, docs/faults.md): phase indices
        are ROUND indices (one run_phase per round).  On every fault-
        epoch transition each engine-armed tenant's policy samples are
        reset via ``on_fault_epoch`` — measurements from the previous
        link set would contaminate Algorithm 1's regime decisions.
        """
        sim = DragonflySimulator(topo if topo is not None else self.topo,
                                 self.params, faults=faults,
                                 device=self.device)
        p = self.params
        engines = self._engines_for(workloads, sim)
        phases = [w.phases() for w in workloads]
        K = len(workloads)
        time_us = np.zeros(K)
        lat: list = [[] for _ in range(K)]
        stl: list = [[] for _ in range(K)]
        nmf: list = [[] for _ in range(K)]
        wts: list = [[] for _ in range(K)]
        round_t: list = [[] for _ in range(K)]
        stranded = np.zeros(K, dtype=np.int64)
        loads_acc = None
        last_epoch = 0
        for r in range(rounds):
            if sim.faults is not None:
                ep = sim.faults.epoch_at(r)
                if ep != last_epoch:
                    last_epoch = ep
                    from repro_torch.policy import scoped_site_filter
                    for k, w in enumerate(workloads):
                        if w.is_engine_arm:
                            engines[k].on_fault_epoch(
                                scoped_site_filter(w.name))
            srcs, dsts, byts, mode_l, counts = [], [], [], [], []
            for k, w in enumerate(workloads):
                s, d, b = phases[k][r % len(phases[k])]
                nodes = np.asarray(allocs[k].nodes)
                srcs.append(nodes[s])
                dsts.append(nodes[d])
                byts.append(np.asarray(b, dtype=np.float64))
                counts.append(len(b))
                if w.is_engine_arm:
                    batch = DecisionBatch.of(
                        b, site=(w.name, w.pattern),
                        kind=PATTERN_KIND.get(w.pattern, KIND_PT2PT))
                    mode_l.append(np.asarray(engines[k].decide(batch),
                                             dtype=object))
                else:
                    m = np.empty(len(b), dtype=object)
                    m[:] = w.arm
                    mode_l.append(m)
            seg = TenantSegments.of(allocs, counts)
            res = yield sim, dict(
                src_nodes=np.concatenate(srcs),
                dst_nodes=np.concatenate(dsts),
                bytes_=np.concatenate(byts), policy=self._base_policy,
                modes=np.concatenate(mode_l), tenants=seg)
            if res.tenant_link_loads is not None:
                loads_acc = res.tenant_link_loads if loads_acc is None \
                    else loads_acc + res.tenant_link_loads
            # split observables back out, tenant order (the host-noise
            # draws consume sim.rng in this order: K=1 matches the
            # single-app run_iteration stream exactly)
            for k, w in enumerate(workloads):
                rows = res.tenant_slice(k)
                if w.is_engine_arm and rows.size:
                    # post-send counter read feeding THIS tenant's engine
                    # (notified exposure sliced per tenant like (L, s):
                    # no cross-tenant leakage through the new counter)
                    nf = res.notified
                    if rows.size == counts[k]:
                        engines[k].bus.publish_flow_arrays(
                            res.latency_us[rows], res.stalls_per_flit[rows],
                            notified=None if nf is None else nf[rows])
                    else:
                        # statistically subsampled: phase-mean sample
                        engines[k].bus.publish_flow_arrays(
                            [float(res.latency_us[rows].mean())],
                            [float(res.stalls_per_flit[rows].mean())],
                            notified=None if nf is None
                            else [float(nf[rows].mean())])
                host = p.host_overhead_us * sim.rng.lognormal(
                    0.0, p.host_noise_sigma)
                if w.is_engine_arm:
                    host += self.counter_read_overhead_us
                t_k = float(res.t_us[rows].max()) if rows.size else 0.0
                time_us[k] += t_k + host
                round_t[k].append(t_k + host)
                if res.stranded is not None and rows.size:
                    stranded[k] += int(res.stranded[rows].sum())
                if rows.size:
                    lat[k].append(float(res.latency_us[rows].mean()))
                    stl[k].append(float(res.stalls_per_flit[rows].mean()))
                    nmf[k].append(float(res.tenant_nonmin_fraction[k]))
                    wts[k].append(float(byts[k].sum()))
        reports = []
        for k, w in enumerate(workloads):
            wk = np.asarray(wts[k]) if wts[k] else np.ones(1)
            reports.append(TenantReport(
                name=w.name, arm=arm_label(w.arm),
                time_us=float(time_us[k]),
                mean_latency_us=float(np.average(lat[k], weights=wk))
                if lat[k] else 0.0,
                mean_stalls=float(np.average(stl[k], weights=wk))
                if stl[k] else 0.0,
                nonmin_fraction=float(np.average(nmf[k], weights=wk))
                if nmf[k] else 0.0,
                nic=sim.counters.get(allocs[k].allocation_id,
                                     NICCounters()).snapshot(),
                round_times_us=round_t[k],
                stranded_flows=int(stranded[k])))
        if loads_acc is not None and rounds:
            loads_acc = loads_acc / rounds
        return reports, loads_acc

    # ------------------------------------------------------------- public
    def run_alone(self, mix: TenancyMix, k: int, *, rounds: int = 4,
                  allocs: Sequence | None = None) -> TenantReport:
        """Tenant k's run-alone baseline: same allocation, empty machine."""
        topo = self._topo_for(mix)
        allocs = allocs if allocs is not None \
            else mix.materialize(topo, seed=self.seed)
        reports, _ = self._run((mix.workloads[k],), [allocs[k]], rounds,
                               topo=topo)
        return reports[0]

    #: a round counts as recovered when its time is back within this
    #: factor of the pre-fault per-round baseline
    recovery_tolerance: float = 1.10

    def _recovery(self, times: list, faults, clean=None) -> tuple:
        """(recovery_rounds, recovery_time_us) from one tenant's
        per-round trajectory (docs/faults.md).

        `clean` (when given) is the same tenant's round trajectory from
        a fault-free companion run of the SAME mix/seed — the round-for-
        round baseline.  Workload phase lists cycle (round r replays
        phase ``r % L``), so per-round times are periodic and a flat
        scalar baseline would misread phase structure as non-recovery;
        the companion trajectory compares like phase with like phase.
        Without `clean`, baseline falls back to the mean pre-fault
        per-round time (min over the run when faults start at round 0).

        From the round the last fault clears, the first round back
        within ``recovery_tolerance`` of its baseline marks recovery;
        the rounds until then and the time they consumed are the
        metrics.  (None, None) when the faults never clear inside the
        run; (-1, -1.0) when they clear but the tenant never gets back
        to baseline.
        """
        first = faults.first_start()
        clear = faults.all_clear_phase()
        if first is None or clear is None or clear >= len(times):
            return None, None
        if clean is None:
            base = float(np.mean(times[:first])) if first > 0 \
                else float(np.min(times))
            clean = [base] * len(times)
        for i in range(clear, len(times)):
            if times[i] <= self.recovery_tolerance * clean[i]:
                return i - clear, float(np.sum(times[clear:i]))
        return -1, -1.0

    def run_mix(self, mix: TenancyMix, *, rounds: int = 4,
                baselines: bool = True, faults=None) -> MixResult:
        """Run the whole mix; with baselines, score per-tenant slowdown.

        `faults` (optional FaultSchedule): inject faults into the mix
        run — round index == fault phase index.  Run-alone baselines
        stay CLEAN (healthy machine), so victim slowdown under faults
        reports the tenant's TOTAL degradation (interference + faults);
        comparing policies under the same schedule isolates the policy
        effect.  Per-tenant recovery metrics (recovery_rounds /
        recovery_time_us) are scored against a fault-free companion run
        of the same mix (round-for-round baseline, see _recovery).
        """
        topo = self._topo_for(mix)
        allocs = mix.materialize(topo, seed=self.seed)
        reports, loads = self._run(mix.workloads, allocs, rounds,
                                   topo=topo, faults=faults)
        if baselines:
            for k in range(len(mix)):
                alone = self.run_alone(mix, k, rounds=rounds, allocs=allocs)
                reports[k].alone_time_us = alone.time_us
        if faults:
            clean, _ = self._run(mix.workloads, allocs, rounds, topo=topo)
            for rep, ref in zip(reports, clean):
                rep.recovery_rounds, rep.recovery_time_us = \
                    self._recovery(rep.round_times_us, faults,
                                   clean=ref.round_times_us)
        return MixResult(mix=mix.name, rounds=rounds, victim=mix.victim,
                         tenants=reports, tenant_link_loads=loads,
                         faults=faults.describe() if faults else None)


# ------------------------------------------------------- lockstep driving
def _drive_lockstep(gens) -> list:
    """Advance several `_run_steps` generators round-for-round.

    Each round, every live generator's pending phase request is handed
    to `run_phase_batch` as ONE call — cells on one device with
    matching kernel shapes run as a single batched dispatch.  Per-cell results
    are identical to sequential driving: each generator owns its
    simulator and RNG stream, so only the dispatch is shared."""
    from repro_torch.dragonfly.simulator import run_phase_batch

    rets = [None] * len(gens)
    reqs = [None] * len(gens)
    live = []
    for i, gen in enumerate(gens):
        try:
            reqs[i] = gen.send(None)
            live.append(i)
        except StopIteration as stop:
            rets[i] = stop.value
    while live:
        outs = run_phase_batch([reqs[i] for i in live])
        nxt = []
        for i, res in zip(live, outs):
            try:
                reqs[i] = gens[i].send(res)
                nxt.append(i)
            except StopIteration as stop:
                rets[i] = stop.value
        live = nxt
    return rets


def run_mixes_lockstep(engines, mixes, *, rounds: int = 4,
                       baselines: bool = True) -> list:
    """[MixResult] for N (engine, mix) cells advanced in lockstep.

    The batched counterpart of ``[e.run_mix(m) for e, m in ...]`` for
    fault-free cells: every cell's round-r phase kernel is dispatched
    together through `run_phase_batch` (one batched pipeline dispatch when the
    column's shapes agree — the sweep-column case, where cells differ
    only in the victim's routing arm), and so are the per-tenant
    run-alone baselines.  Cell-for-cell results match the sequential
    path: batching changes the dispatch, never the draws."""
    prepped = []
    for eng, mix in zip(engines, mixes):
        topo = eng._topo_for(mix)
        allocs = mix.materialize(topo, seed=eng.seed)
        prepped.append((eng, mix, topo, allocs))
    outs = _drive_lockstep([
        eng._run_steps(mix.workloads, allocs, rounds, topo=topo)
        for eng, mix, topo, allocs in prepped])
    alone: dict = {}
    if baselines:
        for k in range(max(len(m) for _, m, _, _ in prepped)):
            idx = [i for i, (_, m, _, _) in enumerate(prepped)
                   if k < len(m)]
            base = _drive_lockstep([
                prepped[i][0]._run_steps(
                    (prepped[i][1].workloads[k],), [prepped[i][3][k]],
                    rounds, topo=prepped[i][2])
                for i in idx])
            for i, (reports, _) in zip(idx, base):
                alone[(i, k)] = reports[0].time_us
    results = []
    for i, ((eng, mix, topo, allocs), (reports, loads)) in \
            enumerate(zip(prepped, outs)):
        for k, rep in enumerate(reports):
            if (i, k) in alone:
                rep.alone_time_us = alone[(i, k)]
        results.append(MixResult(mix=mix.name, rounds=rounds,
                                 victim=mix.victim, tenants=reports,
                                 tenant_link_loads=loads, faults=None))
    return results
