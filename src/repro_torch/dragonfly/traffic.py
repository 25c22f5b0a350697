"""Communication patterns of the paper's microbenchmarks (§5.1) and the
benchmark runner that alternates routing modes per iteration (§5 protocol).

A pattern is a generator of *phases*; one phase is a (src_ranks, dst_ranks,
bytes) triple of concurrent flows.  Rank->node resolution happens against a
fixed Allocation (§3.1).

Port of ``repro/dragonfly/traffic.py``: the pattern generators, the
static ``run_iteration`` and the policy-engine runners
(``run_iteration_engine``, ``engine_for_arm``, ``run_benchmark``) over
the port's simulator and its copy of ``repro.policy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.simulator import DragonflySimulator
from repro_torch.dragonfly.topology import Allocation
from repro_torch.policy import (AppAwareConfig, DecisionBatch, KIND_ALLREDUCE,
                                KIND_ALLTOALL, KIND_BROADCAST, KIND_PT2PT,
                                PolicyEngine, TelemetryBus, make_engine)

Phase = tuple[np.ndarray, np.ndarray, np.ndarray]  # (src_ranks, dst_ranks, bytes)


# --------------------------------------------------------------- primitives
def _phase(srcs, dsts, size) -> Phase:
    s = np.asarray(srcs, dtype=np.int64)
    d = np.asarray(dsts, dtype=np.int64)
    b = np.full(s.shape, float(size)) if np.isscalar(size) \
        else np.asarray(size, dtype=np.float64)
    return s, d, b


def pingpong(n_ranks: int, size: int) -> list[Phase]:
    assert n_ranks >= 2
    return [_phase([0], [1], size), _phase([1], [0], size)]


def allreduce(n_ranks: int, elements: int, elem_bytes: int = 4) -> list[Phase]:
    """Recursive-doubling allreduce (size constant per round)."""
    size = elements * elem_bytes
    rounds = max(1, int(math.ceil(math.log2(max(n_ranks, 2)))))
    phases = []
    for r in range(rounds):
        stride = 1 << r
        ranks = np.arange(n_ranks)
        peers = ranks ^ stride
        ok = peers < n_ranks
        phases.append(_phase(ranks[ok], peers[ok], size))
    return phases


def alltoall(n_ranks: int, size_per_pair: int) -> list[Phase]:
    """Single bulk phase with all n*(n-1) pairwise flows (packet-level
    alltoall; the NIC pipelines all destinations concurrently)."""
    ranks = np.arange(n_ranks)
    src = np.repeat(ranks, n_ranks - 1)
    dst = np.concatenate([np.delete(ranks, i) for i in range(n_ranks)])
    return [_phase(src, dst, size_per_pair)]


def barrier(n_ranks: int, _size: int = 8) -> list[Phase]:
    """Dissemination barrier: ceil(log2 n) rounds of 8-byte tokens."""
    rounds = max(1, int(math.ceil(math.log2(max(n_ranks, 2)))))
    phases = []
    ranks = np.arange(n_ranks)
    for r in range(rounds):
        peers = (ranks + (1 << r)) % n_ranks
        phases.append(_phase(ranks, peers, 8))
    return phases


def broadcast(n_ranks: int, size: int) -> list[Phase]:
    """Binomial-tree broadcast from rank 0."""
    phases = []
    have = 1
    while have < n_ranks:
        senders = np.arange(min(have, n_ranks - have))
        receivers = senders + have
        receivers = receivers[receivers < n_ranks]
        senders = senders[: len(receivers)]
        phases.append(_phase(senders, receivers, size))
        have *= 2
    return phases


def _grid_dims(n: int, dims: int) -> list[int]:
    """Near-cubic factorization of n into `dims` factors (MPI_Dims_create)."""
    out = [1] * dims
    f = n
    primes = []
    d = 2
    while d * d <= f:
        while f % d == 0:
            primes.append(d)
            f //= d
        d += 1
    if f > 1:
        primes.append(f)
    for prm in sorted(primes, reverse=True):
        out[out.index(min(out))] *= prm
    return sorted(out, reverse=True)


def halo3d(n_ranks: int, nx: int, var_bytes: int = 8,
           vars_: int = 1) -> list[Phase]:
    """Nearest-neighbor 3D stencil (ember halo3d): 6 face exchanges.

    nx is the global cubic domain edge; each rank owns (nx/px, nx/py, nx/pz)
    and exchanges faces with +-x, +-y, +-z neighbors."""
    px, py, pz = _grid_dims(n_ranks, 3)
    lx, ly, lz = nx // px, nx // py, nx // pz
    face = {0: ly * lz, 1: lx * lz, 2: lx * ly}
    ranks = np.arange(n_ranks)
    z, rem = np.divmod(ranks, px * py)
    y, x = np.divmod(rem, px)
    coords = [x, y, z]
    dims = [px, py, pz]
    phases = []
    for axis in range(3):
        for sign in (+1, -1):
            nb = [c.copy() for c in coords]
            nb[axis] = coords[axis] + sign
            ok = (nb[axis] >= 0) & (nb[axis] < dims[axis])
            dst = nb[0] + nb[1] * px + nb[2] * px * py
            size = face[axis] * var_bytes * vars_
            phases.append(_phase(ranks[ok], dst[ok], size))
    return phases


def sweep3d(n_ranks: int, nx: int, var_bytes: int = 8) -> list[Phase]:
    """Wavefront sweep (ember sweep3d): 2D process grid (px, py), the
    wavefront starts at a corner and pipelines +x then +y pencils."""
    px, py = _grid_dims(n_ranks, 2)
    lx, ly = nx // px, nx // py
    pencil = lx * var_bytes * max(nx // max(px, py), 1)
    phases = []
    for wave in range(px + py - 1):
        srcs, dsts = [], []
        for i in range(px):
            j = wave - i
            if 0 <= j < py:
                if i + 1 < px:
                    srcs.append(i + j * px)
                    dsts.append((i + 1) + j * px)
                if j + 1 < py:
                    srcs.append(i + j * px)
                    dsts.append(i + (j + 1) * px)
        if srcs:
            phases.append(_phase(srcs, dsts, pencil))
    del ly
    return phases


def moe_alltoall(n_ranks: int, tokens_per_rank: int = 4096,
                 token_bytes: int = 2048, zipf_alpha: float = 1.0,
                 seed: int = 0) -> list[Phase]:
    """Expert-parallel MoE dispatch/combine: a SKEWED all-to-all.

    The EP layer (repro.collectives.moe_ep) routes each token to its
    top-1 expert, one expert shard per rank; router logits are never
    uniform, so hot experts concentrate traffic — the rank-level
    byte matrix is an alltoall whose columns follow a Zipf popularity
    curve instead of a constant.  Two bulk phases per layer step:
    dispatch (token -> expert) and combine (the mirror transpose).
    `token_bytes` is one token's hidden activation (d_model * bf16).
    Seeded and deterministic: the popularity permutation is drawn once
    from `seed`, like the EP router's frozen gate."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(n_ranks)
    pop = 1.0 / np.power(ranks + 1.0, zipf_alpha)
    pop = rng.permutation(pop / pop.sum())       # expert popularity [n]
    src = np.repeat(ranks, n_ranks - 1)
    dst = np.concatenate([np.delete(ranks, i) for i in range(n_ranks)])
    # tokens_per_rank * P(expert at dst) bytes from every sender, floored
    # at one token so no pair degenerates to zero
    size = np.maximum(tokens_per_rank * pop[dst], 1.0) * token_bytes
    dispatch = _phase(src, dst, size)
    combine = _phase(dst, src, size)
    return [dispatch, combine]


PATTERNS: dict[str, Callable[..., list[Phase]]] = {
    "pingpong": pingpong,
    "allreduce": allreduce,
    "alltoall": alltoall,
    "barrier": barrier,
    "broadcast": broadcast,
    "halo3d": halo3d,
    "sweep3d": sweep3d,
    "moe_alltoall": moe_alltoall,
}


# ------------------------------------------------------------------ running
@dataclass
class IterationResult:
    time_us: float
    mean_latency_us: float
    mean_stalls: float
    nonmin_fraction: float
    mode_bytes: dict = field(default_factory=dict)


def run_iteration(sim: DragonflySimulator, alloc: Allocation,
                  phases: Sequence[Phase],
                  policy: RoutingPolicy, *,
                  use_plans: bool = False) -> IterationResult:
    """One benchmark iteration under a fixed routing mode.

    `use_plans=True` routes each phase through the simulator's
    content-addressed PhasePlan cache, so iteration loops stop redrawing
    candidate paths for identical traffic (see the reuse contract in
    docs/performance.md — seeded-deterministic, but a different RNG
    consumption than planless runs)."""
    total_us = 0.0
    lat, st, nmf, wts = [], [], [], []
    host_rng = sim.rng
    for (s, d, b) in phases:
        nodes = np.asarray(alloc.nodes)
        plan = sim.plan_for(nodes[s], nodes[d], b) if use_plans else None
        res = sim.run_phase(nodes[s], nodes[d], b, policy, alloc,
                            plan=plan)
        host = sim.params.host_overhead_us * host_rng.lognormal(
            0.0, sim.params.host_noise_sigma)
        total_us += res.phase_time_us + host
        if res.t_us.size:
            lat.append(res.latency_us.mean())
            st.append(res.stalls_per_flit.mean())
            nmf.append(res.nonmin_fraction)
            wts.append(b.sum())
    w = np.asarray(wts) if wts else np.ones(1)
    return IterationResult(
        time_us=total_us,
        mean_latency_us=float(np.average(lat, weights=w)) if lat else 0.0,
        mean_stalls=float(np.average(st, weights=w)) if st else 0.0,
        nonmin_fraction=float(np.average(nmf, weights=w)) if nmf else 0.0,
    )


#: pattern name -> DecisionBatch collective kind (Algorithm 1 only
#: special-cases alltoall; the rest is labeling for telemetry/policies).
PATTERN_KIND = {
    "pingpong": KIND_PT2PT,
    "allreduce": KIND_ALLREDUCE,
    "alltoall": KIND_ALLTOALL,
    "barrier": KIND_PT2PT,
    "broadcast": KIND_BROADCAST,
    "halo3d": KIND_PT2PT,
    "sweep3d": KIND_PT2PT,
    "moe_alltoall": KIND_ALLTOALL,
}


def run_iteration_engine(sim: DragonflySimulator, alloc: Allocation,
                         phases: Sequence[Phase], engine: PolicyEngine, *,
                         site: str = "default", kind: str = KIND_PT2PT,
                         base_policy: RoutingPolicy | None = None,
                         counter_read_overhead_us: float = 0.35,
                         use_plans: bool = False
                         ) -> IterationResult:
    """One iteration with a PolicyEngine choosing modes per phase.

    This is the vectorized successor of the per-message router protocol:
    ONE engine.decide() per phase (thousands of flows in a single
    NumPy-shaped batch), modes applied per flow inside the simulator, and
    one TelemetryBus publish of the phase's per-flow (L, s) — the
    counters are read after the send, so the policy stays one phase
    behind (paper §4.3), paying the same §5.1 counter-read overhead."""
    base_policy = base_policy or RoutingPolicy(RoutingMode.ADAPTIVE_0)
    total_us = 0.0
    lat, st, nmf, wts = [], [], [], []
    mode_bytes: dict = {}
    nodes = np.asarray(alloc.nodes)
    for (s, d, b) in phases:
        batch = DecisionBatch.of(b, site=site, kind=kind)
        modes = engine.decide(batch)          # ONE call for the whole phase
        plan = sim.plan_for(nodes[s], nodes[d], b) if use_plans else None
        res = sim.run_phase(nodes[s], nodes[d], b, base_policy, alloc,
                            modes=modes, plan=plan)
        # post-send counter read (never delays the message itself)
        if res.t_us.size == len(batch):
            engine.bus.publish_flow_arrays(res.latency_us,
                                           res.stalls_per_flit,
                                           notified=res.notified)
        elif res.t_us.size:
            # the simulator statistically subsampled the phase: publish
            # the phase-mean sample (engine broadcasts it over the batch)
            engine.bus.publish_flow_arrays(
                [float(res.latency_us.mean())],
                [float(res.stalls_per_flit.mean())],
                notified=None if res.notified is None
                else [float(res.notified.mean())])
        host = sim.params.host_overhead_us * sim.rng.lognormal(
            0.0, sim.params.host_noise_sigma) + counter_read_overhead_us
        total_us += res.phase_time_us + host
        for mode in {m for m in modes}:
            mode_bytes[mode] = mode_bytes.get(mode, 0.0) \
                + float(b[modes == mode].sum())
        if res.t_us.size:
            lat.append(res.latency_us.mean())
            st.append(res.stalls_per_flit.mean())
            nmf.append(res.nonmin_fraction)
            wts.append(b.sum())
    w = np.asarray(wts) if wts else np.ones(1)
    return IterationResult(
        time_us=total_us,
        mean_latency_us=float(np.average(lat, weights=w)) if lat else 0.0,
        mean_stalls=float(np.average(st, weights=w)) if st else 0.0,
        nonmin_fraction=float(np.average(nmf, weights=w)) if nmf else 0.0,
        mode_bytes=mode_bytes,
    )


def run_iteration_app_aware(sim: DragonflySimulator, alloc: Allocation,
                            phases: Sequence[Phase],
                            router, *,
                            alltoall_site: bool = False,
                            counter_read_overhead_us: float = 0.35
                            ) -> IterationResult:
    """DEPRECATED: one iteration with the legacy scalar router protocol.

    Kept for the seed API; new code should pass a PolicyEngine to
    run_iteration_engine.  The router selects before each phase using the
    *previous* phase's counters (the paper's one-message-behind protocol)
    and pays a small counter-read overhead (§5.1 observes this overhead
    on 1KiB alltoalls)."""
    total_us = 0.0
    lat, st, nmf, wts = [], [], [], []
    mode_bytes: dict = {}
    for (s, d, b) in phases:
        msg = float(b.max()) if b.size else 0.0
        mode = router.select(int(msg), alltoall=alltoall_site)
        policy = RoutingPolicy(mode)
        nodes = np.asarray(alloc.nodes)
        res = sim.run_phase(nodes[s], nodes[d], b, policy, alloc)
        # post-send counter read (never delays the message itself)
        if res.t_us.size:
            router.observe(res.latency_us.mean() * 1e3 *
                           sim.params.nic_clock_ghz,
                           res.stalls_per_flit.mean())
        host = sim.params.host_overhead_us * sim.rng.lognormal(
            0.0, sim.params.host_noise_sigma) + counter_read_overhead_us
        total_us += res.phase_time_us + host
        mode_bytes[mode] = mode_bytes.get(mode, 0.0) + float(b.sum())
        if res.t_us.size:
            lat.append(res.latency_us.mean())
            st.append(res.stalls_per_flit.mean())
            nmf.append(res.nonmin_fraction)
            wts.append(b.sum())
    w = np.asarray(wts) if wts else np.ones(1)
    return IterationResult(
        time_us=total_us,
        mean_latency_us=float(np.average(lat, weights=w)) if lat else 0.0,
        mean_stalls=float(np.average(st, weights=w)) if st else 0.0,
        nonmin_fraction=float(np.average(nmf, weights=w)) if nmf else 0.0,
        mode_bytes=mode_bytes,
    )


def engine_for_arm(arm: str, sim: DragonflySimulator,
                   router_config: AppAwareConfig | None = None,
                   seed: int = 0) -> PolicyEngine:
    """Build the PolicyEngine for one adaptive benchmark arm
    ("app_aware" | "eps_greedy" | "static"), clocked to the simulator."""
    bus = TelemetryBus(clock_ghz=sim.params.nic_clock_ghz)
    return make_engine(arm, config=router_config, granularity="phase",
                       seed=seed, bus=bus)


def run_benchmark(sim: DragonflySimulator, alloc: Allocation, pattern: str,
                  pattern_args: dict, iterations: int,
                  modes: Iterable = (RoutingMode.ADAPTIVE_0,
                                     RoutingMode.ADAPTIVE_3, "app_aware"),
                  router_config: AppAwareConfig | None = None,
                  use_plans: bool = False) -> dict:
    """Paper §5 protocol: alternate routing strategies on successive
    iterations inside ONE allocation, so transient noise hits all modes
    equally.  Returns {mode: [IterationResult, ...]}.

    `modes` entries are RoutingMode members (static arms) or policy
    names from repro_torch.policy ("app_aware", "eps_greedy", "static") — each
    named arm gets its own PolicyEngine whose state persists across the
    alternating iterations, exactly like the paper's long-running
    application."""
    phases = PATTERNS[pattern](alloc.n_ranks, **pattern_args)
    kind = PATTERN_KIND.get(pattern, KIND_PT2PT)
    results: dict = {m: [] for m in modes}
    engines = {m: engine_for_arm(m, sim, router_config)
               for m in modes if isinstance(m, str)}
    for _ in range(iterations):
        for mode in modes:
            if isinstance(mode, str):
                results[mode].append(run_iteration_engine(
                    sim, alloc, phases, engines[mode],
                    site=pattern, kind=kind, use_plans=use_plans))
            else:
                results[mode].append(run_iteration(
                    sim, alloc, phases, RoutingPolicy(mode),
                    use_plans=use_plans))
    return results
