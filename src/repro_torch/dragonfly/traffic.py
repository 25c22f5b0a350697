"""Communication patterns of the paper's microbenchmarks (§5.1) and the
fixed-mode iteration runner (§5 protocol).

A pattern is a generator of *phases*; one phase is a (src_ranks, dst_ranks,
bytes) triple of concurrent flows.  Rank->node resolution happens against a
fixed Allocation (§3.1).

Port of ``repro/dragonfly/traffic.py``: the pattern generators and
``run_iteration`` (a static :class:`RoutingPolicy`).  The policy-engine
runners (``run_iteration_engine``, ``engine_for_arm``,
``run_benchmark``) wait for the port of ``repro.policy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.dragonfly.routing import RoutingPolicy
from repro_torch.dragonfly.simulator import DragonflySimulator
from repro_torch.dragonfly.topology import Allocation

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
