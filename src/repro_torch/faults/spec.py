"""Deterministic, seeded fault injection for the Dragonfly simulator.

Real Dragonfly deployments degrade *structurally*, not just through
congestion: links flap, routers die, and telemetry goes stale.  This
module is the declarative substrate — a :class:`FaultSpec` names one
fault (what, which targets, when), a :class:`FaultSchedule` is an
ordered bag of specs, and binding a schedule to a topology yields a
:class:`BoundFaultSchedule` whose ``state_at(phase)`` answers, for any
phase index, "which links are dead, how much capacity survives on the
degraded ones, and whose NIC counters are dark".

Time is *phase-indexed*: faults activate on half-open ``[start, end)``
windows of ``run_phase`` call indices (``end=None`` = forever), and
``link_flap`` toggles with a ``period``/``duty`` square wave inside its
window.  Everything is deterministic — random target draws are resolved
once per (spec, topology) from ``np.random.default_rng(spec.seed)``, so
the same schedule replays bit-identically.

The *fault epoch* counts changes of the active fault set over phases
0..p; the simulator keys its :class:`~repro_torch.dragonfly.simulator.PhasePlan`
cache on it (a plan drawn before a fault must not be replayed across the
epoch boundary), and policy state contaminated by a fault is reset on
epoch transitions.  See docs/faults.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

#: recognised FaultSpec kinds
KINDS = ("link_down", "link_degrade", "router_down", "link_flap",
         "counter_dropout")

#: capacity scale at/below which a link counts as dead (exact 0.0 in
#: practice; the epsilon guards float products of stacked degrades)
DEAD_EPS = 1e-9


def random_links(topo, n: int, seed: int, kind: str | None = "global"):
    """Draw ``n`` distinct *physical* link ids from ``topo``, seeded.

    ``kind`` restricts to one ``link_ranges()`` class ("global",
    "local", ...); None — or a kind the topology does not have (e.g.
    "global" on a fattree) — draws from every non-NIC router-router
    link.  Arithmetic slots no physical link occupies (endpoints
    (-1, -1)) are never drawn.
    """
    sr, dr = topo.link_endpoints()
    physical = sr >= 0                      # router-router links only
    if kind is not None and kind not in topo.link_ranges():
        kind = None
    if kind is not None:
        lo, hi = topo.link_ranges()[kind]
        in_kind = np.zeros(topo.n_links, dtype=bool)
        in_kind[lo:hi] = True
        physical &= in_kind
    pool = np.flatnonzero(physical)
    if pool.size == 0:
        return ()
    rng = np.random.default_rng(seed)
    pick = rng.choice(pool, size=min(n, pool.size), replace=False)
    return tuple(int(x) for x in np.sort(pick))


def random_routers(topo, n: int, seed: int):
    """Draw ``n`` distinct router ids, seeded."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(topo.n_routers, size=min(n, int(topo.n_routers)),
                      replace=False)
    return tuple(int(x) for x in np.sort(pick))


@dataclass(frozen=True)
class FaultSpec:
    """One fault: what breaks, which targets, and when.

    kind            one of :data:`KINDS`
    start, end      half-open active phase window [start, end);
                    ``end=None`` means the fault never clears
    links           explicit link ids (link_* kinds)
    routers         explicit router ids (router_down)
    capacity_frac   surviving capacity fraction (link_degrade; 0 < f < 1)
    period, duty    link_flap square wave: within the window the links
                    are DOWN for ``duty`` phases out of every ``period``
    allocations     counter_dropout scope: allocation ids whose NIC
                    counters stop arriving ("*" = every allocation)
    n_random        additionally draw this many random targets from the
                    topology at bind time (global links, or routers for
                    router_down), seeded by ``seed``
    link_kind       link_ranges() class the random draw samples from
    seed            RNG seed of the random target draw
    """

    kind: str
    start: int = 0
    end: int | None = None
    links: tuple = ()
    routers: tuple = ()
    capacity_frac: float = 0.0
    period: int = 2
    duty: int = 1
    allocations: tuple = ("*",)
    n_random: int = 0
    link_kind: str | None = "global"
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.end is not None and self.end <= self.start:
            raise ValueError("fault window is empty (end <= start)")
        if self.kind == "link_degrade" and not (
                0.0 < self.capacity_frac < 1.0):
            raise ValueError("link_degrade needs 0 < capacity_frac < 1")
        if self.kind == "link_flap" and not (
                1 <= self.duty <= self.period):
            raise ValueError("link_flap needs 1 <= duty <= period")

    def active_at(self, phase: int) -> bool:
        """Is this fault active at ``phase``?  (flap-aware)"""
        if phase < self.start:
            return False
        if self.end is not None and phase >= self.end:
            return False
        if self.kind == "link_flap":
            return (phase - self.start) % self.period < self.duty
        return True

    def describe(self) -> dict:
        """JSON-able summary (benchmark records, docs)."""
        d = {"kind": self.kind, "start": self.start, "end": self.end}
        if self.kind == "router_down":
            d["routers"] = list(self.routers)
        elif self.kind == "counter_dropout":
            d["allocations"] = list(self.allocations)
        else:
            d["links"] = list(self.links)
        if self.kind == "link_degrade":
            d["capacity_frac"] = self.capacity_frac
        if self.kind == "link_flap":
            d["period"], d["duty"] = self.period, self.duty
        if self.n_random:
            d["n_random"] = self.n_random
            d["seed"] = self.seed
        return d


# ----------------------------------------------------- spec constructors
def link_down(links=(), *, start=0, end=None, n_random=0,
              link_kind="global", seed=0) -> FaultSpec:
    """Hard link failure: zero capacity, paths crossing it are masked."""
    return FaultSpec("link_down", start=start, end=end,
                     links=tuple(links), n_random=n_random,
                     link_kind=link_kind, seed=seed)


def link_degrade(capacity_frac: float, links=(), *, start=0, end=None,
                 n_random=0, link_kind="global", seed=0) -> FaultSpec:
    """Soft failure: the links survive at ``capacity_frac`` capacity."""
    return FaultSpec("link_degrade", start=start, end=end,
                     links=tuple(links), capacity_frac=capacity_frac,
                     n_random=n_random, link_kind=link_kind, seed=seed)


def router_down(routers=(), *, start=0, end=None, n_random=0,
                seed=0) -> FaultSpec:
    """Whole-router failure: every incident link (including the NIC
    links of its hosted nodes) goes dead, and — through
    repro.faults.detection — its nodes stop heartbeating."""
    return FaultSpec("router_down", start=start, end=end,
                     routers=tuple(routers), n_random=n_random, seed=seed)


def link_flap(links=(), *, start=0, end=None, period=2, duty=1,
              n_random=0, link_kind="global", seed=0) -> FaultSpec:
    """Flapping link: inside [start, end) the links cycle DOWN for
    ``duty`` phases out of every ``period``."""
    return FaultSpec("link_flap", start=start, end=end,
                     links=tuple(links), period=period, duty=duty,
                     n_random=n_random, link_kind=link_kind, seed=seed)


def counter_dropout(allocations=("*",), *, start=0, end=None) -> FaultSpec:
    """Telemetry fault: the allocations' NIC counters stop arriving
    (no ``NICCounters.observe`` — readers see a frozen snapshot, and
    the PolicyEngine staleness guard eventually trips)."""
    return FaultSpec("counter_dropout", start=start, end=end,
                     allocations=tuple(allocations))


@dataclass(frozen=True)
class FaultState:
    """Resolved machine state for one phase (one active fault set).

    capacity_scale  float64 [n_links]: 1.0 healthy, (0, 1) degraded,
                    0.0 dead.  Shared read-only across phases with the
                    same active set — do not mutate.
    dead            bool [n_links] (capacity_scale <= DEAD_EPS)
    down_routers    router ids currently down
    counters_dark   allocation ids with counter dropout ("*" = all)
    epoch           fault epoch at this phase (see module docstring)
    """

    epoch: int
    capacity_scale: np.ndarray
    dead: np.ndarray
    down_routers: tuple = ()
    counters_dark: frozenset = frozenset()

    @property
    def any_dead(self) -> bool:
        return bool(self.dead.any())

    def counters_blocked(self, allocation_id: str) -> bool:
        """Is this allocation's NIC telemetry dark right now?"""
        return "*" in self.counters_dark \
            or allocation_id in self.counters_dark


@dataclass(frozen=True)
class FaultSchedule:
    """An ordered, topology-independent bag of :class:`FaultSpec`.

    Falsy when empty — ``FaultSchedule()`` is the explicit "no faults"
    schedule, and the simulator guarantees bit-identical output with it
    (tests/test_faults.py)."""

    specs: tuple = ()

    @staticmethod
    def of(*specs) -> "FaultSchedule":
        return FaultSchedule(tuple(specs))

    def __bool__(self) -> bool:
        return bool(self.specs)

    def __len__(self) -> int:
        return len(self.specs)

    def bind(self, topo) -> "BoundFaultSchedule":
        """Resolve random targets against ``topo`` and return the
        phase-queryable bound schedule."""
        return BoundFaultSchedule(self, topo)

    def first_start(self) -> int | None:
        """Earliest phase any fault activates (None when empty)."""
        return min((s.start for s in self.specs), default=None)

    def all_clear_phase(self) -> int | None:
        """First phase at/after which every fault has cleared, or None
        when empty / when some fault never ends."""
        if not self.specs:
            return None
        ends = [s.end for s in self.specs]
        return None if any(e is None for e in ends) else max(ends)

    def describe(self) -> list:
        return [s.describe() for s in self.specs]


class BoundFaultSchedule:
    """A :class:`FaultSchedule` resolved against one topology.

    ``state_at(phase)`` returns the :class:`FaultState` for that phase,
    or None when no fault is active (the simulator's exact-fast-path
    guarantee hangs on that None).  ``epoch_at(phase)`` counts active-set
    changes over phases 0..phase; both walk forward incrementally and
    memoise, so sequential queries are O(1) amortised.
    """

    def __init__(self, schedule: FaultSchedule, topo):
        self.schedule = schedule
        self.topo = topo
        n = topo.n_links
        for spec in schedule.specs:
            bad = [l for l in spec.links if not 0 <= l < n]
            if bad:
                raise ValueError(f"link ids {bad} out of range for "
                                 f"{topo.spec_str()} (n_links={n})")
            badr = [r for r in spec.routers
                    if not 0 <= r < int(topo.n_routers)]
            if badr:
                raise ValueError(f"router ids {badr} out of range for "
                                 f"{topo.spec_str()}")
        self._resolved = [self._resolve(s) for s in schedule.specs]
        self._keys: list = []       # phase -> active spec-index tuple
        self._epochs: list = []     # phase -> epoch
        self._states: dict = {}     # active key -> FaultState sans epoch

    # ------------------------------------------------------------ resolve
    def _resolve(self, spec: FaultSpec):
        """(link_ids int64[], router_ids tuple) for one spec, with
        random targets drawn once from the spec's own seed."""
        topo = self.topo
        routers = tuple(spec.routers)
        links = list(spec.links)
        if spec.n_random:
            if spec.kind == "router_down":
                routers = tuple(sorted(set(routers) | set(
                    random_routers(topo, spec.n_random, spec.seed))))
            else:
                links += list(random_links(topo, spec.n_random, spec.seed,
                                           kind=spec.link_kind))
        if spec.kind == "router_down" and routers:
            sr, dr = topo.link_endpoints()
            down = np.zeros(topo.n_links, dtype=bool)
            for r in routers:
                # router-router links either way, plus NIC links
                # (src == -1, dst == router) of its hosted nodes
                down |= (sr == r) | (dr == r)
            links = list(np.flatnonzero(down))
        return np.asarray(sorted(set(int(l) for l in links)),
                          dtype=np.int64), routers

    # ------------------------------------------------------------- queries
    def _advance_to(self, phase: int) -> None:
        while len(self._keys) <= phase:
            ph = len(self._keys)
            key = tuple(i for i, s in enumerate(self.schedule.specs)
                        if s.active_at(ph))
            prev = self._keys[-1] if self._keys else ()
            prev_ep = self._epochs[-1] if self._epochs else 0
            self._keys.append(key)
            self._epochs.append(prev_ep + (1 if key != prev and ph > 0
                                           else 0))

    def epoch_at(self, phase: int) -> int:
        """Fault epoch at ``phase`` (0 until the first active-set
        change; +1 on every activation/deactivation/flap toggle)."""
        self._advance_to(phase)
        return self._epochs[phase]

    def state_at(self, phase: int) -> FaultState | None:
        """The resolved machine state at ``phase``; None = healthy."""
        self._advance_to(phase)
        key = self._keys[phase]
        if not key:
            return None
        cached = self._states.get(key)
        if cached is None:
            scale = np.ones(self.topo.n_links, dtype=np.float64)
            down_routers: set = set()
            dark: set = set()
            for i in key:
                spec = self.schedule.specs[i]
                links, routers = self._resolved[i]
                if spec.kind == "link_degrade":
                    scale[links] *= spec.capacity_frac
                elif spec.kind in ("link_down", "link_flap",
                                   "router_down"):
                    scale[links] = 0.0
                    down_routers.update(routers)
                elif spec.kind == "counter_dropout":
                    dark.update(spec.allocations)
            cached = self._states[key] = FaultState(
                epoch=0, capacity_scale=scale,
                dead=scale <= DEAD_EPS,
                down_routers=tuple(sorted(down_routers)),
                counters_dark=frozenset(dark))
        ep = self._epochs[phase]
        return cached if cached.epoch == ep else replace(cached, epoch=ep)

    def down_nodes_at(self, phase: int) -> np.ndarray:
        """int64 node ids unreachable at ``phase``: nodes hosted on a
        down router or whose NIC link is dead (detection front end)."""
        state = self.state_at(phase)
        topo = self.topo
        if state is None:
            return np.empty(0, dtype=np.int64)
        nodes = np.arange(topo.n_nodes, dtype=np.int64)
        bad = state.dead[np.asarray(topo.nic_link(nodes))]
        if state.down_routers:
            bad |= np.isin(np.asarray(topo.router_of_node(nodes)),
                           np.asarray(state.down_routers))
        return nodes[bad]
