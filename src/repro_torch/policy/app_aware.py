"""Algorithm 1 — application-aware selection (paper §4.2/§4.3) as a Policy.

This is the canonical home of the paper's algorithm; the legacy
`repro_torch.core.app_aware.AppAwareRouter` is a deprecated shim over it.

Faithful details reproduced from the paper (unchanged from the seed):
  * the application starts in ADAPTIVE (the Aries default);
  * for alltoall call sites, "default" means INCREASINGLY MINIMAL BIAS
    (ADAPTIVE_1), matching MPICH_GNI_A2A_ROUTING_MODE;
  * decision rule Eq. (4):  switch to HIGH BIAS iff
        f < (L_ad - L_bs)/(s_bs - s_ad) * (p+512)/1024
    and the dual inequality to switch back;
  * (L, s) for the *other* mode are estimated by scaling factors λ, σ when
    the stored sample is older than `max_sample_age` selector invocations;
  * a cumulative-size gate: the decision logic runs only once at least
    `cumulative_threshold_bytes` (4 KiB) of traffic has accumulated since
    the last decision; below the gate, messages are sent with HIGH BIAS
    (small messages are latency-bound and HIGH BIAS has lower latency);
  * counters are read after the send so the decision never delays the
    message (the policy is strictly one message behind, as in the paper).

New relative to the seed:
  * per-call-site state (`SiteState`) — one Algorithm-1 automaton per
    (call-site) key, batched through a single `AppAwarePolicy.decide`;
  * gate-forced traffic is ledgered separately from decision-routed
    traffic, so `traffic_fraction(mode, include_gated=False)` matches
    Fig. 8/9's '% sent via Default' semantics (gated small messages are
    physically HIGH BIAS but are not mode_b *decisions*);
  * two batching granularities: "message" replays the legacy per-message
    protocol row by row (used by the shim and the equivalence tests);
    "phase" runs one decision per (site, kind) group using the group's
    max message size — exactly what the benchmark runner did per phase —
    so a simulator step with thousands of flows costs one automaton step
    and pure NumPy fills.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Hashable, Optional

import numpy as np

from repro_torch.core.perf_model import (flits_and_packets, flits_and_packets_vec,
                                   transmission_cycles_eq2)
from repro_torch.core.strategies import ModePerformance
from repro_torch.core.strategies import RoutingMode
from repro_torch.policy.types import (DecisionBatch, Feedback, KIND_ALLTOALL,
                                TrafficLedger)


@dataclass(frozen=True)
class AppAwareConfig:
    """Configuration of Algorithm 1 (the seed's RouterConfig, renamed)."""

    mode_a: Hashable = RoutingMode.ADAPTIVE_0      # "Default"/spread schedule
    mode_b: Hashable = RoutingMode.ADAPTIVE_3      # high-bias/minimal schedule
    #: default mode_a replacement for alltoall call sites (paper §4.2 end).
    mode_a_alltoall: Hashable = RoutingMode.ADAPTIVE_1
    cumulative_threshold_bytes: int = 4 * 1024      # experimentally 4 KiB
    max_sample_age: int = 16                        # "too old" horizon
    #: λ, σ — scaling factors mapping mode_a's (L, s) to a mode_b estimate;
    #: medians over microbenchmark sweeps (core/calibration.py).
    lambda_latency: float = 0.8
    sigma_stalls: float = 1.6
    is_put: bool = True


@dataclass
class SiteState:
    """One Algorithm-1 automaton: the per-call-site selection state."""

    config: AppAwareConfig = field(default_factory=AppAwareConfig)
    current: Hashable = None
    samples: dict = field(default_factory=dict)  # mode -> ModePerformance
    cumulative_bytes: int = 0
    ledger: TrafficLedger = field(default_factory=TrafficLedger)
    decisions: int = 0
    _pending_mode: Optional[Hashable] = None

    def __post_init__(self) -> None:
        if self.current is None:
            self.current = self.config.mode_a  # start ADAPTIVE (paper §4.2)

    # ----------------------------------------------------------------- select
    def select(self, msg_size_bytes: int, *, alltoall: bool = False
               ) -> Hashable:
        """selectRouting(msgSize) — Algorithm 1, one message."""
        cfg = self.config
        mode_a = cfg.mode_a_alltoall if alltoall else cfg.mode_a
        self.cumulative_bytes += msg_size_bytes

        gated = self.cumulative_bytes < cfg.cumulative_threshold_bytes
        if gated:
            # Below the gate: latency-bound regime, always minimal-biased.
            chosen = cfg.mode_b
        else:
            self.cumulative_bytes = 0
            self.decisions += 1
            chosen = self._decide(msg_size_bytes, mode_a)
            self.current = chosen

        self._pending_mode = chosen
        self.ledger.add(chosen, msg_size_bytes, gated=gated)
        return chosen

    def _decide(self, msg_size_bytes: int, mode_a: Hashable) -> Hashable:
        cfg = self.config
        f, p = flits_and_packets(msg_size_bytes, cfg.is_put)

        if self.current == cfg.mode_b:
            # Dual branch: currently HIGH BIAS, maybe switch back to mode_a.
            perf_b = self.samples.get(cfg.mode_b)
            if perf_b is None:
                return cfg.mode_b  # nothing observed yet, keep going
            perf_a = self._estimate_other(
                perf_b, 1.0 / max(cfg.lambda_latency, 1e-9),
                1.0 / max(cfg.sigma_stalls, 1e-9), mode_a)
        else:
            # Currently mode_a (ADAPTIVE / INCR-MINIMAL for alltoall).
            perf_a = self.samples.get(self.current) \
                or self.samples.get(mode_a)
            if perf_a is None:
                return mode_a
            perf_b = self._estimate_other(
                perf_a, cfg.lambda_latency, cfg.sigma_stalls, cfg.mode_b)
        # Eq.(3): compare the Eq.(2) predictions directly (Eq.(4)'s flit
        # threshold is the rearrangement, valid only for s_b > s_a — the
        # direct form is equivalent there and correct in the corners).
        t_a = transmission_cycles_eq2(
            perf_a.latency_cycles, perf_a.stall_cycles_per_flit, f, p)
        t_b = transmission_cycles_eq2(
            perf_b.latency_cycles, perf_b.stall_cycles_per_flit, f, p)
        return cfg.mode_b if t_b < t_a else mode_a

    def _estimate_other(self, known: ModePerformance, lam: float, sig: float,
                        other_mode: Hashable) -> ModePerformance:
        """Return the stored sample for `other_mode` unless it is too old,
        in which case scale the known mode's sample by (λ, σ) — paper §4.2."""
        stored = self.samples.get(other_mode)
        if stored is not None and stored.age <= self.config.max_sample_age:
            return stored
        return ModePerformance(
            latency_cycles=known.latency_cycles * lam,
            stall_cycles_per_flit=known.stall_cycles_per_flit * sig,
        )

    # ---------------------------------------------------------------- observe
    def observe(self, latency_cycles: float, stalls_per_flit: float) -> None:
        """Feed back the NIC counters measured for the last-sent message.
        Called *after* the send (paper: 'Counters are read after sending the
        message to not introduce delays in the transmission')."""
        if self._pending_mode is None:
            return
        self.observe_for_mode(self._pending_mode, latency_cycles,
                              stalls_per_flit)
        self._pending_mode = None

    def observe_for_mode(self, mode: Hashable, latency_cycles: float,
                         stalls_per_flit: float) -> None:
        """observe() with an explicit mode — used by the batched policy,
        where several decisions may be pending at once."""
        # Age every stored sample, then refresh the used mode's slot.
        self.samples = {m: perf.aged() for m, perf in self.samples.items()}
        self.samples[mode] = ModePerformance(
            latency_cycles, stalls_per_flit, age=0)

    # ------------------------------------------------------------------ stats
    def traffic_fraction(self, mode: Hashable, *,
                         include_gated: bool = True) -> float:
        return self.ledger.traffic_fraction(mode,
                                            include_gated=include_gated)


class _SiteTable:
    """Array-of-structs state for every call site of one policy.

    One row per site; one column per registered mode.  Replaces the
    per-site Python automaton objects on the "phase" path so a decide()
    touching many sites (per-flow sites, per-destination automata) is a
    handful of NumPy ops over [G]-shaped gathers instead of a Python
    loop of Algorithm-1 steps (ROADMAP: vectorize AppAwarePolicy across
    sites).  Sample slots use age == -1 as the "never observed" mark.
    """

    def __init__(self, config: AppAwareConfig):
        self.config = config
        self.keys: dict = {}            # site key -> row
        self.mode_of: list = []         # code -> mode object
        self.code_of: dict = {}         # mode object -> code
        n0, m0 = 0, 0
        self.cum = np.zeros(n0, dtype=np.int64)
        self.current = np.zeros(n0, dtype=np.int64)
        self.decisions = np.zeros(n0, dtype=np.int64)
        self.lat = np.zeros((n0, m0))
        self.stall = np.zeros((n0, m0))
        self.age = np.full((n0, m0), -1, dtype=np.int64)
        self.ledgers: list = []         # row -> TrafficLedger
        # pre-register the config's modes so hot decide()s never grow
        for m in (config.mode_a, config.mode_b, config.mode_a_alltoall):
            self.mode_code(m)

    # ------------------------------------------------------------ registry
    def mode_code(self, mode: Hashable) -> int:
        code = self.code_of.get(mode)
        if code is None:
            code = self.code_of[mode] = len(self.mode_of)
            self.mode_of.append(mode)
            grow = np.zeros((self.lat.shape[0], 1))
            self.lat = np.concatenate([self.lat, grow], axis=1)
            self.stall = np.concatenate([self.stall, grow], axis=1)
            self.age = np.concatenate(
                [self.age, np.full((self.age.shape[0], 1), -1,
                                   dtype=np.int64)], axis=1)
        return code

    def row(self, key: Hashable) -> int:
        r = self.keys.get(key)
        if r is None:
            r = self.keys[key] = len(self.ledgers)
            m = len(self.mode_of)
            self.cum = np.append(self.cum, 0)
            self.current = np.append(
                self.current, self.code_of[self.config.mode_a])
            self.decisions = np.append(self.decisions, 0)
            self.lat = np.concatenate([self.lat, np.zeros((1, m))])
            self.stall = np.concatenate([self.stall, np.zeros((1, m))])
            self.age = np.concatenate(
                [self.age, np.full((1, m), -1, dtype=np.int64)])
            self.ledgers.append(TrafficLedger())
        return r

    # ------------------------------------------------------ vectorized step
    def select_groups(self, rows_s: np.ndarray, msg_int: np.ndarray,
                      a2a: np.ndarray):
        """One Algorithm-1 step for G groups at once (unique site rows).

        Returns (chosen codes [G], gated [G]) and mutates the table the
        way G sequential SiteState.select() calls would."""
        cfg = self.config
        code_b = self.code_of[cfg.mode_b]
        code_a = np.where(a2a, self.code_of[cfg.mode_a_alltoall],
                          self.code_of[cfg.mode_a])
        self.cum[rows_s] += msg_int
        gated = self.cum[rows_s] < cfg.cumulative_threshold_bytes
        chosen = np.full(len(rows_s), code_b, dtype=np.int64)
        dec = ~gated
        if dec.any():
            s = rows_s[dec]
            self.cum[s] = 0
            self.decisions[s] += 1
            chosen[dec] = self._decide_vec(s, msg_int[dec], code_a[dec])
            self.current[s] = chosen[dec]
        return chosen, gated

    def _decide_vec(self, s: np.ndarray, msg_int: np.ndarray,
                    code_a: np.ndarray) -> np.ndarray:
        """Vectorized SiteState._decide: Eq.(3) over the Eq.(2) model,
        with the λ/σ-scaled estimate replacing too-old samples."""
        cfg = self.config
        code_b = self.code_of[cfg.mode_b]
        f, pk = flits_and_packets_vec(msg_int, cfg.is_put)
        cur = self.current[s]
        is_b = cur == code_b
        # the known side: mode_b's sample when currently B, else the
        # current mode's sample (falling back to mode_a's slot)
        cur_has = self.age[s, cur] >= 0
        known_code = np.where(is_b, code_b,
                              np.where(cur_has, cur, code_a))
        known_lat = self.lat[s, known_code]
        known_stall = self.stall[s, known_code]
        known_has = self.age[s, known_code] >= 0
        # the other side: stored sample unless too old, else λ/σ scaling
        other_code = np.where(is_b, code_a, code_b)
        lam = np.where(is_b, 1.0 / max(cfg.lambda_latency, 1e-9),
                       cfg.lambda_latency)
        sig = np.where(is_b, 1.0 / max(cfg.sigma_stalls, 1e-9),
                       cfg.sigma_stalls)
        o_age = self.age[s, other_code]
        use_stored = (o_age >= 0) & (o_age <= cfg.max_sample_age)
        est_lat = np.where(use_stored, self.lat[s, other_code],
                           known_lat * lam)
        est_stall = np.where(use_stored, self.stall[s, other_code],
                             known_stall * sig)
        t_known = transmission_cycles_eq2(known_lat, known_stall, f, pk)
        t_other = transmission_cycles_eq2(est_lat, est_stall, f, pk)
        t_a = np.where(is_b, t_other, t_known)
        t_b = np.where(is_b, t_known, t_other)
        decided = np.where(t_b < t_a, code_b, code_a)
        # nothing observed yet: keep going in the current regime
        return np.where(known_has, decided,
                        np.where(is_b, code_b, code_a))

    def observe_groups(self, rows_s: np.ndarray, codes: np.ndarray,
                       lat: np.ndarray, stall: np.ndarray) -> None:
        """Vectorized observe_for_mode over unique site rows: age every
        stored sample, then refresh the observed slots."""
        self.age[rows_s] += self.age[rows_s] >= 0
        self.lat[rows_s, codes] = lat
        self.stall[rows_s, codes] = stall
        self.age[rows_s, codes] = 0


class _SiteView:
    """SiteState-shaped read view over one _SiteTable row (so callers
    and tests can keep poking `site(...).current/.samples/...` on the
    vectorized "phase" path)."""

    def __init__(self, table: _SiteTable, row: int):
        self._table = table
        self._row = row

    config = property(lambda self: self._table.config)
    decisions = property(lambda self: int(self._table.decisions[self._row]))
    cumulative_bytes = property(lambda self: int(self._table.cum[self._row]))
    current = property(
        lambda self: self._table.mode_of[self._table.current[self._row]])
    ledger = property(lambda self: self._table.ledgers[self._row])

    @property
    def samples(self) -> dict:
        t, r = self._table, self._row
        return {t.mode_of[c]: ModePerformance(t.lat[r, c], t.stall[r, c],
                                              age=int(t.age[r, c]))
                for c in range(len(t.mode_of)) if t.age[r, c] >= 0}

    def traffic_fraction(self, mode: Hashable, *,
                         include_gated: bool = True) -> float:
        return self.ledger.traffic_fraction(mode,
                                            include_gated=include_gated)


def _waves(rows: np.ndarray):
    """Split group indices into passes with unique site rows, preserving
    order — duplicate sites in one batch step sequentially (the rare
    same-site-two-kinds case), everyone else in one vectorized pass."""
    order: dict = {}
    wave_of = np.empty(len(rows), dtype=np.int64)
    for i, r in enumerate(rows):
        k = order.get(r, 0)
        order[r] = k + 1
        wave_of[i] = k
    for wv in range(int(wave_of.max()) + 1 if len(rows) else 0):
        yield np.flatnonzero(wave_of == wv)


class AppAwarePolicy:
    """Algorithm 1 as a batched, multi-call-site Policy.

    granularity:
      * "phase"  — one automaton step per (site, kind) group per decide();
        the group's max message size drives the gate/decision, all rows
        get the group's mode (the paper's per-phase protocol; what the
        benchmark runner always did).  Site state is array-of-structs
        (`_SiteTable`): the gate, Eq.(3) decision and sample updates run
        vectorized across all groups of the batch.
      * "message" — row-by-row replay of the legacy per-message protocol
        over `SiteState` automatons; decision-for-decision identical to
        the seed AppAwareRouter.
    """

    def __init__(self, config: AppAwareConfig | None = None, *,
                 granularity: str = "phase"):
        if granularity not in ("phase", "message"):
            raise ValueError(f"unknown granularity: {granularity!r}")
        self.config = config or AppAwareConfig()
        self.granularity = granularity
        self._sites: dict = {}          # "message" path: key -> SiteState
        self._table = _SiteTable(self.config)   # "phase" path state
        #: per-row gate mask of the last decide() (engine ledger input)
        self.last_gated: np.ndarray | None = None
        self._pending: list = []   # [(site row/state, rows, modes_of_rows)]

    # ------------------------------------------------------------------ sites
    def site(self, key: Hashable = "default"):
        if self.granularity == "phase":
            return _SiteView(self._table, self._table.row(key))
        st = self._sites.get(key)
        if st is None:
            st = self._sites[key] = SiteState(self.config)
        return st

    # ----------------------------------------------------------------- decide
    def decide(self, batch: DecisionBatch) -> np.ndarray:
        if self.granularity == "phase":
            return self._decide_phase(batch)
        n = len(batch)
        modes = np.empty(n, dtype=object)
        gated = np.zeros(n, dtype=bool)
        pending = []
        for site_key, kind, rows in batch.groups():
            st = self.site(site_key)
            a2a = kind == KIND_ALLTOALL
            row_modes = np.empty(len(rows), dtype=object)
            for j, i in enumerate(rows):
                before = st.cumulative_bytes
                size = int(batch.msg_bytes[i])
                row_modes[j] = modes[i] = st.select(size, alltoall=a2a)
                gated[i] = before + size \
                    < self.config.cumulative_threshold_bytes
            pending.append((st, rows, row_modes))
        self.last_gated = gated
        self._pending = pending
        return modes

    def _decide_phase(self, batch: DecisionBatch) -> np.ndarray:
        n = len(batch)
        tbl = self._table
        groups = list(batch.groups())
        rows_s = np.array([tbl.row(k) for k, _, _ in groups],
                          dtype=np.int64)
        msgs = np.array([float(batch.msg_bytes[rows].max())
                         for _, _, rows in groups])
        sums = np.array([float(batch.msg_bytes[rows].sum())
                         for _, _, rows in groups])
        a2a = np.array([kind == KIND_ALLTOALL for _, kind, _ in groups])
        before = np.empty(len(groups))   # pre-step cum, filled per wave
        chosen = np.empty(len(groups), dtype=np.int64)
        gated_grp = np.empty(len(groups), dtype=bool)
        for wv in _waves(rows_s):
            # wave rows are unique -> the gate/decision math vectorizes;
            # `before` must still see earlier waves' mutations
            before[wv] = tbl.cum[rows_s[wv]]
            chosen[wv], gated_grp[wv] = tbl.select_groups(
                rows_s[wv], msgs[wv].astype(np.int64), a2a[wv])
        # Fig.8/9 gate semantics for the engine ledger: float comparison
        # over the pre-step cumulative counter (legacy behaviour)
        was_gated = before + msgs < self.config.cumulative_threshold_bytes
        modes = np.empty(n, dtype=object)
        gated = np.zeros(n, dtype=bool)
        pending = []
        for gi, (_, _, rows) in enumerate(groups):
            mode = tbl.mode_of[chosen[gi]]
            modes[rows] = mode
            gated[rows] = was_gated[gi]
            # the gate-driving max message is ledgered like select() did;
            # the rest of the group's bytes ride along so the site ledger
            # matches the engine's traffic truth
            led = tbl.ledgers[rows_s[gi]]
            led.add(mode, int(msgs[gi]), gated=bool(gated_grp[gi]))
            rest = sums[gi] - msgs[gi]
            if rest > 0:
                led.add(mode, rest, gated=bool(was_gated[gi]))
            pending.append((rows_s[gi], rows, mode))
        self.last_gated = gated
        self._pending = pending
        return modes

    # ----------------------------------------------------------------- update
    def update(self, batch: DecisionBatch, feedback: Feedback) -> None:
        """Feed (L, s) back for the rows of the last decide().

        In "phase" granularity each group collapses to one weighted-mean
        sample (the runner's per-phase mean-counter observation) and the
        sample-table refresh runs vectorized across groups; in "message"
        granularity every row refreshes its own mode's slot in row
        order, replaying the legacy select/observe interleave."""
        if not self._pending:
            return
        if len(feedback) != len(batch):
            raise ValueError("feedback rows must match the decided batch")
        lat, st_, w = (feedback.latency_cycles, feedback.stalls_per_flit,
                       feedback.weight)
        if self.granularity == "phase":
            tbl = self._table
            rows_s = np.array([site for site, _, _ in self._pending],
                              dtype=np.int64)
            codes = np.array([tbl.code_of[mode]
                              for _, _, mode in self._pending],
                             dtype=np.int64)
            lat_g = np.empty(len(self._pending))
            stall_g = np.empty(len(self._pending))
            for gi, (_, rows, _) in enumerate(self._pending):
                wr = w[rows]
                tot = float(wr.sum()) or 1.0
                lat_g[gi] = float((lat[rows] * wr).sum() / tot)
                stall_g[gi] = float((st_[rows] * wr).sum() / tot)
            for wv in _waves(rows_s):
                tbl.observe_groups(rows_s[wv], codes[wv], lat_g[wv],
                                   stall_g[wv])
            self._pending = []
            return
        for site_state, rows, row_modes in self._pending:
            for j, i in enumerate(rows):
                site_state.observe_for_mode(row_modes[j],
                                            float(lat[i]), float(st_[i]))
                site_state._pending_mode = None
        self._pending = []

    # ------------------------------------------------------------------ stats
    def site_keys(self) -> list:
        """Every call-site key this policy has seen (table row order)."""
        if self.granularity == "phase":
            return list(self._table.keys)
        return list(self._sites)

    def reset_samples(self, site_filter=None) -> int:
        """Forget latency/stall samples for the matching sites.

        Fault-epoch hook (docs/faults.md): when the machine's link set
        changes, est_memory-driven samples gathered BEFORE the epoch
        describe paths that may no longer exist — Algorithm 1 would keep
        regime-switching on contaminated evidence.  Dropping the samples
        (ages back to "never observed") makes the automaton re-measure
        both arms from scratch; the current regime and traffic ledgers
        are decisions, not measurements, and are kept.  `site_filter`
        (key -> bool, e.g. ``scoped_site_filter(tenant)``) restricts the
        reset to the affected sites; None resets every site.  Returns
        the number of sites reset."""
        n = 0
        if self.granularity == "phase":
            for key, row in self._table.keys.items():
                if site_filter is None or site_filter(key):
                    self._table.age[row, :] = -1
                    n += 1
        else:
            for key, st in self._sites.items():
                if site_filter is None or site_filter(key):
                    st.samples = {}
                    st._pending_mode = None
                    n += 1
        return n

    def _ledgers(self, site_filter=None) -> list:
        keyed = self._table.keys.items() if self.granularity == "phase" \
            else {k: st for k, st in self._sites.items()}.items()
        out = []
        for key, v in keyed:
            if site_filter is not None and not site_filter(key):
                continue
            out.append(self._table.ledgers[v]
                       if self.granularity == "phase" else v.ledger)
        return out

    def traffic_fraction(self, mode: Hashable, *,
                         include_gated: bool = True,
                         site_filter=None) -> float:
        """Traffic fraction aggregated over call sites.

        `site_filter` (optional, key -> bool) slices the aggregate to a
        subset of sites — the _SiteTable slicing used by the tenancy
        engine, whose shared-engine mode namespaces every site key as
        ``(tenant_name, site)`` in ONE array-of-structs table and reads
        per-tenant fractions back out with
        ``site_filter=scoped_site_filter(tenant_name)``."""
        merged = TrafficLedger()
        for led in self._ledgers(site_filter):
            for m, b in led.sent.items():
                merged.sent[m] = merged.sent.get(m, 0.0) + b
            for m, b in led.gated.items():
                merged.gated[m] = merged.gated.get(m, 0.0) + b
            for m, b in led.decided.items():
                merged.decided[m] = merged.decided.get(m, 0.0) + b
        return merged.traffic_fraction(mode, include_gated=include_gated)


def scoped_site_filter(scope: Hashable):
    """site_filter matching keys namespaced as ``(scope, ...)`` tuples
    (and the bare ``scope`` key itself)."""
    def _match(key) -> bool:
        return key == scope or (isinstance(key, tuple) and len(key) >= 1
                                and key[0] == scope)
    return _match
