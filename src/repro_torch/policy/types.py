"""Core types of the unified policy API.

One vocabulary for every mode-selection decision in the repo:

  * `DecisionBatch` — a NumPy-shaped batch of pending sends: per row a
    message size, a call-site key and a collective kind.  The Dragonfly
    simulator submits one batch per phase (thousands of flows), the
    collective selector submits batches of gradient buckets, launchers
    submit one row per step.
  * `Feedback` — normalized telemetry for a previously-decided batch:
    the paper's (L, s) pair per row, in NIC cycles / stall-cycles-per-
    flit, regardless of whether it came from Aries NIC counters, HLO
    counters or simulator queue estimates (see telemetry.TelemetryBus).
  * `Policy` — the pluggable strategy protocol:
    ``decide(batch) -> modes`` and ``update(batch, feedback)``.

Modes are opaque Hashables (RoutingMode on the Dragonfly substrate,
CollectiveMode on the TPU mesh), exactly like the legacy AppAwareRouter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Hashable, Protocol, runtime_checkable

import numpy as np

#: Collective-kind labels.  `alltoall` is special-cased by Algorithm 1
#: (the Aries default for alltoall call sites is INCREASINGLY MINIMAL
#: BIAS, paper §4.2); everything else behaves like `pt2pt`.
KIND_PT2PT = "pt2pt"
KIND_ALLTOALL = "alltoall"
KIND_ALLREDUCE = "allreduce"
KIND_BROADCAST = "broadcast"


def _as_object_array(value, n: int) -> np.ndarray:
    """Broadcast a scalar (or pass through an array) to an [n] object array."""
    if isinstance(value, np.ndarray) and value.dtype == object:
        if value.shape != (n,):
            raise ValueError(f"expected shape ({n},), got {value.shape}")
        return value
    out = np.empty(n, dtype=object)
    if np.isscalar(value) or isinstance(value, (str, tuple)) \
            or not hasattr(value, "__len__"):
        out.fill(value)                  # scalar broadcast, no Python list
    else:
        if len(value) != n:
            raise ValueError(f"expected length {n}, got {len(value)}")
        out[:] = list(value)
    return out


@dataclass(frozen=True)
class DecisionBatch:
    """A batch of pending sends awaiting a mode decision.

    msg_bytes: [n] float64 — message sizes in bytes.
    site:      [n] object  — call-site keys; each site carries its own
               policy state (Algorithm 1 is a per-call-site automaton).
    kind:      [n] object  — collective kind labels (KIND_*).
    """

    msg_bytes: np.ndarray
    site: np.ndarray
    kind: np.ndarray

    def __post_init__(self):
        n = self.msg_bytes.shape[0]
        if self.site.shape != (n,) or self.kind.shape != (n,):
            raise ValueError("DecisionBatch fields must share shape [n]")

    @staticmethod
    def of(msg_bytes, site: Hashable = "default",
           kind: str = KIND_PT2PT) -> "DecisionBatch":
        """Build a batch, broadcasting scalar site/kind over the rows."""
        b = np.atleast_1d(np.asarray(msg_bytes, dtype=np.float64))
        n = b.shape[0]
        return DecisionBatch(b, _as_object_array(site, n),
                             _as_object_array(kind, n))

    @staticmethod
    def single(msg_bytes: float, site: Hashable = "default",
               kind: str = KIND_PT2PT) -> "DecisionBatch":
        return DecisionBatch.of([float(msg_bytes)], site, kind)

    def __len__(self) -> int:
        return int(self.msg_bytes.shape[0])

    @property
    def is_alltoall(self) -> np.ndarray:
        return self.kind == KIND_ALLTOALL

    def groups(self):
        """Yield (site, kind, row_indices) for each unique (site, kind)
        pair, in order of first appearance — the vectorization unit: the
        per-site automaton steps once per group, rows inside a group are
        filled with pure NumPy."""
        n = len(self)
        sites, kinds = self.site, self.kind
        # fast path for the hot case (a whole phase shares one site/kind):
        # no per-row Python loop.  The comparands are wrapped as 1-element
        # object arrays so tuple-valued sites (repro.tenancy's scoped
        # (tenant, site) keys) compare elementwise instead of being
        # broadcast as a length-2 array.
        s0 = np.empty(1, dtype=object)
        k0 = np.empty(1, dtype=object)
        if n:
            s0[0], k0[0] = sites[0], kinds[0]
        if n and (sites == s0).all() and (kinds == k0).all():
            yield sites[0], kinds[0], np.arange(n, dtype=np.intp)
            return
        seen: dict = {}
        for i in range(n):
            seen.setdefault((sites[i], kinds[i]), []).append(i)
        for (site, kind), rows in seen.items():
            yield site, kind, np.asarray(rows, dtype=np.intp)


@dataclass(frozen=True)
class Feedback:
    """Normalized telemetry for a decided batch (the paper's (L, s)).

    latency_cycles:  [n] — request->response latency L in NIC cycles.
    stalls_per_flit: [n] — mean stall cycles s per ready flit.
    weight:          [n] — optional averaging weight (bytes); used when a
                     policy aggregates rows of one phase into one sample.
    source: provenance tag, canonicalized by telemetry.normalize_kind
            ("nic" | "hlo" | "sim" | "model" | "notify").
    notified: [n] — optional congestion-notification exposure per row in
            [0, 1] (fraction of the row's bytes that crossed a link
            under a visible congestion flag; SimParams.notify_*).  None
            when the producer has no notification channel — consumers
            must treat None as "no signal", not "no congestion".
    """

    latency_cycles: np.ndarray
    stalls_per_flit: np.ndarray
    weight: np.ndarray = None
    source: str = "sim"
    notified: np.ndarray = None

    def __post_init__(self):
        n = self.latency_cycles.shape[0]
        if self.stalls_per_flit.shape != (n,):
            raise ValueError("Feedback fields must share shape [n]")
        if self.weight is None:
            object.__setattr__(self, "weight", np.ones(n))
        elif self.weight.shape != (n,):
            raise ValueError("Feedback weight must have shape [n]")
        if self.notified is not None and self.notified.shape != (n,):
            raise ValueError("Feedback notified must have shape [n]")

    @staticmethod
    def of(latency_cycles, stalls_per_flit, weight=None,
           source: str = "sim", notified=None) -> "Feedback":
        l = np.atleast_1d(np.asarray(latency_cycles, dtype=np.float64))
        s = np.atleast_1d(np.asarray(stalls_per_flit, dtype=np.float64))
        w = None if weight is None else \
            np.atleast_1d(np.asarray(weight, dtype=np.float64))
        nf = None if notified is None else \
            np.atleast_1d(np.asarray(notified, dtype=np.float64))
        return Feedback(l, s, w, source, nf)

    @staticmethod
    def single(latency_cycles: float, stalls_per_flit: float,
               source: str = "sim") -> "Feedback":
        return Feedback.of([latency_cycles], [stalls_per_flit],
                           source=source)

    def __len__(self) -> int:
        return int(self.latency_cycles.shape[0])


@runtime_checkable
class Policy(Protocol):
    """Pluggable mode-selection strategy.

    decide() returns an [n] object array of modes for the batch; update()
    feeds back telemetry for the batch decide() last saw (same row
    order).  Implementations keep whatever per-site state they need.
    """

    def decide(self, batch: DecisionBatch) -> np.ndarray: ...

    def update(self, batch: DecisionBatch, feedback: Feedback) -> None: ...


@dataclass
class TrafficLedger:
    """Byte accounting shared by policies and the engine (Fig. 8/9's
    '% of traffic sent via Default' axis).

    `sent` is physical truth: bytes that went out under each mode.
    `gated` sub-accounts the bytes the cumulative-size gate *forced* to
    the minimal mode without running the decision rule — kept separate so
    the decided fraction is not polluted.
    `decided` counts only bytes routed by an actual Algorithm-1/bandit
    decision.
    """

    sent: dict = field(default_factory=dict)
    gated: dict = field(default_factory=dict)
    decided: dict = field(default_factory=dict)

    def add(self, mode: Hashable, nbytes: float, *, gated: bool) -> None:
        self.sent[mode] = self.sent.get(mode, 0.0) + nbytes
        bucket = self.gated if gated else self.decided
        bucket[mode] = bucket.get(mode, 0.0) + nbytes

    def add_batch(self, modes: np.ndarray, nbytes: np.ndarray,
                  gated=None) -> None:
        """Vectorized accounting: one pass per unique mode in the batch."""
        if gated is None:
            gated = np.zeros(len(modes), dtype=bool)
        for mode in {m for m in modes}:
            rows = modes == mode
            g = float(nbytes[rows & gated].sum())
            d = float(nbytes[rows & ~gated].sum())
            self.sent[mode] = self.sent.get(mode, 0.0) + g + d
            if g:
                self.gated[mode] = self.gated.get(mode, 0.0) + g
            if d:
                self.decided[mode] = self.decided.get(mode, 0.0) + d

    # -- fractions ---------------------------------------------------------
    def traffic_fraction(self, mode: Hashable, *,
                         include_gated: bool = True) -> float:
        """Fraction of bytes sent with `mode`.  With include_gated=False
        the fraction is over decision-routed bytes only — the Fig. 8/9
        semantics where gate-forced small messages are not counted as
        HIGH-BIAS *decisions*."""
        table = self.sent if include_gated else self.decided
        total = sum(table.values())
        return table.get(mode, 0.0) / total if total else 0.0

    def gated_fraction(self) -> float:
        """Fraction of all bytes that were gate-forced (never decided)."""
        total = sum(self.sent.values())
        return sum(self.gated.values()) / total if total else 0.0
