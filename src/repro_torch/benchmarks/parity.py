"""Phase-by-phase comparison of two runs of the §5 protocol.

Two runs of one seeded protocol (the port on the card against the port
on the CPU, or the port against the reference) draw the same numbers but
compute in different precisions.  Two things then part them:

* **Decisions at a tie.**  Where a policy's two options are closer than
  the drift, the runs may choose differently, and every phase after that
  decision differs.  The tie rule: compare the runs phase by phase; at
  the first phase whose modes differ, the policy's relative margin at
  that decision, read from the first run's engine just before
  ``decide()``, must be below twice the tolerance; stop comparing there.
* **The carried state.**  The link queues and the stale-estimate memory
  feed each phase's routing, and the feedback amplifies a difference:
  two free runs that agree to 1e-6 at the first phase disagree by more
  than 2e-2 within about a dozen phases, the reference's own float32 jax
  engine against its float64 NumPy backend too.  So the second run is
  *anchored*: before each phase it takes the first run's carried state
  (queues, estimates, notification ages and epoch, clock), while its
  generator, plans and policy state stay its own and must stay in
  lockstep.  Each phase is then one step from a common state, and the
  state the second run's own update leaves before the next phase is
  held against the anchor's before it is replaced.

    with trace_protocol(DragonflySimulator, PolicyEngine,
                        record_state=True) as first:
        run_benchmark(...)
    with trace_protocol(DragonflySimulator, PolicyEngine,
                        anchor=first) as second:
        run_benchmark(...)
    compared = compare_traces(first, second, rtol=2e-2)

records every ``run_phase`` of a run, with the modes and the decision
margin of the ``decide()`` that preceded it, the generator's state
before it and the wall time of both calls.  It reads the classes it is given by attribute, so the same
recorder serves the reference's simulator and engine.
"""

from __future__ import annotations

import contextlib
import copy
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.perf_model import (flits_and_packets_vec,
                                         transmission_cycles_eq2)
from repro_torch.policy.types import KIND_ALLTOALL


def _rel_gap(x: float, y: float) -> float:
    top = max(abs(x), abs(y))
    return abs(x - y) / top if top > 0 else 0.0


def _app_aware_margin(policy, batch) -> float | None:
    """|t_a - t_b| / max(t_a, t_b) of Algorithm 1's Eq. (3) for the next
    decision ("phase" granularity), None where no comparison is made
    (the gate holds, or nothing has been observed)."""
    if policy.granularity != "phase":
        raise ValueError("decision margins are read on the phase path")
    tbl, cfg = policy._table, policy.config
    gaps = []
    for site, kind, rows in batch.groups():
        r = tbl.keys.get(site)
        if r is None:
            continue                       # a new site observed nothing
        msg = int(float(batch.msg_bytes[rows].max()))
        if tbl.cum[r] + msg < cfg.cumulative_threshold_bytes:
            continue                       # gated: mode_b, no comparison
        code_b = tbl.code_of[cfg.mode_b]
        code_a = tbl.code_of[cfg.mode_a_alltoall if kind == KIND_ALLTOALL
                             else cfg.mode_a]
        cur = int(tbl.current[r])
        is_b = cur == code_b
        known = code_b if is_b else (cur if tbl.age[r, cur] >= 0 else code_a)
        if tbl.age[r, known] < 0:
            continue
        other = code_a if is_b else code_b
        lam = 1.0 / max(cfg.lambda_latency, 1e-9) if is_b \
            else cfg.lambda_latency
        sig = 1.0 / max(cfg.sigma_stalls, 1e-9) if is_b \
            else cfg.sigma_stalls
        o_age = tbl.age[r, other]
        stored = 0 <= o_age <= cfg.max_sample_age
        lat_o = tbl.lat[r, other] if stored else tbl.lat[r, known] * lam
        st_o = tbl.stall[r, other] if stored else tbl.stall[r, known] * sig
        f, p = flits_and_packets_vec(np.array([msg]), cfg.is_put)
        t_known = transmission_cycles_eq2(tbl.lat[r, known],
                                          tbl.stall[r, known], f, p)
        t_other = transmission_cycles_eq2(lat_o, st_o, f, p)
        gaps.append(_rel_gap(float(t_known[0]), float(t_other[0])))
    return min(gaps) if gaps else None


def _eps_greedy_margin(policy, batch) -> float | None:
    """Relative gap of the two arms' EMA costs (the exploit choice)."""
    gaps = []
    for site, kind, _ in batch.groups():
        a = policy.mode_a_alltoall if kind == KIND_ALLTOALL \
            else policy.mode_a
        sa = policy._arms.get((site, a))
        sb = policy._arms.get((site, policy.mode_b))
        if sa is not None and sb is not None and sa.n and sb.n:
            gaps.append(_rel_gap(sa.cost, sb.cost))
    return min(gaps) if gaps else None


def _notification_margin(policy, batch) -> float | None:
    """Relative gap of the exposure EMA to the nearer regime threshold."""
    cfg, gaps = policy.config, []
    for site, _, _ in batch.groups():
        st = policy._sites.get(site)
        if st is not None and st.n:
            gaps.append(min(_rel_gap(st.ema, cfg.on_threshold),
                            _rel_gap(st.ema, cfg.off_threshold)))
    return min(gaps) if gaps else None


def decision_margin(policy, batch) -> float | None:
    """How close ``policy``'s next decision on ``batch`` is to the other
    choice, as a relative gap; None where it compares nothing that float
    drift can move (a static policy, a gated or unobserved site)."""
    name = type(policy).__name__
    if name == "AppAwarePolicy":
        return _app_aware_margin(policy, batch)
    if name == "EpsilonGreedyPolicy":
        return _eps_greedy_margin(policy, batch)
    if name == "NotificationPolicy":
        return _notification_margin(policy, batch)
    return None


def mode_counts(modes: np.ndarray) -> tuple:
    """((mode name, rows), ...) of a decide()'s object array, in order of
    first appearance (identity compares only: cheap at 10^6 rows)."""
    out, rest = [], modes
    while rest.size:
        eq = rest == rest[0]
        out.append((rest[0].name, int(eq.sum())))
        rest = rest[~eq]
    return tuple(out)


#: the simulator state one phase hands to the next, which an anchored
#: run takes from its anchor (the generator is checked, not copied)
CARRIED_ARRAYS = ("link_queue_s", "est_memory_s", "link_notify_age")
CARRIED_SCALARS = ("clock_s", "total_flits_all_jobs", "_notify_epoch")


def carried_state(sim) -> dict:
    d = {k: np.array(getattr(sim, k)) for k in CARRIED_ARRAYS}
    d.update({k: getattr(sim, k) for k in CARRIED_SCALARS})
    return d


def load_carried_state(sim, state: dict) -> None:
    for k in CARRIED_ARRAYS:
        setattr(sim, k, np.array(state[k], dtype=getattr(sim, k).dtype))
    for k in CARRIED_SCALARS:
        setattr(sim, k, type(getattr(sim, k))(state[k]))


def _state_gap(got: dict, want: dict, rtol: float) -> str | None:
    """Where two carried states part: integers exact, the clock and the
    flit total at ``rtol``, the link arrays at ``rtol`` of their norm."""
    for k in ("link_notify_age", "_notify_epoch"):
        if not np.array_equal(got[k], want[k]):
            return k
    for k in ("clock_s", "total_flits_all_jobs"):
        if not np.isclose(got[k], want[k], rtol=rtol, atol=0.0):
            return f"{k} {got[k]} against {want[k]}"
    for k in ("link_queue_s", "est_memory_s"):
        gap = float(np.linalg.norm(got[k] - want[k]))
        top = float(np.linalg.norm(want[k]))
        if gap > rtol * top:
            return f"{k}: |got - want| {gap:.3e} against |want| {top:.3e}"
    return None


@dataclass
class PhaseRecord:
    phase_time_us: float
    rng_state: dict                  # the simulator's generator, before
    modes: tuple | None = None       # mode_counts of the decide(), if any
    margin: float | None = None      # decision_margin before it
    state: dict | None = None        # carried_state before, as the run's
    #                                  own code left it, if recorded
    decide_s: float = 0.0            # wall time of the decide(), if any
    run_phase_s: float = 0.0         # wall time of the run_phase()
    trace_s: float = 0.0             # wall time the recording itself took


@dataclass
class ProtocolTrace:
    phases: list = field(default_factory=list)
    _pending: tuple | None = None


@contextlib.contextmanager
def trace_protocol(sim_cls, engine_cls, *, record_state: bool = False,
                   anchor: ProtocolTrace | None = None, on_phase=None):
    """Record every ``sim_cls.run_phase`` and ``engine_cls.decide`` call
    made inside the block (class-level wrappers, removed on exit).
    ``record_state`` keeps each phase's carried state; ``anchor`` (a
    trace recorded so) keeps it too, then loads its phase i's state
    before phase i.  ``on_phase(sim, args, kwargs, result)`` is called
    after each phase."""
    trace = ProtocolTrace()
    run_phase, decide = sim_cls.run_phase, engine_cls.decide

    def traced_decide(engine, batch):
        t_in = time.perf_counter()
        margin = decision_margin(engine.policy, batch)
        t0 = time.perf_counter()
        modes = decide(engine, batch)
        t1 = time.perf_counter()
        counts = mode_counts(modes)
        trace._pending = (counts, margin, t1 - t0,
                          time.perf_counter() - t_in - (t1 - t0))
        return modes

    def traced_run_phase(sim, *args, **kwargs):
        t_in = time.perf_counter()
        i = len(trace.phases)
        modes, margin, decide_s, trace_s = trace._pending or (None, None,
                                                              0.0, 0.0)
        rec = PhaseRecord(0.0, copy.deepcopy(sim.rng.bit_generator.state),
                          modes, margin, decide_s=decide_s,
                          state=carried_state(sim)
                          if record_state or anchor is not None else None)
        if anchor is not None:
            _require(i < len(anchor.phases), f"phase {i} is past the "
                     f"anchor's {len(anchor.phases)}")
            load_carried_state(sim, anchor.phases[i].state)
        trace._pending = None
        t0 = time.perf_counter()
        res = run_phase(sim, *args, **kwargs)
        rec.run_phase_s = time.perf_counter() - t0
        rec.trace_s = trace_s + (t0 - t_in)
        rec.phase_time_us = res.phase_time_us
        trace.phases.append(rec)
        if on_phase is not None:
            on_phase(sim, args, kwargs, res)
        return res

    sim_cls.run_phase, engine_cls.decide = traced_run_phase, traced_decide
    try:
        yield trace
    finally:
        sim_cls.run_phase, engine_cls.decide = run_phase, decide


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare_traces(first: ProtocolTrace, second: ProtocolTrace,
                   rtol: float) -> int:
    """Hold ``second`` against ``first`` under the tie rule: generator
    states equal, the carried state before each phase (where both
    recorded it) as ``_state_gap`` holds it, phase times at ``rtol`` and
    equal modes up to the first phase whose modes differ, where
    ``first``'s margin must be below ``2 * rtol``.  Returns the number
    of phases compared (all of them where no decision flips); raises
    AssertionError on a fault."""
    _require(len(first.phases) == len(second.phases),
             f"{len(first.phases)} phases against {len(second.phases)}")
    for i, (a, b) in enumerate(zip(first.phases, second.phases)):
        _require(a.rng_state == b.rng_state,
                 f"phase {i}: the generators left lockstep")
        if a.state is not None and b.state is not None:
            gap = _state_gap(b.state, a.state, rtol)
            _require(gap is None, f"before phase {i}: the carried state "
                     f"parts at {gap} (rtol {rtol})")
        if a.modes != b.modes:
            _require(a.margin is not None and a.margin < 2 * rtol,
                     f"phase {i}: modes {a.modes} against {b.modes} at a "
                     f"decision margin of {a.margin} (tie rule: < "
                     f"{2 * rtol})")
            return i
        _require(bool(np.isclose(b.phase_time_us, a.phase_time_us,
                                 rtol=rtol, atol=0.0)),
                 f"phase {i}: phase_time_us {b.phase_time_us} against "
                 f"{a.phase_time_us} (rtol {rtol})")
    return len(first.phases)
