"""``repro_torch.benchmarks.parity``: the tie rule's decision margins
and the phase-by-phase comparison of two protocol runs."""

import numpy as np
import pytest

import repro.policy as ref_policy
import repro.policy.app_aware as ref_app_aware
from repro_torch.benchmarks.parity import (PhaseRecord, ProtocolTrace,
                                           carried_state, compare_traces,
                                           decision_margin, mode_counts)
import repro_torch.dragonfly as port
import repro_torch.policy as port_policy
from repro_torch.benchmarks.parity import trace_protocol
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import RoutingPolicy
from repro_torch.dragonfly.topology import make_allocation

from test_torch_simulator import JAX_RTOL, TOPO_KW


def _stream(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        rows = int(rng.integers(1, 64))
        kind = "alltoall" if rng.random() < 0.3 else "pt2pt"
        yield (np.full(rows, float(2 ** int(rng.integers(8, 22)))), kind,
               rng.gamma(2.0, 4.0, size=rows), rng.gamma(1.5, 0.8, size=rows))


@pytest.mark.parametrize("seed", [0, 7])
def test_app_aware_margin_is_the_gap_algorithm_1_compares(seed,
                                                          monkeypatch):
    """The margin read before decide() is |t_a - t_b| / max(t_a, t_b) of
    the Eq. (2) times the reference's Algorithm 1 then compares."""
    seen = []
    eq2 = ref_app_aware.transmission_cycles_eq2

    def recording(*args):
        seen.append(eq2(*args))
        return seen[-1]

    monkeypatch.setattr(ref_app_aware, "transmission_cycles_eq2", recording)
    eng = ref_policy.make_engine("app_aware")
    checked = 0
    for size, kind, lat, stalls in _stream(seed):
        batch = ref_policy.DecisionBatch.of(size, "site", kind)
        margin = decision_margin(eng.policy, batch)
        seen.clear()
        eng.decide(batch)
        if not seen:                    # gated: no Eq. (3) comparison
            assert margin is None
        elif margin is not None:        # the comparison that decided
            t_known, t_other = (float(t[0]) for t in seen)
            assert margin == pytest.approx(
                abs(t_known - t_other) / max(t_known, t_other), rel=1e-12)
            checked += 1
        # (margin None with times computed: nothing observed yet, the
        # vectorised step computes both and keeps the current regime)
        eng.bus.publish_flow_arrays(lat, stalls)
    assert checked > 20


def test_eps_greedy_and_notification_margins():
    eng = port_policy.make_engine("eps_greedy", seed=1)
    batch = port_policy.DecisionBatch.of(np.full(8, 65536.0), "s")
    assert decision_margin(eng.policy, batch) is None     # arms untried
    for lat in (2.0, 3.0, 2.5, 3.5):
        eng.decide(batch)
        eng.bus.publish_flow_arrays(np.full(8, lat), np.full(8, 0.5))
    a = eng.policy._arms[("s", RoutingMode.ADAPTIVE_0)].cost
    b = eng.policy._arms[("s", RoutingMode.ADAPTIVE_3)].cost
    assert decision_margin(eng.policy, batch) == \
        pytest.approx(abs(a - b) / max(a, b))

    eng = port_policy.make_engine("notification")
    eng.decide(batch)
    eng.bus.publish_flow_arrays(np.ones(8), np.ones(8),
                                notified=np.full(8, 0.04))
    # EMA 0.04: 0.2 from the 0.05 raise threshold, 0.75 from 0.01
    assert decision_margin(eng.policy, batch) == pytest.approx(0.2)
    assert decision_margin(port_policy.make_engine("static").policy,
                           batch) is None


def test_mode_counts_in_order_of_appearance():
    A, B = RoutingMode.ADAPTIVE_0, RoutingMode.ADAPTIVE_3
    modes = np.empty(5, dtype=object)
    modes[:] = [B, A, B, B, A]
    assert mode_counts(modes) == (("ADAPTIVE_3", 3), ("ADAPTIVE_0", 2))


def _trace(times, modes, margins, rng=0):
    return ProtocolTrace([PhaseRecord(t, {"s": rng}, m, g)
                          for t, m, g in zip(times, modes, margins)])


def test_compare_traces_applies_the_tie_rule():
    a0, a3 = (("ADAPTIVE_0", 4),), (("ADAPTIVE_3", 4),)
    first = _trace([10.0, 20.0, 30.0], [None, a0, a0], [None, 0.5, 0.01])
    same = _trace([10.1, 19.9, 30.2], [None, a0, a0], [None, 0.5, 0.01])
    assert compare_traces(first, same, 2e-2) == 3
    # a flip at a tie (margin 0.01 < 2 * rtol) stops the comparison there
    tie = _trace([10.0, 20.0, 99.0], [None, a0, a3], [None, 0.5, 0.01])
    assert compare_traces(first, tie, 2e-2) == 2
    # ... a flip at a clear decision is a fault
    clear = _trace([10.0, 20.0, 30.0], [None, a3, a0], [None, 0.5, 0.01])
    with pytest.raises(AssertionError, match="tie rule"):
        compare_traces(first, clear, 2e-2)
    slow = _trace([10.0, 21.0, 30.0], [None, a0, a0], [None, 0.5, 0.01])
    with pytest.raises(AssertionError, match="phase_time_us"):
        compare_traces(first, slow, 2e-2)
    drift = _trace([10.0, 20.0, 30.0], [None, a0, a0], [None, 0.5, 0.01],
                   rng=1)
    with pytest.raises(AssertionError, match="lockstep"):
        compare_traces(first, drift, 2e-2)


def test_compare_traces_holds_the_carried_state():
    sim = port.DragonflySimulator(
        port.DragonflyTopology(port.TopologyParams(**TOPO_KW)),
        port.SimParams(seed=0), device="cpu")
    sim.link_queue_s[:] = np.linspace(0.0, 1e-5, sim.link_queue_s.size)
    sim.clock_s = 1e-3
    state = carried_state(sim)

    def traced(**change):
        st = dict(state, **change)
        return ProtocolTrace([PhaseRecord(10.0, {"s": 0}, state=st)])

    first = traced()
    assert compare_traces(first, traced(clock_s=1.001e-3), 2e-2) == 1
    near = state["link_queue_s"] * (1 + 1e-3)
    assert compare_traces(first, traced(link_queue_s=near), 2e-2) == 1
    for change, where in (
            (dict(link_queue_s=state["link_queue_s"] * 1.1), "link_queue_s"),
            (dict(est_memory_s=state["est_memory_s"] + 1e-9),
             "est_memory_s"),
            (dict(link_notify_age=state["link_notify_age"] + 1),
             "link_notify_age"),
            (dict(_notify_epoch=1), "_notify_epoch"),
            (dict(clock_s=2e-3), "clock_s")):
        with pytest.raises(AssertionError, match=f"carried state parts at "
                           f"{where}"):
            compare_traces(first, traced(**change), 2e-2)


#: post-phase updates an anchored run would overwrite unseen without the
#: carried-state check (none of them moves the phase's own time)
STATE_FAULTS = {
    "queue carry-over": (dict(queue_carryover=0.7), "link_queue_s"),
    "estimate decay": (dict(est_memory_decay=0.9), "est_memory_s"),
    "notification ageing": (dict(notify_clear_frac=0.99),
                            "link_notify_age"),
}
NOTIFYING = dict(notify_threshold_s=1e-5, notify_penalty_s=300e-6)


@pytest.mark.parametrize("fault", sorted(STATE_FAULTS))
def test_an_anchored_run_catches_a_fault_in_the_update_after_a_phase(
        fault):
    change, where = STATE_FAULTS[fault]
    topo = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
    alloc = make_allocation(topo, 32, spread="groups:3", seed=1)
    nodes = np.asarray(alloc.nodes)
    phases = port.PATTERNS["alltoall"](32, size_per_pair=16384)
    pol = RoutingPolicy(RoutingMode.ADAPTIVE_0)

    def run(**extra):
        sim = port.DragonflySimulator(
            topo, port.SimParams(seed=3, **NOTIFYING, **extra),
            device="cpu")
        for _ in range(6):
            for s, d, b in phases:
                sim.run_phase(nodes[s], nodes[d], b, pol, alloc)

    with trace_protocol(port.DragonflySimulator, port_policy.PolicyEngine,
                        record_state=True) as first:
        run()
    traces = {}
    for label, extra in (("same", {}), ("faulted", change)):
        with trace_protocol(port.DragonflySimulator,
                            port_policy.PolicyEngine,
                            anchor=first) as traces[label]:
            run(**extra)
    n = len(first.phases)
    assert compare_traces(first, traces["same"], JAX_RTOL) == n
    # the phase times alone do not see it ...
    bare = ProtocolTrace([PhaseRecord(p.phase_time_us, p.rng_state)
                          for p in traces["faulted"].phases])
    assert compare_traces(first, bare, JAX_RTOL) == n
    # ... the state the faulted update leaves does
    with pytest.raises(AssertionError, match=f"parts at {where}"):
        compare_traces(first, traces["faulted"], JAX_RTOL)
