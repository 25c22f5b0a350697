"""The port's policy-engine runners (``dragonfly/traffic.py``) against the
reference: ``run_iteration_engine``, ``run_iteration_app_aware``,
``engine_for_arm`` and the §5 protocol ``run_benchmark``.

A static engine over a few phases is held free-running at the jax
engine's ``JAX_RTOL``.  Longer protocol runs are held phase by phase
through ``repro_torch.benchmarks.parity``: the port's run is anchored to
the reference's carried state before each phase (free runs of the
simulator part by more than ``JAX_RTOL`` within about a dozen phases,
the reference's own float32 jax engine too), decisions must match under
the tie rule, and the generators stay in lockstep at every phase.
"""

import warnings

import numpy as np
import pytest

import repro.dragonfly as ref
import repro.dragonfly.traffic as ref_traffic
from repro.core.app_aware import AppAwareRouter as RefRouter
from repro.core.strategies import RoutingMode as RefMode
from repro.dragonfly.topology import make_allocation
from repro.policy import PolicyEngine as RefEngine
from repro.policy import StaticPolicy as RefStatic
from repro.policy import TelemetryBus as RefBus
import repro_torch.dragonfly as port
import repro_torch.dragonfly.traffic as port_traffic
from repro_torch.benchmarks.parity import compare_traces, trace_protocol
from repro_torch.core.app_aware import AppAwareRouter as PortRouter
from repro_torch.core.strategies import RoutingMode as PortMode
from repro_torch.policy import PolicyEngine as PortEngine
from repro_torch.policy import StaticPolicy as PortStatic
from repro_torch.policy import TelemetryBus as PortBus

from test_torch_simulator import (JAX_RTOL, TOPO_KW, _same_rng,
                                  ref_alloc_as_port)

FIELDS = ("time_us", "mean_latency_us", "mean_stalls", "nonmin_fraction")


def _setup(seed: int, n_ranks: int, **kw):
    rtopo = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))
    ptopo = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
    rsim = ref.DragonflySimulator(rtopo, ref.SimParams(seed=seed, **kw))
    psim = port.DragonflySimulator(ptopo, port.SimParams(seed=seed, **kw),
                                   device="cpu")
    ralloc = make_allocation(rtopo, n_ranks, spread="groups:3", seed=seed)
    return rsim, psim, ralloc, ref_alloc_as_port(ralloc)


def _by_name(mode_bytes: dict) -> dict:
    return {getattr(k, "name", k): v for k, v in mode_bytes.items()}


def _assert_iteration_close(got, want):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=JAX_RTOL, err_msg=f)
    g, w = _by_name(got.mode_bytes), _by_name(want.mode_bytes)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=JAX_RTOL, err_msg=k)


def test_pattern_kinds_match_the_reference():
    assert port_traffic.PATTERN_KIND == ref_traffic.PATTERN_KIND
    assert sorted(port_traffic.PATTERN_KIND) == sorted(port.PATTERNS)


@pytest.mark.parametrize("use_plans", [False, True])
@pytest.mark.parametrize("mode", ["ADAPTIVE_0", "ADAPTIVE_3"])
def test_static_engine_iteration_matches_the_reference(mode, use_plans):
    rsim, psim, ralloc, palloc = _setup(8, 27)
    phases = ref.PATTERNS["halo3d"](27, 48)
    reng = RefEngine(RefStatic(RefMode[mode]), bus=RefBus())
    peng = PortEngine(PortStatic(PortMode[mode]), bus=PortBus())
    for _ in range(2):
        want = ref_traffic.run_iteration_engine(
            rsim, ralloc, phases, reng, site="halo", use_plans=use_plans)
        got = port_traffic.run_iteration_engine(
            psim, palloc, phases, peng, site="halo", use_plans=use_plans)
        _assert_iteration_close(got, want)
        assert set(_by_name(got.mode_bytes)) == {mode}
        _same_rng(psim, rsim)
    assert peng.decide_calls == reng.decide_calls == 2 * len(phases)
    assert len(peng.bus.history) == len(reng.bus.history)


def test_legacy_router_iteration_matches_the_reference():
    rsim, psim, ralloc, palloc = _setup(2, 16)
    phases = ref.PATTERNS["allreduce"](16, 4096)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rr, pr = RefRouter(), PortRouter()
    for _ in range(2):
        want = ref_traffic.run_iteration_app_aware(rsim, ralloc, phases, rr)
        got = port_traffic.run_iteration_app_aware(psim, palloc, phases, pr)
        _assert_iteration_close(got, want)
        _same_rng(psim, rsim)
    assert pr.decisions == rr.decisions > 0


def _protocol(pkg_traffic, sim, alloc, pattern, args, iters, arms):
    return pkg_traffic.run_benchmark(sim, alloc, pattern, args, iters,
                                     modes=arms, use_plans=True)


#: (arm, pattern, pattern args, SimParams extras): the subsampled case
#: cuts alltoall's 992 flows to 400, so the engine gets the phase-mean
#: sample; the notification arm needs the simulator's notifying channel
PROTOCOL_CASES = {
    "app_aware-allreduce": ("app_aware", "allreduce",
                            dict(elements=65536), {}),
    "app_aware-alltoall-subsampled": ("app_aware", "alltoall",
                                      dict(size_per_pair=8192),
                                      dict(max_flows=400)),
    "eps_greedy-halo3d": ("eps_greedy", "halo3d", dict(nx=64), {}),
    "notification-alltoall": ("notification", "alltoall",
                              dict(size_per_pair=16384),
                              dict(notify_threshold_s=1e-5,
                                   notify_penalty_s=300e-6)),
}


def _recording_engines(monkeypatch, module) -> list:
    """Keep every engine ``module.run_benchmark`` builds."""
    built, make = [], module.engine_for_arm

    def engine_for_arm(*args, **kwargs):
        built.append(make(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(module, "engine_for_arm", engine_for_arm)
    return built


@pytest.mark.parametrize("case", sorted(PROTOCOL_CASES))
def test_run_benchmark_matches_the_reference_under_the_tie_rule(
        case, monkeypatch):
    arm, pattern, args, kw = PROTOCOL_CASES[case]
    iters = 3
    rsim, psim, ralloc, palloc = _setup(4, 32, **kw)
    engines = (_recording_engines(monkeypatch, ref_traffic),
               _recording_engines(monkeypatch, port_traffic))
    with trace_protocol(ref.DragonflySimulator, RefEngine,
                        record_state=True) as rtrace:
        want = _protocol(ref_traffic, rsim, ralloc, pattern, args, iters,
                         (RefMode.ADAPTIVE_0, RefMode.ADAPTIVE_3, arm))
    with trace_protocol(port.DragonflySimulator, PortEngine,
                        anchor=rtrace) as ptrace:
        got = _protocol(port_traffic, psim, palloc, pattern, args, iters,
                        (PortMode.ADAPTIVE_0, PortMode.ADAPTIVE_3, arm))
    _same_rng(psim, rsim)
    n = len(rtrace.phases)
    compared = compare_traces(rtrace, ptrace, JAX_RTOL)
    print(f"{case}: {compared} of {n} phases compared")
    assert compared >= n / 2
    assert sum(p.modes is not None for p in rtrace.phases) == \
        iters * len(ref.PATTERNS[pattern](32, **args))
    if "subsampled" in case:
        assert rsim.params.max_flows < 32 * 31
    if compared == n:           # no decision flipped: the whole result
        assert [getattr(k, "name", k) for k in got] == \
            [getattr(k, "name", k) for k in want]
        for g, w in zip(got.values(), want.values()):
            for gi, wi in zip(g, w):
                _assert_iteration_close(gi, wi)
        # ... and the telemetry each engine was fed, sample by sample
        (reng,), (peng,) = engines
        assert len(peng.bus.history) == len(reng.bus.history) == iters * \
            len(ref.PATTERNS[pattern](32, **args))
        for fp, fr in zip(peng.bus.history, reng.bus.history):
            assert len(fp) == len(fr)
            for f in ("latency_cycles", "stalls_per_flit", "notified"):
                a, b = getattr(fp, f), getattr(fr, f)
                assert (a is None) == (b is None), f
                if b is not None:
                    np.testing.assert_allclose(a, b, rtol=JAX_RTOL,
                                               atol=1e-6, err_msg=f)


def test_engine_for_arm_clocks_the_bus_to_the_simulator():
    rsim, psim, _, _ = _setup(0, 8, nic_clock_ghz=1.25)
    for arm in ("app_aware", "eps_greedy", "static", "notification"):
        peng = port_traffic.engine_for_arm(arm, psim)
        reng = ref_traffic.engine_for_arm(arm, rsim)
        assert peng.bus.clock_ghz == reng.bus.clock_ghz == 1.25
        assert type(peng.policy).__name__ == type(reng.policy).__name__
