"""The port's copies of ``repro.policy``, ``repro.core.noise`` and
``repro.core.calibration`` against the reference.

The copies are NumPy code that runs unchanged, so the same inputs must
give the same outputs bit for bit: chosen modes (by name: the two
packages' ``RoutingMode`` enums are distinct classes), ledger fractions,
the fault-epoch hook's counts, noise statistics and calibrated factors.
"""

import dataclasses
import warnings

import numpy as np
import pytest

import repro.core as ref_core
import repro.policy as ref_policy
from repro.core.calibration import calibrate_scaling_factors as ref_calibrate
from repro.core.noise import estimate_noise as ref_estimate_noise
from repro.core.strategies import RoutingMode as RefMode
import repro_torch.core as port_core
import repro_torch.policy as port_policy
from repro_torch.core.calibration import calibrate_scaling_factors
from repro_torch.core.noise import estimate_noise
from repro_torch.core.strategies import RoutingMode as PortMode

GRANULARITIES = ("message", "phase")
SITES = ("s0", "s1", ("tenant", "s2"))
KINDS = ("pt2pt", "alltoall", "allreduce")
#: steps whose counter reads are lost (the engine's staleness_limit is 5)
LOST = (20, 27)


def _names(modes) -> list:
    return [m.name for m in modes]


def _batches(pkg, seed: int, steps: int):
    """A seeded stream of DecisionBatches, each with its Feedback draws:
    sizes from 64 B to 16 MiB, one to three sites and kinds per batch."""
    rng = np.random.default_rng(seed)
    for k in range(steps):
        # a fixed width over LOST (and the recovery step after it): the
        # first feedback after fallback decides lands on the rows of the
        # policy's last own decide(), which must exist in it
        n = 24 if LOST[0] <= k <= LOST[1] else int(rng.integers(1, 40))
        sizes = np.floor(2.0 ** rng.uniform(6, 24, size=n))
        site = np.empty(n, dtype=object)
        kind = np.empty(n, dtype=object)
        pick = rng.integers(0, len(SITES), size=n) \
            if rng.random() < 0.5 else np.zeros(n, dtype=np.int64)
        for i, j in enumerate(pick):
            site[i] = SITES[j]
        kind[:] = KINDS[int(rng.integers(0, len(KINDS)))]
        lat = rng.uniform(0.5, 40.0, size=n)
        stalls = rng.uniform(0.0, 6.0, size=n)
        notified = rng.uniform(0.0, 0.2, size=n) * (rng.random() < 0.6)
        single = rng.random() < 0.25
        yield pkg.DecisionBatch(sizes, site, kind), lat, stalls, \
            notified, single


def _drive(pkg, name: str, granularity: str, seed: int, steps: int = 60):
    eng = pkg.make_engine(name, granularity=granularity, seed=seed,
                          staleness_limit=5)
    chosen, resets = [], []
    for k, (batch, lat, stalls, notified, single) in enumerate(
            _batches(pkg, seed, steps)):
        chosen.append(_names(eng.decide(batch)))
        if LOST[0] <= k < LOST[1]:
            continue        # counter reads lost: the staleness guard trips
        if single:           # one aggregate sample, broadcast by the engine
            eng.bus.publish_flow_arrays([float(lat.mean())],
                                        [float(stalls.mean())],
                                        notified=[float(notified.mean())])
        else:
            eng.bus.publish_flow_arrays(lat, stalls, notified=notified)
        if k == steps // 2:
            resets.append(eng.on_fault_epoch(
                pkg.scoped_site_filter("tenant")))
            resets.append(eng.on_fault_epoch())
    return eng, chosen, resets


def _fractions(eng, modes) -> list:
    return [(eng.traffic_fraction(m),
             eng.traffic_fraction(m, include_gated=False)) for m in modes]


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("name", ref_policy.POLICY_NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_streams_match_the_reference(name, granularity, seed):
    assert port_policy.POLICY_NAMES == ref_policy.POLICY_NAMES
    ref_eng, ref_modes, ref_resets = _drive(ref_policy, name, granularity,
                                            seed)
    eng, modes, resets = _drive(port_policy, name, granularity, seed)
    assert modes == ref_modes
    assert resets == ref_resets
    assert _fractions(eng, PortMode) == _fractions(ref_eng, RefMode)
    assert eng.gated_fraction() == ref_eng.gated_fraction()
    assert (eng.decide_calls, eng.rows_decided, eng.fallback_decides) == \
        (ref_eng.decide_calls, ref_eng.rows_decided,
         ref_eng.fallback_decides)
    assert eng.fallback_decides > 0
    assert len({tuple(m) for m in modes}) > 1 or name == "static"


def _telemetry_stream(seed: int, phases: int = 80):
    """One recorded stream of per-phase (bytes, alltoall, L us, s)
    observations, as a simulator run publishes them."""
    rng = np.random.default_rng(seed)
    for _ in range(phases):
        n = int(rng.integers(1, 200))
        size = float(2 ** int(rng.integers(8, 23)))
        yield (np.full(n, size), bool(rng.random() < 0.3),
               rng.gamma(2.0, 4.0, size=n), rng.gamma(1.5, 0.8, size=n))


@pytest.mark.parametrize("seed", [3, 11])
def test_app_aware_replays_a_recorded_reference_stream(seed):
    """Record the reference's decisions on a telemetry stream; the port's
    AppAwarePolicy, fed the same stream, chooses the same mode at every
    phase."""
    ref_eng = ref_policy.PolicyEngine(ref_policy.AppAwarePolicy())
    eng = port_policy.PolicyEngine(port_policy.AppAwarePolicy())
    recorded = []
    for size, a2a, lat, stalls in _telemetry_stream(seed):
        kind = "alltoall" if a2a else "pt2pt"
        m = ref_eng.decide(ref_policy.DecisionBatch.of(size, "app", kind))
        recorded.append((size, kind, lat, stalls, m[0].name))
        ref_eng.bus.publish_flow_arrays(lat, stalls)
    switches = 0
    for k, (size, kind, lat, stalls, want) in enumerate(recorded):
        got = eng.decide(port_policy.DecisionBatch.of(size, "app", kind))
        assert {m.name for m in got} == {want}, f"phase {k}"
        switches += k and want != recorded[k - 1][4]
        eng.bus.publish_flow_arrays(lat, stalls)
    assert switches > 0          # the stream exercises both branches
    site, ref_site = eng.policy.site("app"), ref_eng.policy.site("app")
    assert site.decisions == ref_site.decisions
    assert {m.name: (p.latency_cycles, p.stall_cycles_per_flit, p.age)
            for m, p in site.samples.items()} == \
        {m.name: (p.latency_cycles, p.stall_cycles_per_flit, p.age)
         for m, p in ref_site.samples.items()}


def test_app_aware_router_shim_warns_and_matches():
    with pytest.warns(DeprecationWarning):
        ref_router = ref_core.AppAwareRouter(
            ref_core.RouterConfig(cumulative_threshold_bytes=2048))
    with pytest.warns(DeprecationWarning):
        router = port_core.AppAwareRouter(
            port_core.RouterConfig(cumulative_threshold_bytes=2048))
    rng = np.random.default_rng(5)
    for _ in range(200):
        size = int(2 ** rng.uniform(6, 22))
        a2a = bool(rng.random() < 0.3)
        want = ref_router.select(size, alltoall=a2a)
        assert router.select(size, alltoall=a2a).name == want.name
        lat, st = rng.uniform(100, 5e4), rng.uniform(0, 5)
        ref_router.observe(lat, st)
        router.observe(lat, st)
    for m, rm in zip(PortMode, RefMode):
        assert router.traffic_fraction(m) == ref_router.traffic_fraction(rm)
    assert router.gated_fraction() == ref_router.gated_fraction()
    assert {m.name: v for m, v in router.sent_bytes_by_mode.items()} == \
        {m.name: v for m, v in ref_router.sent_bytes_by_mode.items()}


def test_core_exports_and_lazy_shim_match_the_reference():
    assert set(port_core.__all__) == set(ref_core.__all__)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert port_core.RouterConfig is port_policy.AppAwareConfig
    with pytest.raises(AttributeError):
        port_core.NotAThing          # noqa: B018


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_noise_statistics_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    exec_us = rng.lognormal(3.0, 0.4, size=64)
    exec_us[::17] *= 30.0                      # Fig. 3's outlier tails
    latency_us = rng.gamma(2.0, 1.5, size=64)
    stalls = rng.uniform(0.0, 10.0, size=64)
    want = ref_estimate_noise("a0", exec_us, latency_us, stalls)
    got = estimate_noise("a0", exec_us, latency_us, stalls)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.network_noise == want.network_noise
    assert port_core.qcd(exec_us) == ref_core.qcd(exec_us)
    assert port_core.iqr(exec_us) == ref_core.iqr(exec_us)


def test_noise_estimator_refuses_pooled_allocations():
    from repro_torch.core.noise import AllocationMismatch, NoiseEstimator
    est = NoiseEstimator("a0")
    with pytest.raises(AllocationMismatch):
        est.add(allocation_id="a1", exec_us=1.0, latency_us=1.0,
                stalls_per_flit=0.0)


@pytest.mark.parametrize("seed", [0, 2])
def test_calibration_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    obs = []
    for _ in range(12):
        l_ad, s_ad = rng.uniform(500, 5e4), rng.uniform(0.0, 4.0)
        obs.append((l_ad, s_ad, l_ad * rng.uniform(0.5, 1.2),
                    s_ad * rng.uniform(1.0, 3.0)))
    got, want = calibrate_scaling_factors(obs), ref_calibrate(obs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.as_router_kwargs() == want.as_router_kwargs()


def test_flit_threshold_keeps_the_reference_minus_inf_at_a_subnormal_gap():
    """ROADMAP C12, a fault of the reference kept for parity: Eq. (4)'s
    ``flit_threshold`` divides by ``s_b - s_a`` and returns -inf when
    that gap is subnormal and ``l_a < l_b``, where hypothesis's draw
    ``s_b = 5e-324`` makes tests/test_perf_model.py's crossover test read
    it as "b dominates".  Both packages return -inf there, and no flit
    count falls below it."""
    from repro.core.perf_model import flit_threshold as ref_threshold
    from repro_torch.core.perf_model import (flit_threshold,
                                             flits_and_packets)

    flits, packets = flits_and_packets(64)
    for fn in (ref_threshold, flit_threshold):
        thr = fn(100.0, 0.0, 101.0, 5e-324, packets)
        assert thr == -np.inf
        assert not flits < thr
