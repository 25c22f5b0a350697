"""The port's tenancy engine (``repro_torch.tenancy``) and the
simulator's ``tenants=`` path, on the CPU, against the reference.

The reference's NumPy backend is the oracle (float64); the port's
float32 pipeline is held at the jax engine's ``JAX_RTOL``.  Within the
port, a K=1 tenant segment is bit-identical to ``allocation=``, and the
lockstep sweep's records equal the sequential sweep's, as
tests/test_tenancy.py and tests/test_jax_engine.py hold them for the
reference.  Generators stay in lockstep, so integer outputs (flits,
stranded flows, recovery rounds) are held exactly.
"""

import sys

import numpy as np
import pytest
import torch

import repro.dragonfly as ref
import repro_torch.dragonfly as port
from repro.core.strategies import RoutingMode as RefMode
from repro.dragonfly.topology import make_allocation as ref_allocation
from repro.faults import FaultSchedule as RefSchedule
from repro.faults import link_degrade as ref_link_degrade
from repro.faults import link_down as ref_link_down
from repro.tenancy import InterferenceEngine as RefEngine
from repro.tenancy import TenancyMix as RefMix
from repro.tenancy import Workload as RefWorkload
from repro.tenancy import sweep as ref_sweep
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import torch_backend
from repro_torch.dragonfly.topology import make_allocation
from repro_torch.faults import FaultSchedule, link_degrade, link_down
from repro_torch.tenancy import (InterferenceEngine, TenancyMix, Workload,
                                 run_mixes_lockstep, sweep)

from test_torch_simulator import JAX_RTOL

#: the sweep module (the package exports the function under its name)
sweep_module = sys.modules["repro_torch.tenancy.sweep"]

#: per-tenant loads (float64 on the host) against the float32 global
#: backlog: float32 sums of positive terms, a few ulps each
LOAD_SUM_RTOL = 1e-5

TOPO_KW = dict(n_groups=4, chassis_per_group=2, blades_per_chassis=4)
TOPO = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
REF_TOPO = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))


def _flows(alloc, seed=42, n=400):
    rng = np.random.default_rng(seed)
    nodes = np.asarray(alloc.nodes)
    src = nodes[rng.integers(0, len(nodes), size=n)]
    dst = nodes[rng.integers(0, len(nodes), size=n)]
    size = rng.pareto(1.2, size=n) * 65536 + 1024
    return src, dst, size


def _mix(pkg_mix, pkg_workload, mode, victim_arm="ADAPTIVE_3"):
    """tests/test_jax_engine.py's two-tenant mix, in either package."""
    arm = victim_arm if victim_arm == "app_aware" else mode[victim_arm]
    return pkg_mix("mix2", (
        pkg_workload("vic", "halo3d", 16, {"nx": 32, "vars_": 2}, arm=arm),
        pkg_workload("agg", "alltoall", 24, {"size_per_pair": 16384},
                     arm=mode.ADAPTIVE_0)))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=1e-9,
                               err_msg=what)


# ------------------------------------------------------------ tenants= path
@pytest.mark.parametrize("mode", ["ADAPTIVE_0", "ADAPTIVE_3"])
def test_k1_tenants_bit_identical_to_allocation(mode):
    al = make_allocation(TOPO, 12, spread="inter_groups", seed=3)
    src, dst, size = _flows(al)
    pol = port.RoutingPolicy(RoutingMode[mode])
    sims = [port.DragonflySimulator(TOPO, port.SimParams(seed=0),
                                    device="cpu") for _ in range(2)]
    seg = port.TenantSegments.of([al], [len(size)])
    for _ in range(3):
        ra = sims[0].run_phase(src, dst, size, pol, allocation=al)
        rt = sims[1].run_phase(src, dst, size, pol, tenants=seg)
        assert np.array_equal(ra.t_us, rt.t_us)
        assert np.array_equal(ra.latency_us, rt.latency_us)
        assert np.array_equal(ra.stalls_per_flit, rt.stalls_per_flit)
        assert ra.nonmin_fraction == rt.nonmin_fraction
    assert np.array_equal(sims[0].link_queue_s, sims[1].link_queue_s)
    assert sims[0].rng.bit_generator.state == sims[1].rng.bit_generator.state
    ca, ct = (s.counters[al.allocation_id] for s in sims)
    assert (ca.request_flits, ca.request_packets) == \
        (ct.request_flits, ct.request_packets)
    assert rt.tenant_of is not None and ra.tenant_of is None


def _tenant_phase(pkg, alloc_fn, mode, k, seed, **params):
    allocs, used = [], set()
    rng = np.random.default_rng(seed)
    topo = TOPO if pkg is port else REF_TOPO
    for i in range(k):
        pool = np.asarray(sorted(set(range(topo.n_nodes)) - used))
        nodes = rng.choice(pool, size=8, replace=False)
        used.update(int(x) for x in nodes)
        allocs.append(pkg.Allocation(f"t{i}", tuple(int(x) for x in nodes)))
    counts = [int(rng.integers(10, 80)) for _ in range(k)]
    srcs, dsts, sizes = zip(*[_flows(a, seed=seed + i, n=c)
                              for i, (a, c) in enumerate(zip(allocs,
                                                             counts))])
    seg = pkg.TenantSegments.of(allocs, counts)
    kw = {"device": "cpu"} if pkg is port else {}
    sim = pkg.DragonflySimulator(topo, pkg.SimParams(seed=seed, **params),
                                 **kw)
    out = []
    for _ in range(2):
        out.append(sim.run_phase(
            np.concatenate(srcs), np.concatenate(dsts),
            np.concatenate(sizes), pkg.RoutingPolicy(mode.ADAPTIVE_0),
            tenants=seg))
    return sim, allocs, out


@pytest.mark.parametrize("k,max_flows", [(2, 120_000), (3, 120_000),
                                         (2, 64)])
def test_tenant_breakdown_matches_the_reference(k, max_flows):
    """Per-tenant link loads and non-minimal fractions at JAX_RTOL (two
    phases, queues carried; also through max_flows subsampling); the
    rows sum to the global backlog; NIC counters partition the flits."""
    psim, pallocs, got = _tenant_phase(port, make_allocation, RoutingMode,
                                       k, 7, max_flows=max_flows)
    rsim, _, want = _tenant_phase(ref, ref_allocation, RefMode, k, 7,
                                  max_flows=max_flows, backend="numpy")
    for g, w in zip(got, want):
        assert np.array_equal(g.tenant_of, w.tenant_of)
        assert g.tenant_link_loads.shape == (k + 1, TOPO.n_links)
        top = np.abs(w.tenant_link_loads).max()
        np.testing.assert_allclose(g.tenant_link_loads, w.tenant_link_loads,
                                   rtol=JAX_RTOL, atol=JAX_RTOL * top)
        _close(g.tenant_nonmin_fraction, w.tenant_nonmin_fraction,
               "tenant_nonmin_fraction")
        _close(g.t_us, w.t_us, "t_us")
        # the breakdown is a float64 host sum of the float32 spray
        # weights; link_load_q is the pipeline's float32 segment sum of
        # the same positive terms: float32 accumulation, not the
        # reference's float64 1e-9
        np.testing.assert_allclose(g.tenant_link_loads.sum(axis=0),
                                   g.link_load_q, rtol=LOAD_SUM_RTOL,
                                   atol=1e-6)
    assert sum(psim.counters[a.allocation_id].request_flits
               for a in pallocs) == int(got[-1].flits.sum()) + \
        int(got[0].flits.sum())
    assert psim.rng.bit_generator.state == rsim.rng.bit_generator.state


# -------------------------------------------------------------------- sweep
ARMS = ("MIN_HASH", "ADAPTIVE_3", "app_aware")


def _arms(mode):
    return {a: a if a == "app_aware" else mode[a] for a in ARMS}


def _port_sweep(lockstep, rounds=3):
    return sweep(TOPO, [_mix(TenancyMix, Workload, RoutingMode)],
                 _arms(RoutingMode), params=port.SimParams(), rounds=rounds,
                 device="cpu", lockstep=lockstep)


def _ref_sweep(rounds=3):
    return ref_sweep(REF_TOPO, [_mix(RefMix, RefWorkload, RefMode)],
                     _arms(RefMode), params=ref.SimParams(backend="numpy"),
                     rounds=rounds, lockstep=False)


def test_lockstep_sweep_equals_sequential_sweep():
    seq = _port_sweep(lockstep=False)
    before = dict(torch_backend.PIPELINE_CALLS)
    lck = _port_sweep(lockstep=True)
    # 3 rounds of the mix, then of each tenant's run-alone baseline, one
    # batched dispatch per round for the 3-cell column
    assert torch_backend.PIPELINE_CALLS["batched"] - before["batched"] \
        == 3 * 3
    assert torch_backend.PIPELINE_CALLS["single"] == before["single"]
    assert len(seq) == len(lck) == len(ARMS)
    for a, b in zip(seq, lck):
        assert a == b


@pytest.mark.parametrize("lockstep", [False, True])
def test_sweep_matches_the_reference(lockstep):
    got = {r["policy"]: r for r in _port_sweep(lockstep)}
    want = {r["policy"]: r for r in _ref_sweep()}
    assert sorted(got) == sorted(want) == sorted(ARMS)
    for label, w in want.items():
        g = got[label]
        for key, v in w.items():
            if isinstance(v, float):
                _close(g[key], v, f"{label}.{key}")
            elif isinstance(v, dict):
                assert sorted(g[key]) == sorted(v)
                for name in v:
                    _close(g[key][name], v[name], f"{label}.{key}.{name}")
            else:
                assert g[key] == v, f"{label}.{key}"


def test_lockstep_rule_follows_the_device(monkeypatch):
    """On by default where the engines' device is CUDA, off on the CPU;
    with no device and no CUDA, the engines refuse to run."""
    assert sweep_module._auto_lockstep("cpu") is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert sweep_module._auto_lockstep(None) is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_module._auto_lockstep(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InterferenceEngine(TOPO, port.SimParams())
    called = []
    monkeypatch.setattr(sweep_module, "run_mixes_lockstep",
                        lambda *a, **k: called.append(1) or
                        run_mixes_lockstep(*a, **k))
    _port_sweep(lockstep=None, rounds=1)
    assert not called                       # CPU: sequential cells


def test_run_mixes_lockstep_matches_run_mix():
    """Two mixes of different shapes in one lockstep drive: each keeps
    its own simulator; results equal per-cell run_mix."""
    mixes = [_mix(TenancyMix, Workload, RoutingMode, "ADAPTIVE_0"),
             TenancyMix("solo", (Workload("vic", "alltoall", 12,
                                          {"size_per_pair": 4096}),))]
    engines = [InterferenceEngine(TOPO, port.SimParams(seed=3), seed=3,
                                  device="cpu") for _ in mixes]
    got = run_mixes_lockstep(engines, mixes, rounds=2)
    for res, mix in zip(got, mixes):
        want = InterferenceEngine(TOPO, port.SimParams(seed=3), seed=3,
                                  device="cpu").run_mix(mix, rounds=2)
        assert [t.time_us for t in res.tenants] == \
            [t.time_us for t in want.tenants]
        assert [t.alone_time_us for t in res.tenants] == \
            [t.alone_time_us for t in want.tenants]
        assert np.array_equal(res.tenant_link_loads, want.tenant_link_loads)
    assert got[1].victim_slowdown == 1.0


# ------------------------------------------------------------------- faults
def _small_mix(mix_cls, workload_cls, mode):
    return mix_cls("mix", (
        workload_cls("vic", "halo3d", 12, {"nx": 32, "vars_": 2},
                     arm="app_aware"),
        workload_cls("agg", "alltoall", 12, {"size_per_pair": 8192},
                     arm=mode.ADAPTIVE_0)))


def _reports(res):
    return [(t.name, t.time_us, t.alone_time_us, t.round_times_us,
             t.stranded_flows, t.recovery_rounds, t.recovery_time_us)
            for t in res.tenants]


def _hold_reports(got, want):
    for g, w in zip(_reports(got), _reports(want)):
        assert g[0] == w[0]
        for i, what in ((1, "time_us"), (2, "alone_time_us"),
                        (3, "round_times_us")):
            if w[i] is None:
                assert g[i] is None
            else:
                _close(g[i], w[i], f"{w[0]}.{what}")
        assert g[4] == w[4], f"{w[0]} stranded_flows"
        assert g[5] == w[5], f"{w[0]} recovery_rounds"
        if w[6] is None:
            assert g[6] is None
        else:
            _close(g[6], w[6], f"{w[0]} recovery_time_us")


@pytest.mark.parametrize("scenario", ["link_down", "degrade_no_baselines"])
def test_run_mix_with_faults_matches_the_reference(scenario):
    """tests/test_faults.py's recovery cases on both packages: per-round
    times at JAX_RTOL; stranded flows and recovery rounds equal."""
    if scenario == "link_down":
        sched = FaultSchedule.of(link_down(start=1, end=3, n_random=2,
                                           link_kind="global", seed=3))
        ref_sched = RefSchedule.of(ref_link_down(
            start=1, end=3, n_random=2, link_kind="global", seed=3))
        kw = dict(rounds=6)
    else:
        sched = FaultSchedule.of(link_degrade(
            0.5, start=2, end=4, n_random=2, link_kind="global", seed=7))
        ref_sched = RefSchedule.of(ref_link_degrade(
            0.5, start=2, end=4, n_random=2, link_kind="global", seed=7))
        kw = dict(rounds=5, baselines=False)
    got = InterferenceEngine(TOPO, port.SimParams(seed=5, bg_enable=False),
                             seed=5, device="cpu").run_mix(
        _small_mix(TenancyMix, Workload, RoutingMode), faults=sched, **kw)
    want = RefEngine(REF_TOPO, ref.SimParams(seed=5, bg_enable=False,
                                             backend="numpy"),
                     seed=5).run_mix(
        _small_mix(RefMix, RefWorkload, RefMode), faults=ref_sched, **kw)
    assert got.faults == want.faults
    _hold_reports(got, want)
    for rep in got.tenants:
        assert len(rep.round_times_us) == kw["rounds"]


def test_recovery_metric_math_is_the_references():
    eng = InterferenceEngine(TOPO, port.SimParams(seed=0, bg_enable=False),
                             device="cpu")
    reng = RefEngine(REF_TOPO, ref.SimParams(seed=0, bg_enable=False))
    sched = FaultSchedule.of(link_down([0], start=2, end=4))
    rsched = RefSchedule.of(ref_link_down([0], start=2, end=4))
    cases = [([10.0, 10.0, 30.0, 30.0, 20.0, 10.0], None),
             ([10.0, 10.0, 30.0, 30.0, 10.5, 10.0], None),
             ([10.0, 10.0, 30.0, 30.0, 30.0, 30.0], None),
             ([10.0, 40.0, 90.0, 90.0, 10.0, 41.0],
              [10.0, 40.0, 10.0, 40.0, 10.0, 40.0])]
    got = [eng._recovery(t, sched, clean=c) for t, c in cases]
    assert got == [reng._recovery(t, rsched, clean=c) for t, c in cases]
    assert got == [(1, 20.0), (0, 0.0), (-1, -1.0), (0, 0.0)]
