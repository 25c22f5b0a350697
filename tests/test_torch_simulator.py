"""The port's simulator (``device="cpu"``) against the reference.

The reference's NumPy backend is the oracle and its jax backend a second
witness.  Both draw every random number on the host, like the port, so
the generators stay in lockstep and every phase sees the same draws; the
float32 pipelines agree with the float64 NumPy kernel within the jax
engine's pinned ``JAX_RTOL = 2e-2`` (tests/test_jax_engine.py).
Integer outputs (flits), notification epochs and generator states are
held exactly.
"""

import dataclasses

import numpy as np
import pytest

import repro.dragonfly as ref
from repro.core.strategies import RoutingMode
from repro.dragonfly.routing import RoutingPolicy
from repro.dragonfly.topology import make_allocation
from repro.dragonfly.traffic import PATTERNS as REF_PATTERNS
from repro.dragonfly.traffic import run_iteration as ref_run_iteration
from repro.faults import FaultSchedule, link_down, router_down
import repro_torch.dragonfly as port
from repro_torch.core.strategies import RoutingMode as PortRoutingMode
from repro_torch.dragonfly.convert import simulator_state, state_from_reference
from repro_torch.dragonfly.topology import make_allocation as port_allocation
from repro_torch.faults import FaultSchedule as PortFaultSchedule
from repro_torch.faults import link_down as port_link_down
from repro_torch.faults import router_down as port_router_down

JAX_RTOL = 2e-2   # float32 pipelines vs float64 numpy (test_jax_engine.py)

TOPO_KW = dict(n_groups=4, chassis_per_group=2, blades_per_chassis=4)


def _flows(topo, seed=42, n=400):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, topo.n_nodes, size=n)
    dst = (src + rng.integers(1, topo.n_nodes, size=n)) % topo.n_nodes
    size = rng.pareto(1.2, size=n) * 65536 + 1024
    return src, dst, size


def _assert_close(rp, rn, rtol=JAX_RTOL):
    np.testing.assert_allclose(rp.t_us, rn.t_us, rtol=rtol)
    np.testing.assert_allclose(rp.latency_us, rn.latency_us, rtol=rtol)
    np.testing.assert_allclose(rp.stalls_per_flit, rn.stalls_per_flit,
                               rtol=rtol, atol=1e-4)
    assert np.array_equal(rp.flits, rn.flits)
    assert np.array_equal(rp.packets, rn.packets)
    if rn.stranded is None:
        assert rp.stranded is None
    else:
        assert np.array_equal(rp.stranded, rn.stranded)


def _policies(mode_name):
    return (RoutingPolicy(RoutingMode[mode_name]),
            port.RoutingPolicy(PortRoutingMode[mode_name]))


def _same_rng(a, b):
    assert a.rng.bit_generator.state == b.rng.bit_generator.state


# --------------------------------------------------------------------------
# Parity matrix: topology family x {healthy, faulted, notifying}.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["aries", "dragonfly", "dragonfly_plus"])
@pytest.mark.parametrize("scenario", ["healthy", "faulted", "notifying"])
def test_port_parity_topology_family(name, scenario):
    rtopo, ptopo = ref.small_topology(name), port.small_topology(name)
    assert ptopo.spec_str() == rtopo.spec_str()
    src, dst, size = _flows(rtopo, seed=7)
    kw = {"seed": 5}
    if scenario == "notifying":
        kw.update(notify_threshold_s=1e-5, notify_penalty_s=300e-6)
    sims = {be: ref.DragonflySimulator(rtopo, ref.SimParams(backend=be, **kw))
            for be in ("numpy", "jax")}
    psim = port.DragonflySimulator(ptopo, port.SimParams(**kw), device="cpu")
    if scenario == "faulted":
        dead = [1, rtopo.n_links // 2]
        for sim in sims.values():
            sim.set_faults(FaultSchedule.of(link_down(dead, start=0)))
        psim.set_faults(PortFaultSchedule.of(port_link_down(dead, start=0)))
    rpol, ppol = _policies("ADAPTIVE_2")
    for _ in range(3):      # phase 2+ sees raised notifications / queues
        rn = sims["numpy"].run_phase(src, dst, size, rpol)
        rj = sims["jax"].run_phase(src, dst, size, rpol)
        rp = psim.run_phase(src, dst, size, ppol)
        _assert_close(rp, rn)
        _assert_close(rp, rj)
        _same_rng(psim, sims["numpy"])
        assert psim.notify_epoch() == sims["numpy"].notify_epoch() \
            == sims["jax"].notify_epoch()
    np.testing.assert_allclose(psim.link_queue_s, sims["numpy"].link_queue_s,
                               rtol=JAX_RTOL, atol=1e-9)


def test_faulted_plan_replay_strands_the_same_flows():
    """Fault candidate masks ride the plan-pinned path; flows with every
    candidate dead are stranded on both sides."""
    rtopo = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))
    ptopo = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
    src, dst, size = _flows(rtopo, seed=11)
    rsim = ref.DragonflySimulator(rtopo, ref.SimParams(seed=3))
    psim = port.DragonflySimulator(ptopo, port.SimParams(seed=3),
                                   device="cpu")
    # a dead router takes its nodes' NIC links along: their flows strand
    rsim.set_faults(FaultSchedule.of(link_down(n_random=6, seed=4),
                                     router_down([0])))
    psim.set_faults(PortFaultSchedule.of(port_link_down(n_random=6, seed=4),
                                         port_router_down([0])))
    rplan, pplan = rsim.plan_for(src, dst, size), psim.plan_for(src, dst, size)
    rpol, ppol = _policies("ADAPTIVE_3")
    for _ in range(2):
        rn = rsim.run_phase(src, dst, size, rpol, plan=rplan)
        rp = psim.run_phase(src, dst, size, ppol, plan=pplan)
        _assert_close(rp, rn)
        _same_rng(psim, rsim)
    assert rn.n_stranded > 0
    assert pplan.device_tensors is not None


# --------------------------------------------------------------------------
# Plans, reset_queues and epoch bumps.
# --------------------------------------------------------------------------
def test_plan_replay_reset_and_epoch_bump():
    """One life: planned phases -> reset_queues -> phase -> fault epoch
    bump -> fresh plan.  The port tracks the NumPy oracle through every
    transition, and the bump hands back a fresh plan whose device
    tensors are pinned lazily."""
    rtopo = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))
    ptopo = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
    src, dst, size = _flows(rtopo, seed=13)
    rpol, ppol = _policies("ADAPTIVE_0")
    rsim = ref.DragonflySimulator(rtopo, ref.SimParams(seed=9))
    psim = port.DragonflySimulator(ptopo, port.SimParams(seed=9),
                                   device="cpu")
    rplan, pplan = rsim.plan_for(src, dst, size), psim.plan_for(src, dst, size)
    assert np.array_equal(pplan.pair_links, rplan.pair_links)
    assert pplan.device_tensors is None
    for _ in range(3):
        _assert_close(psim.run_phase(src, dst, size, ppol, plan=pplan),
                      rsim.run_phase(src, dst, size, rpol, plan=rplan))
        _same_rng(psim, rsim)
    assert psim.plan_for(src, dst, size) is pplan     # cached
    assert pplan.device_tensors is not None

    psim.reset_queues()
    rsim.reset_queues()
    assert np.all(psim.link_queue_s == 0.0)
    assert np.all(psim.est_memory_s == 0.0)
    _assert_close(psim.run_phase(src, dst, size, ppol, plan=pplan),
                  rsim.run_phase(src, dst, size, rpol, plan=rplan))

    rsim.set_faults(FaultSchedule.of(link_down([2, 5], start=5)))
    psim.set_faults(PortFaultSchedule.of(port_link_down([2, 5], start=5)))
    _assert_close(psim.run_phase(src, dst, size, ppol),       # still healthy
                  rsim.run_phase(src, dst, size, rpol))
    assert psim.fault_epoch() == rsim.fault_epoch() > 0
    pplan2, rplan2 = psim.plan_for(src, dst, size), rsim.plan_for(src, dst,
                                                                  size)
    assert pplan2 is not pplan and pplan2.device_tensors is None
    _assert_close(psim.run_phase(src, dst, size, ppol, plan=pplan2),
                  rsim.run_phase(src, dst, size, rpol, plan=rplan2))
    assert pplan2.device_tensors is not None
    _same_rng(psim, rsim)


def test_counters_and_clock_follow_the_reference():
    rtopo = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))
    ptopo = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
    ralloc = make_allocation(rtopo, 16, spread="inter_groups", seed=3)
    palloc = port_allocation(ptopo, 16, spread="inter_groups", seed=3)
    assert palloc == ref_alloc_as_port(ralloc)
    src, dst, size = _flows(rtopo, seed=2, n=200)
    rpol, ppol = _policies("ADAPTIVE_1")
    rsim = ref.DragonflySimulator(rtopo, ref.SimParams(seed=4))
    psim = port.DragonflySimulator(ptopo, port.SimParams(seed=4),
                                   device="cpu")
    for _ in range(2):
        psim.run_phase(src, dst, size, ppol, palloc)
        rsim.run_phase(src, dst, size, rpol, ralloc)
    rc = rsim.counters[ralloc.allocation_id]
    pc = psim.counters[palloc.allocation_id]
    assert pc.request_flits == rc.request_flits
    assert pc.request_packets == rc.request_packets
    np.testing.assert_allclose(pc.request_packets_cumulative_latency_us,
                               rc.request_packets_cumulative_latency_us,
                               rtol=JAX_RTOL)
    np.testing.assert_allclose(psim.clock_s, rsim.clock_s, rtol=JAX_RTOL)
    assert psim.total_flits_all_jobs == rsim.total_flits_all_jobs


def ref_alloc_as_port(alloc):
    return port.Allocation(alloc.allocation_id, alloc.nodes)


# --------------------------------------------------------------------------
# State carried across from the reference.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", ["healthy", "notifying"])
def test_state_from_reference_continues_the_run(scenario):
    """Two reference phases, carry the state, phase 3 on both."""
    rtopo = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))
    ptopo = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
    kw = {"seed": 21, "bg_rotate_phases": 2}
    if scenario == "notifying":
        kw["notify_threshold_s"] = 1e-5
    ralloc = make_allocation(rtopo, 16, spread="scattered", seed=1)
    palloc = ref_alloc_as_port(ralloc)
    src, dst, size = _flows(rtopo, seed=5)
    rpol, ppol = _policies("ADAPTIVE_0")
    rsim = ref.DragonflySimulator(rtopo, ref.SimParams(**kw))
    for _ in range(2):
        rsim.run_phase(src, dst, size, rpol, ralloc)
    assert rsim.link_queue_s.any()
    if scenario == "notifying":
        assert rsim.notified_links.any()

    psim = port.DragonflySimulator(ptopo, port.SimParams(**kw),
                                   device="cpu")
    state_from_reference(psim, simulator_state(rsim))
    _same_rng(psim, rsim)
    assert psim.phase_index == rsim.phase_index == 2
    assert np.array_equal(psim.link_notify_age, rsim.link_notify_age)

    rn = rsim.run_phase(src, dst, size, rpol, ralloc)
    rp = psim.run_phase(src, dst, size, ppol, palloc)
    _assert_close(rp, rn)
    _same_rng(psim, rsim)
    assert psim.notify_epoch() == rsim.notify_epoch()
    assert np.array_equal(psim._hot_groups, rsim._hot_groups)
    assert dataclasses.asdict(psim.counters[palloc.allocation_id])[
        "request_flits"] == rsim.counters[ralloc.allocation_id].request_flits


def test_state_from_reference_rejects_another_topology():
    rsim = ref.DragonflySimulator(ref.small_topology("aries"),
                                  ref.SimParams())
    psim = port.DragonflySimulator(port.small_topology("dragonfly"),
                                   port.SimParams(), device="cpu")
    with pytest.raises(ValueError):
        state_from_reference(psim, simulator_state(rsim))


# --------------------------------------------------------------------------
# Copied host modules: topology family, patterns, run_iteration.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["aries", "dragonfly", "dragonfly_plus",
                                  "fattree"])
def test_topology_copy_draws_the_same_paths(name):
    rtopo, ptopo = ref.small_topology(name), port.small_topology(name)
    assert port.registered_topologies() == ref.registered_topologies()
    assert ptopo.n_links == rtopo.n_links
    assert np.array_equal(ptopo.capacity_gbs, rtopo.capacity_gbs)
    src, dst, _ = _flows(rtopo, seed=3, n=100)
    a, nm_a = rtopo.candidate_paths(src, dst, np.random.default_rng(0))
    b, nm_b = ptopo.candidate_paths(src, dst, np.random.default_rng(0))
    assert np.array_equal(a, b) and np.array_equal(nm_a, nm_b)


PATTERN_ARGS = {
    "pingpong": (16, 4096), "allreduce": (16, 1024), "alltoall": (8, 512),
    "barrier": (16,), "broadcast": (16, 2048), "halo3d": (27, 24),
    "sweep3d": (16, 32), "moe_alltoall": (8,),
}


@pytest.mark.parametrize("pattern", sorted(PATTERN_ARGS))
def test_patterns_match_the_reference(pattern):
    assert sorted(port.PATTERNS) == sorted(REF_PATTERNS)
    want = REF_PATTERNS[pattern](*PATTERN_ARGS[pattern])
    got = port.PATTERNS[pattern](*PATTERN_ARGS[pattern])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("use_plans", [False, True])
def test_run_iteration_matches_the_reference(use_plans):
    rtopo = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))
    ptopo = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
    ralloc = make_allocation(rtopo, 27, spread="groups:2", seed=6)
    phases = REF_PATTERNS["halo3d"](27, 48)
    rpol, ppol = _policies("ADAPTIVE_3")
    rsim = ref.DragonflySimulator(rtopo, ref.SimParams(seed=8))
    psim = port.DragonflySimulator(ptopo, port.SimParams(seed=8),
                                   device="cpu")
    for _ in range(2):
        want = ref_run_iteration(rsim, ralloc, phases, rpol,
                                 use_plans=use_plans)
        got = port.run_iteration(psim, ref_alloc_as_port(ralloc), phases,
                                 ppol, use_plans=use_plans)
        for f in ("time_us", "mean_latency_us", "mean_stalls",
                  "nonmin_fraction"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=JAX_RTOL, err_msg=f)
        _same_rng(psim, rsim)
