"""The port's NumPy copies on the fault path against the reference:
``repro_torch.runtime`` (fault tolerance, straggler mitigation, elastic
scaling), ``repro_torch.faults.detection`` and
``repro_torch.dragonfly.invariants``.

Each case runs the reference's own scenario (tests/test_train_ckpt_
runtime.py, tests/test_faults.py, tests/test_topology_family.py) through
both packages on the same inputs.  The copies are NumPy and pure Python,
so every result is held equal, not close.
"""

import numpy as np
import pytest

import repro.dragonfly as ref
import repro_torch.dragonfly as port
from repro.dragonfly.topology import make_allocation as ref_allocation
from repro.dragonfly import invariants as ref_inv
from repro.faults import HeartbeatDriver as RefDriver
from repro.faults import FaultSchedule as RefSchedule
from repro.faults import link_degrade as ref_link_degrade
from repro.faults import link_down as ref_link_down
from repro.faults import remap_allocation as ref_remap
from repro.faults import router_down as ref_router_down
from repro.runtime import elastic as ref_elastic
from repro.runtime import fault_tolerance as ref_ft
from repro.runtime import straggler as ref_straggler
from repro_torch import runtime
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import invariants as inv
from repro_torch.faults import (FaultSchedule, HeartbeatDriver, link_degrade,
                                link_down, remap_allocation, router_down)
from repro_torch.runtime import elastic, fault_tolerance as ft, straggler

NAMES = port.registered_topologies()
SMALL = {name: port.small_topology(name) for name in NAMES}


def test_family_registry_matches_the_reference():
    assert NAMES == ref.registered_topologies()


# ---------------------------------------------------------------- runtime
def _heartbeats(mod):
    cfg = mod.FaultToleranceConfig(heartbeat_interval_s=5.0)
    mon = mod.HeartbeatMonitor(["n0", "n1"], cfg, now_s=0.0)
    t, seen = 0.0, []
    for _ in range(20):
        t += 5.0
        mon.heartbeat("n0", t)
        mon.heartbeat("n1", t)
    for _ in range(20):            # n1 goes silent
        t += 5.0
        mon.heartbeat("n0", t)
        seen.append((mon.state("n0", t).name, mon.state("n1", t).name,
                     tuple(mon.dead_nodes(t))))
    return seen


def test_heartbeat_monitor_matches_the_reference():
    got, want = _heartbeats(ft), _heartbeats(ref_ft)
    assert got == want
    assert got[-1] == ("HEALTHY", "DEAD", ("n1",))


def _restarts(mod):
    out = []
    pol = mod.RestartPolicy(mod.FaultToleranceConfig(), spares_available=1)
    out += [pol.on_failure(["n1"], 10.0).name,
            pol.on_failure(["n2"], 20.0).name]
    pol = mod.RestartPolicy(mod.FaultToleranceConfig(max_restarts_per_hour=2),
                            spares_available=10)
    out += [pol.on_failure([n], t).name
            for n, t in (("a", 1.0), ("b", 2.0), ("c", 3.0))]
    return out


def test_restart_policy_matches_the_reference():
    got = _restarts(ft)
    assert got == _restarts(ref_ft)
    assert got[:2] == ["RESTART_IN_PLACE", "ELASTIC_SHRINK"]
    assert got[-1] == "ABORT"


def _straggler(mod):
    mit = mod.StragglerMitigator(4, mod.StragglerConfig(persistent_misses=3))
    actions = [mit.record_step({0: 1.0, 1: 1.01, 2: 0.99, 3: 10.0})
               for _ in range(6)]
    return actions, mit.batch_shares()


def test_straggler_mitigator_matches_the_reference():
    (acts, shares), (ref_acts, ref_shares) = \
        _straggler(straggler), _straggler(ref_straggler)
    assert acts == ref_acts and shares == ref_shares
    assert acts[-1][3] == "evict" and shares[3] < shares[0]
    assert sum(shares.values()) == pytest.approx(4.0)


@pytest.mark.parametrize("n_devices", [512, 256, 272, 64, 16])
def test_elastic_planner_matches_the_reference(n_devices):
    def plan(mod):
        pl = mod.ElasticPlanner(mod.ElasticConfig(model_axis=16,
                                                  target_global_batch=256))
        try:
            p = pl.plan(n_devices)
        except ValueError as err:
            return ("ValueError", str(err))
        return (p.mesh_shape, p.global_batch, p.grad_accum)
    got = plan(elastic)
    assert got == plan(ref_elastic)
    if n_devices == 16:
        assert got[0] == "ValueError"


def test_runtime_exports_the_reference_names():
    import repro.runtime as ref_runtime
    for name in ref_runtime.__all__:
        assert getattr(runtime, name).__module__.startswith(
            "repro_torch.runtime."), name
    assert runtime.HOPPER == (9, 0) and callable(runtime.resolve_device)


# -------------------------------------------------------------- detection
def _allocation(pkg):
    return port.make_allocation if pkg is port else ref_allocation


def _driver(pkg, sched, drv_cls, ft_mod):
    topo = pkg.small_topology("dragonfly")
    down_spec = router_down if pkg is port else ref_router_down
    bound = sched.of(down_spec([0], start=3)).bind(topo)
    down = set(int(n) for n in bound.down_nodes_at(3))
    alloc = _allocation(pkg)(topo, 6, spread="inter_groups", seed=5)
    if not down & set(int(n) for n in alloc.nodes):
        nodes = tuple(sorted(down))[:1] + tuple(alloc.nodes)[:-1]
        alloc = type(alloc)(allocation_id=alloc.allocation_id, nodes=nodes)
    drv = drv_cls(bound, alloc, ft_mod.FaultToleranceConfig(), seed=9)
    silenced = [drv.tick(phase) for phase in range(7)]
    reports = [drv.poll(6), drv.poll(6)]
    return silenced, [(r.phase, r.dead_nodes, r.action.name,
                       r.allocation.allocation_id, r.allocation.nodes)
                      for r in reports], down


def test_heartbeat_driver_matches_the_reference():
    got = _driver(port, FaultSchedule, HeartbeatDriver, ft)
    want = _driver(ref, RefSchedule, RefDriver, ref_ft)
    assert got == want
    silenced, reports, down = got
    assert silenced[2] == () and silenced[3] != ()
    (_, dead, action, aid, nodes), (_, _, after, _, _) = reports
    assert action == "ELASTIC_SHRINK" and after == "NONE"
    assert aid.endswith("@remap1") and not set(nodes) & down


def test_remap_allocation_matches_the_reference():
    def cases(pkg, remap):
        topo = pkg.small_topology("aries")
        alloc = _allocation(pkg)(topo, 4, spread="inter_groups", seed=0)
        nodes = list(alloc.nodes)
        used = [n for n in range(topo.n_nodes) if n not in nodes[0:1]]
        return [remap(topo, alloc, [nodes[0]], used_nodes=used, seed=1,
                      tag="t"),
                remap(topo, alloc, [nodes[1]], down_nodes=[nodes[1]],
                      seed=1, tag="t"),
                remap(topo, alloc, [])]
    got, want = cases(port, remap_allocation), cases(ref, ref_remap)
    for g, w in zip(got, want):
        assert (g.allocation_id, g.nodes) == (w.allocation_id, w.nodes)
    assert len(got[0].nodes) == 3 and len(got[1].nodes) == 4


# ------------------------------------------------------------- invariants
@pytest.mark.parametrize("name", NAMES)
def test_invariant_battery_on_every_family(name):
    inv.check_all(SMALL[name], n_pairs=128)
    src, dst = inv.sample_pairs(SMALL[name], n=48, seed=2)
    want = ref_inv.sample_pairs(ref.small_topology(name), n=48, seed=2)
    assert np.array_equal(src, want[0]) and np.array_equal(dst, want[1])


@pytest.mark.parametrize("name", NAMES)
def test_fault_mask_invariants_on_every_family(name):
    topo = SMALL[name]
    bound = FaultSchedule.of(
        link_down(n_random=2, seed=11),
        link_degrade(0.25, n_random=1, seed=12),
        router_down([0])).bind(topo)
    st = bound.state_at(0)
    ref_st = RefSchedule.of(
        ref_link_down(n_random=2, seed=11),
        ref_link_degrade(0.25, n_random=1, seed=12),
        ref_router_down([0])).bind(ref.small_topology(name)).state_at(0)
    assert np.array_equal(st.dead, ref_st.dead)
    inv.check_capacity_scale(topo, st)
    src, dst = inv.sample_pairs(topo, n=48, seed=2)
    inv.check_fault_mask(topo, st.dead, src, dst,
                         rng=np.random.default_rng(8))
    inv.check_fault_mask(topo, np.zeros(topo.n_links, dtype=bool),
                         src, dst, rng=np.random.default_rng(8))


def test_invariants_catch_a_broken_topology():
    class Liar(port.DragonflyTopology):
        def link_ranges(self):
            r = dict(super().link_ranges())
            lo, hi = r["global"]
            r["global"] = (lo, hi - 1)      # leaves a one-link gap
            return r

    with pytest.raises(inv.InvariantViolation):
        inv.check_link_ranges(Liar(SMALL["aries"].params))
    with pytest.raises(inv.InvariantViolation):
        inv.check_fault_mask(SMALL["aries"], np.zeros(3, dtype=bool),
                             np.zeros(1), np.ones(1))


def test_fault_mask_invariant_on_the_simulators_mask():
    """The port's simulator derives the same candidate mask as the
    invariant's scalar recheck accepts: on a faulted phase, a candidate
    survives iff no link of its path is dead."""
    topo = SMALL["aries"]
    sim = port.DragonflySimulator(
        topo, port.SimParams(seed=3, bg_enable=False),
        faults=FaultSchedule.of(link_down(n_random=6, seed=4)),
        device="cpu")
    src, dst = inv.sample_pairs(topo, n=64, seed=5)
    ctx = sim._phase_begin(src, dst, np.full(64, 4096.0),
                           port.RoutingPolicy(RoutingMode.ADAPTIVE_0))
    dead = sim.faults.state_at(0).dead
    assert not ctx["cand_mask"].all()          # some candidates died
    links = np.where(ctx["valid"], ctx["safe"], -1)
    for i in range(64):
        for c in range(links.shape[1]):
            path = links[i, c][links[i, c] >= 0]
            row_dead = dead[topo.nic_link(np.array([src[i]]))[0]] \
                or dead[topo.nic_link(np.array([dst[i]]))[0]]
            assert bool(ctx["cand_mask"][i, c]) == \
                (not dead[path].any() and not row_dead)
