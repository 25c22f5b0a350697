"""Batched phases: ``repro_torch.dragonfly.simulator.run_phase_batch``
and the batch-native pipeline (``torch_backend.prepare_batch``,
``fixed_point_torch_batch``) on the CPU.

Cells keep their own simulators and generators; only the fixed point is
shared.  On the CPU the batched dispatch sums every segment in the same
order as one phase alone (the sorted heads concatenated in batch order,
the tails after them), so ``t_us``, ``latency_us`` and ``flits`` are
held equal to sequential ``run_phase``, as tests/test_jax_engine.py
holds the reference's batch for both of its backends.  The port's batch
against the reference's ``run_phase_batch`` on its NumPy backend is held
at the jax engine's ``JAX_RTOL`` (float32 against float64).
"""

import numpy as np
import pytest

import repro.dragonfly as ref
import repro_torch.dragonfly as port
from repro.core.strategies import RoutingMode as RefMode
from repro.dragonfly.simulator import run_phase_batch as ref_run_phase_batch
from repro.faults import FaultSchedule as RefSchedule
from repro.faults import link_down as ref_link_down
from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import torch_backend
from repro_torch.dragonfly.simulator import run_phase_batch
from repro_torch.faults import FaultSchedule, link_down

from test_torch_simulator import JAX_RTOL, _assert_close

TOPO_KW = dict(n_groups=4, chassis_per_group=2, blades_per_chassis=4)
TOPO = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
ARMS = ("ADAPTIVE_0", "ADAPTIVE_3", "MIN_HASH")


def _flows(topo, seed=42, n=400):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, topo.n_nodes, size=n)
    dst = (src + rng.integers(1, topo.n_nodes, size=n)) % topo.n_nodes
    size = rng.pareto(1.2, size=n) * 65536 + 1024
    return src, dst, size


def _column(planned, bg, faulted, params=None):
    """A sweep column: one simulator per arm, same seed and flows."""
    src, dst, size = _flows(TOPO, seed=20)
    calls = []
    for k, arm in enumerate(ARMS):
        p = params[k] if params else port.SimParams(seed=20, bg_enable=bg)
        sim = port.DragonflySimulator(
            TOPO, p, device="cpu",
            faults=FaultSchedule.of(link_down(n_random=6, seed=4))
            if faulted else None)
        kw = dict(src_nodes=src, dst_nodes=dst, bytes_=size,
                  policy=port.RoutingPolicy(RoutingMode[arm]))
        if planned:
            kw["plan"] = sim.plan_for(src, dst, size)
        calls.append((sim, kw))
    return calls


def _assert_equal(rb, rs):
    assert np.array_equal(rb.t_us, rs.t_us)
    assert np.array_equal(rb.latency_us, rs.latency_us)
    assert np.array_equal(rb.flits, rs.flits)
    assert np.array_equal(rb.stalls_per_flit, rs.stalls_per_flit)
    assert rb.nonmin_fraction == rs.nonmin_fraction
    if rs.stranded is None:
        assert rb.stranded is None
    else:
        assert np.array_equal(rb.stranded, rs.stranded)


def _calls_delta(fn):
    before = dict(torch_backend.PIPELINE_CALLS)
    out = fn()
    return out, {k: torch_backend.PIPELINE_CALLS[k] - before[k]
                 for k in before}


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("planned", [False, True])
def test_run_phase_batch_matches_sequential(planned, bg, faulted):
    """Three rounds (queues carried, the plans' background buffers
    reused), one batched dispatch each, equal to sequential run_phase."""
    batched, sequential = _column(planned, bg, faulted), \
        _column(planned, bg, faulted)
    for _ in range(3):
        got, calls = _calls_delta(lambda: run_phase_batch(batched))
        assert calls == {"single": 0, "batched": 1}
        want = [sim.run_phase(**kw) for sim, kw in sequential]
        for rb, rs in zip(got, want):
            _assert_equal(rb, rs)
            if faulted:
                assert rb.stranded is not None
    for (a, _), (b, _) in zip(batched, sequential):
        assert np.array_equal(a.link_queue_s, b.link_queue_s)
        assert a.rng.bit_generator.state == b.rng.bit_generator.state


def test_per_phase_constants_are_their_own():
    """Cells whose SimParams differ in every constant the pipeline reads
    (and in the window floor) share a dispatch; each phase still uses
    its own values, none taken from the batch's first entry."""
    params = [port.SimParams(seed=20, feedback_rho0=0.9, rho_threshold=0.85,
                             queue_delay_ns=900.0, qwait_fraction=0.6,
                             stall_gain=1.2),
              port.SimParams(seed=20, feedback_rho0=0.5, rho_threshold=0.6,
                             queue_delay_ns=2000.0, qwait_fraction=0.9,
                             stall_gain=3.0, min_phase_window_s=400e-6),
              port.SimParams(seed=20, feedback_rho0=1.2, rho_threshold=1.1,
                             queue_delay_ns=100.0, qwait_fraction=0.1,
                             stall_gain=0.2, min_phase_window_s=5e-6)]
    batched, sequential = _column(True, True, False, params), \
        _column(True, True, False, params)
    for _ in range(2):
        got, calls = _calls_delta(lambda: run_phase_batch(batched))
        assert calls["batched"] == 1
        for rb, (sim, kw) in zip(got, sequential):
            _assert_equal(rb, sim.run_phase(**kw))
    # the three cells really differ
    assert len({float(r.t_us.max()) for r in got}) == 3


def test_distinct_seeds_and_flows_match_sequential():
    """Three independent simulators (seeds 20-22, their own flows); the
    planless phases group wherever their signatures agree."""
    def calls():
        out = []
        for k in range(3):
            sim = port.DragonflySimulator(TOPO, port.SimParams(seed=20 + k),
                                          device="cpu")
            src, dst, size = _flows(TOPO, seed=20 + k)
            out.append((sim, dict(src_nodes=src, dst_nodes=dst,
                                  bytes_=size, policy=port.RoutingPolicy(
                                      RoutingMode.ADAPTIVE_0))))
        return out
    batched = calls()
    got, delta = _calls_delta(lambda: run_phase_batch(batched))
    for rb, (sim, kw) in zip(got, calls()):
        _assert_equal(rb, sim.run_phase(**kw))
    assert delta == {"single": 0, "batched": 1}


def test_one_dispatch_per_group_and_singletons_alone():
    """Two planned cells, two planless cells and a cell of another flow
    count: two batched dispatches and one single."""
    planned = _column(True, True, False)[:2]
    planless = _column(False, True, False)[:2]
    src, dst, size = _flows(TOPO, seed=5, n=100)
    odd = port.DragonflySimulator(TOPO, port.SimParams(seed=3),
                                  device="cpu")
    calls = [planned[0], planless[0], (odd, dict(
        src_nodes=src, dst_nodes=dst, bytes_=size,
        policy=port.RoutingPolicy(RoutingMode.ADAPTIVE_0))), planned[1],
        planless[1]]
    sigs = [torch_backend.batch_signature(sim, sim._phase_begin(**kw))
            for sim, kw in _column(True, True, False)[:2]
            + _column(False, True, False)[:2]]
    assert sigs[0] == sigs[1] and sigs[2] == sigs[3] and sigs[0] != sigs[2]
    _, delta = _calls_delta(lambda: run_phase_batch(calls))
    assert delta == {"single": 1, "batched": 2}


def test_mismatched_shapes_run_per_simulator():
    calls = []
    for k, n in enumerate((100, 200, 300)):
        sim = port.DragonflySimulator(TOPO, port.SimParams(seed=k),
                                      device="cpu")
        src, dst, size = _flows(TOPO, seed=k, n=n)
        calls.append((sim, dict(src_nodes=src, dst_nodes=dst, bytes_=size,
                                policy=port.RoutingPolicy(
                                    RoutingMode.ADAPTIVE_0))))
    got, delta = _calls_delta(lambda: run_phase_batch(calls))
    assert delta == {"single": 3, "batched": 0}
    assert [r.t_us.shape[0] for r in got] == [100, 200, 300]


def test_a_simulator_given_twice_raises():
    (sim, kw), _, _ = _column(False, True, False)
    with pytest.raises(ValueError, match="twice"):
        run_phase_batch([(sim, kw), (sim, dict(kw))])
    assert sim.phase_index == 0               # nothing ran


def test_batch_layout_offsets_and_padding():
    """prepare_batch: the sorted heads first, in batch order, so the
    pair list stays sorted over B * n_links segments; the tails after
    them, their padding at B * n_links; flat indices offset per phase."""
    calls = _column(True, True, False)
    batch = [(sim, sim._phase_begin(**kw)) for sim, kw in calls]
    x = torch_backend.prepare_batch(batch)
    B, n_links = len(batch), TOPO.n_links
    n_all, ncand = batch[0][1]["safe"].shape[:2]
    p_app = batch[0][1]["plan"].pair_links.shape[0]
    assert x["p_sorted"] == B * p_app
    assert x["seg_off"].shape[0] == B * n_links + 1
    assert int(x["seg_off"][-1]) == x["p_sorted"]
    heads = x["pair_links"][:x["p_sorted"]]
    assert bool((heads[1:] >= heads[:-1]).all())
    assert int(heads.min()) >= 0 and int(heads.max()) < B * n_links
    tails = x["pair_links"][x["p_sorted"]:].numpy()
    fc = x["pair_fc"].numpy()
    off = 0
    for b, (sim, ctx) in enumerate(batch):
        n_bg = ctx["pair_links"].shape[0] - p_app
        t = tails[off:off + _bucket(n_bg)]
        assert np.array_equal(t[:n_bg], ctx["pair_links"][p_app:]
                              + b * n_links)
        assert (t[n_bg:] == B * n_links).all()
        head_fc = fc[b * p_app:(b + 1) * p_app]
        assert head_fc.min() >= b * n_all * ncand
        assert head_fc.max() < (b + 1) * n_all * ncand
        off += _bucket(n_bg)
    assert off == tails.shape[0]
    assert x["safe"].shape == (B, n_all, ncand, batch[0][1]["safe"].shape[2])
    assert int(x["safe"][1].min()) >= n_links
    assert x["window_s"].shape == (B,)


def _bucket(n):
    return torch_backend._padded_len(n, torch_backend._PAIR_BUCKET)


@pytest.mark.parametrize("planned", [False, True])
def test_dispatch_launches_b1_as_often_as_one_phase(planned, monkeypatch):
    """A batched dispatch calls each segment-sum wrapper as often as one
    phase of its group does: 5 sorted and 6 scatter sums for a planned
    phase with background traffic, 6 scatter for a planless one."""
    counts = {"sorted": 0, "scatter": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(torch_backend, "segment_sum_sorted",
                        counted("sorted", torch_backend.segment_sum_sorted))
    monkeypatch.setattr(torch_backend, "segment_sum_scatter",
                        counted("scatter",
                                torch_backend.segment_sum_scatter))
    monkeypatch.setattr(torch_backend, "segment_sum",   # the NIC loads
                        counted("scatter", torch_backend.segment_sum))
    calls = _column(planned, True, False)
    run_phase_batch(calls[:1])
    one = dict(counts)
    run_phase_batch([(port.DragonflySimulator(
        TOPO, sim.params, device="cpu"), kw) for sim, kw in calls])
    assert {k: counts[k] - one[k] for k in counts} == one
    assert one == ({"sorted": 5, "scatter": 6} if planned
                   else {"sorted": 0, "scatter": 6})


@pytest.mark.parametrize("faulted", [False, True])
def test_batch_matches_the_reference_numpy_batch(faulted):
    """The port's batch against the reference's run_phase_batch on its
    NumPy backend: same seeds, same flows, generators in lockstep, times
    at JAX_RTOL, flits equal."""
    rtopo = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))

    def ref_calls():
        out = []
        for k in range(3):
            sim = ref.DragonflySimulator(
                rtopo, ref.SimParams(seed=20 + k, backend="numpy"),
                faults=RefSchedule.of(ref_link_down(n_random=6, seed=4))
                if faulted else None)
            src, dst, size = _flows(rtopo, seed=20 + k)
            out.append((sim, dict(src_nodes=src, dst_nodes=dst,
                                  bytes_=size, policy=ref.RoutingPolicy(
                                      RefMode.ADAPTIVE_0))))
        return out

    def port_calls():
        out = []
        for k in range(3):
            sim = port.DragonflySimulator(
                TOPO, port.SimParams(seed=20 + k), device="cpu",
                faults=FaultSchedule.of(link_down(n_random=6, seed=4))
                if faulted else None)
            src, dst, size = _flows(TOPO, seed=20 + k)
            out.append((sim, dict(src_nodes=src, dst_nodes=dst,
                                  bytes_=size, policy=port.RoutingPolicy(
                                      RoutingMode.ADAPTIVE_0))))
        return out

    rc, pc = ref_calls(), port_calls()
    for _ in range(2):
        want, got = ref_run_phase_batch(rc), run_phase_batch(pc)
        for rp, rn in zip(got, want):
            _assert_close(rp, rn)
    for (a, _), (b, _) in zip(pc, rc):
        assert a.rng.bit_generator.state == b.rng.bit_generator.state
        np.testing.assert_allclose(a.link_queue_s, b.link_queue_s,
                                   rtol=JAX_RTOL,
                                   atol=JAX_RTOL * b.link_queue_s.max())


def test_summation_order_witness(monkeypatch):
    """What the card's atomic order can move: the scatter form's sums
    taken in a random order (the CPU's plain version, permuted) against
    the fixed order, on tests/test_torch_cuda.py's batched column
    (planless, background traffic on).  On the first round, from one
    state, t_us moves by under 1e-5; the carried queues then amplify
    it (printed)."""
    import torch
    scatter = torch_backend.segment_sum_scatter
    gen = torch.Generator().manual_seed(0)

    def shuffled(vals, ids, out):
        p = torch.randperm(vals.shape[0], generator=gen)
        return scatter(vals[p].contiguous(), ids[p].contiguous(), out)

    topo = port.small_topology("aries")
    rng = np.random.default_rng(9)
    src = rng.integers(0, topo.n_nodes, size=400)
    dst = (src + rng.integers(1, topo.n_nodes, size=400)) % topo.n_nodes
    size = rng.pareto(1.2, size=400) * 65536 + 1024

    def column():
        return [(port.DragonflySimulator(topo, port.SimParams(seed=11),
                                         device="cpu"),
                 dict(src_nodes=src, dst_nodes=dst, bytes_=size,
                      policy=port.RoutingPolicy(RoutingMode[m])))
                for m in ("ADAPTIVE_0", "ADAPTIVE_3", "MIN_HASH")]

    fixed, moved, gaps = column(), column(), []
    for _ in range(3):
        monkeypatch.setattr(torch_backend, "segment_sum_scatter", scatter)
        a = run_phase_batch(fixed)
        monkeypatch.setattr(torch_backend, "segment_sum_scatter", shuffled)
        b = run_phase_batch(moved)
        gaps.append(max(float(np.max(np.abs(x.t_us / y.t_us - 1)))
                        for x, y in zip(a, b)))
    print("t_us largest relative gap per round:", gaps)
    assert 0 < gaps[0] < 1e-5
    assert max(gaps) < JAX_RTOL
