"""The port's phase pipeline against the reference jax pipeline.

One reference ``_phase_begin`` ctx (the third phase of a simulator, so
queues are non-zero and notification flags visible) goes through
``repro.dragonfly.jax_backend._phase_pipeline`` — with its plain
segment sum and with the Pallas kernel in interpret mode — and through
``repro_torch.dragonfly.torch_backend.phase_pipeline`` on the CPU, as a
batch of one phase.

Tolerance, set from seeds 0-4 over every case here: the largest
elementwise relative difference on entries above 1e-3 of an output's
largest value was 1.1e-3 (spray weights ``w``), the largest difference
relative to an output's largest value 1.1e-4.  Both pipelines are
float32 but sum in different orders (the reference's plan path sums by
cumsum-diff), so each output is held at ``rtol=5e-3`` with
``atol = 1e-3 * max|reference|``.
"""

import dataclasses

import numpy as np
import pytest

import repro.dragonfly as ref
from repro.core.strategies import RoutingMode
from repro.dragonfly import jax_backend
from repro.dragonfly.routing import RoutingPolicy
from repro.faults import FaultSchedule, link_down
import repro_torch.dragonfly as port
from repro_torch.core.strategies import RoutingMode as PortRoutingMode
from repro_torch.dragonfly import torch_backend

RTOL = 5e-3
ATOL_FRAC = 1e-3
OUTPUTS = ("w", "rho", "load_q", "lat_us", "s_flit")


def _flows(topo, seed, n=300):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, topo.n_nodes, size=n)
    dst = (src + rng.integers(1, topo.n_nodes, size=n)) % topo.n_nodes
    size = rng.pareto(1.2, size=n) * 65536 + 1024
    return src, dst, size


def _port_plan(plan):
    """The port's PhasePlan holding the same host arrays."""
    return port.PhasePlan(**{f.name: getattr(plan, f.name)
                             for f in dataclasses.fields(port.PhasePlan)
                             if f.name != "device_tensors"})


def _reference_ctx(scenario, use_plan, seed):
    topo = ref.small_topology("aries")
    kw = {"seed": seed}
    if scenario == "notifying":
        kw["notify_threshold_s"] = 1e-5
    sim = ref.DragonflySimulator(topo, ref.SimParams(backend="jax", **kw))
    if scenario == "cand_mask":
        sim.set_faults(FaultSchedule.of(link_down(n_random=6, seed=4)))
    src, dst, size = _flows(topo, seed)
    pol = RoutingPolicy(RoutingMode.ADAPTIVE_0)
    plan = sim.plan_for(src, dst, size) if use_plan else None
    for _ in range(2):
        sim.run_phase(src, dst, size, pol, plan=plan)
    return sim, kw, sim._phase_begin(src, dst, size, pol, plan=plan)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("use_plan", [False, True])
@pytest.mark.parametrize("scenario", ["healthy", "cand_mask", "notifying"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_pipeline_matches_jax(use_kernel, scenario, use_plan, seed):
    sim, kw, ctx = _reference_ctx(scenario, use_plan, seed)
    if scenario == "cand_mask":
        assert ctx["cand_mask"] is not None and not ctx["cand_mask"].all()
    if scenario == "notifying":
        assert ctx["notify_vis"].any()

    inputs, (n_spray, n_links, _, _, p_sorted) = \
        jax_backend._prepare_inputs(sim, ctx)
    want = jax_backend._phase_pipeline(
        *inputs, n_spray=n_spray, n_links=n_links, use_kernel=use_kernel,
        interpret=True, p_sorted=p_sorted)

    psim = port.DragonflySimulator(port.small_topology("aries"),
                                   port.SimParams(**kw), device="cpu")
    psim.link_queue_s = sim.link_queue_s.copy()
    pctx = dict(ctx, plan=None if ctx["plan"] is None
                else _port_plan(ctx["plan"]))
    got = torch_backend.phase_pipeline(
        **torch_backend.prepare_batch([(psim, pctx)]))

    for name, g, w in zip(OUTPUTS, got, want):
        assert g.shape[0] == 1, name        # a batch of one phase
        g = g[0]
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(
            g.numpy(), w, rtol=RTOL, atol=ATOL_FRAC * np.abs(w).max(),
            err_msg=name)


def test_planned_pipeline_splits_sorted_head_and_scattered_tail():
    """A planned phase with background flows sums its app pairs through
    the sorted form and its padded background tail through the scatter
    form; the full-size buffers are rewritten in place whenever the
    padded tail keeps its length."""
    topo = port.small_topology("aries")
    sim = port.DragonflySimulator(topo, port.SimParams(seed=1),
                                  device="cpu")
    src, dst, size = _flows(topo, seed=1)
    plan = sim.plan_for(src, dst, size)
    pol = port.RoutingPolicy(PortRoutingMode.ADAPTIVE_0)
    ptrs = []
    for _ in range(3):
        ctx = sim._phase_begin(src, dst, size, pol, plan=plan)
        x = torch_backend._prepare_inputs(sim, ctx)
        p_app = plan.pair_links.shape[0]
        assert x["p_sorted"] == p_app
        assert x["seg_off"][-1].item() == p_app
        tail = x["pair_links"][p_app:]
        assert tail.shape[0] % torch_backend._PAIR_BUCKET == 0
        n_real = ctx["pair_links"].shape[0] - p_app
        assert (tail[n_real:] == topo.n_links).all()     # padding drops
        ptrs.append((tail.shape[0], x["pair_links"].data_ptr()))
        sim._phase_finish(ctx, torch_backend.fixed_point_torch(sim, ctx))
    for (n0, p0), (n1, p1) in zip(ptrs, ptrs[1:]):
        assert (p0 == p1) == (n0 == n1)
    assert any(n0 == n1 for (n0, _), (n1, _) in zip(ptrs, ptrs[1:]))
