"""Per-flow routing modes (``run_phase(modes=...)``) on the port's
simulator against the reference.

The PolicyEngine path hands the simulator one mode per flow; the
simulator turns them into per-flow bias rows (``routing.row_bias_terms``)
that the torch pipeline charges to the non-minimal candidates.  Here
every mode of ``MODE_ORDER`` (the adaptive biases and the deterministic
minimal and non-minimal modes) is mixed across the flows of one phase,
planned, planless and with a plan cut to ``max_flows`` (where the modes
are cut by ``plan.subsample_idx``).  Times at the jax engine's
``JAX_RTOL``, flits, packets and generator states exactly.
"""

import numpy as np
import pytest

import repro.dragonfly as ref
from repro.core.strategies import RoutingMode as RefMode
from repro.dragonfly.routing import MODE_ORDER as REF_MODE_ORDER
from repro.dragonfly.routing import row_bias_terms as ref_row_bias_terms
from repro.dragonfly.topology import make_allocation
import repro_torch.dragonfly as port
from repro_torch.core.strategies import RoutingMode as PortMode
from repro_torch.dragonfly import torch_backend
from repro_torch.dragonfly.routing import MODE_ORDER, row_bias_terms

from test_torch_simulator import (JAX_RTOL, TOPO_KW, _assert_close, _flows,
                                  _same_rng, ref_alloc_as_port)

N_FLOWS = 400


def _mixed_modes(n: int, seed: int):
    """The same per-flow modes as reference and port object arrays: every
    mode of MODE_ORDER, in seeded order."""
    names = [m.name for m in MODE_ORDER]
    pick = np.random.default_rng(seed).permutation(
        np.arange(n) % len(names))
    ref_modes = np.empty(n, dtype=object)
    port_modes = np.empty(n, dtype=object)
    ref_modes[:] = [RefMode[names[i]] for i in pick]
    port_modes[:] = [PortMode[names[i]] for i in pick]
    return ref_modes, port_modes


def _sims(seed: int, **kw):
    rtopo = ref.DragonflyTopology(ref.TopologyParams(**TOPO_KW))
    ptopo = port.DragonflyTopology(port.TopologyParams(**TOPO_KW))
    rsim = ref.DragonflySimulator(rtopo, ref.SimParams(seed=seed, **kw))
    psim = port.DragonflySimulator(ptopo, port.SimParams(seed=seed, **kw),
                                   device="cpu")
    ralloc = make_allocation(rtopo, 32, spread="groups:3", seed=seed)
    return rsim, psim, ralloc, ref_alloc_as_port(ralloc)


def test_mode_order_matches_the_reference():
    assert [m.name for m in MODE_ORDER] == [m.name for m in REF_MODE_ORDER]
    # both deterministic sentinels (+inf and -inf bias) are among them
    modes = np.empty(len(MODE_ORDER), dtype=object)
    modes[:] = list(MODE_ORDER)
    _, posinf, neginf = row_bias_terms(
        len(modes), port.RoutingPolicy(PortMode.ADAPTIVE_0), modes)
    assert posinf.any() and neginf.any()


@pytest.mark.parametrize("path", ["planned", "planless", "subsampled"])
def test_mixed_per_flow_modes_match_the_reference(path):
    # "subsampled": max_flows below the phase's flows, so the plan keeps
    # a seeded subset and the modes are cut by its subsample_idx
    kw = {"max_flows": 150} if path == "subsampled" else {}
    rsim, psim, ralloc, palloc = _sims(13, **kw)
    src, dst, size = _flows(rsim.topo, seed=17, n=N_FLOWS)
    ref_modes, port_modes = _mixed_modes(N_FLOWS, seed=4)
    rpol = ref.RoutingPolicy(RefMode.ADAPTIVE_0)
    ppol = port.RoutingPolicy(PortMode.ADAPTIVE_0)
    plans = (None, None)
    if path != "planless":
        plans = (rsim.plan_for(src, dst, size), psim.plan_for(src, dst, size))
        if path == "subsampled":
            assert plans[0].subsample_idx is not None
            assert np.array_equal(plans[1].subsample_idx,
                                  plans[0].subsample_idx)
    for _ in range(3):          # queues carry the mixed phase's backlog
        rn = rsim.run_phase(src, dst, size, rpol, ralloc, modes=ref_modes,
                            plan=plans[0])
        rp = psim.run_phase(src, dst, size, ppol, palloc, modes=port_modes,
                            plan=plans[1])
        _assert_close(rp, rn)
        _same_rng(psim, rsim)
        assert rp.t_us.shape == ((150,) if path == "subsampled"
                                 else (N_FLOWS,))
    np.testing.assert_allclose(psim.link_queue_s, rsim.link_queue_s,
                               rtol=JAX_RTOL, atol=1e-9)


@pytest.mark.parametrize("path", ["planned", "planless", "subsampled"])
def test_per_flow_bias_rows_reach_the_pipeline_as_float32(path):
    """The bias rows the pipeline receives are the reference's
    row_bias_terms (cut like the flows where the phase is subsampled),
    as the float32 tensors the static path builds."""
    kw = {"max_flows": 150} if path == "subsampled" else {}
    _, psim, _, palloc = _sims(13, **kw)
    src, dst, size = _flows(psim.topo, seed=17, n=N_FLOWS)
    ref_modes, port_modes = _mixed_modes(N_FLOWS, seed=4)
    ppol = port.RoutingPolicy(PortMode.ADAPTIVE_0)
    plan = psim.plan_for(src, dst, size) if path != "planless" else None
    ctx = psim._phase_begin(src, dst, size, ppol, palloc,
                            modes=port_modes, plan=plan)
    n_app = ctx["n_app"]
    cut = plan.subsample_idx if plan is not None and \
        plan.subsample_idx is not None else np.arange(N_FLOWS)
    want = ref_row_bias_terms(len(cut),
                              ref.RoutingPolicy(RefMode.ADAPTIVE_0),
                              ref_modes[cut])
    for got, w in zip(row_bias_terms(n_app, ppol, port_modes[cut]), want):
        assert np.array_equal(got, w)
    for key, w in zip(("bias_rows", "posinf", "neginf"), want):
        assert np.array_equal(ctx[key][:n_app], w)
    x = torch_backend._prepare_inputs(psim, ctx)
    assert x["bias_rows"].dtype == torch_backend.torch.float32
    assert np.array_equal(x["bias_rows"].numpy()[:n_app],
                          want[0].astype(np.float32))


@pytest.mark.parametrize("mode", [m.name for m in MODE_ORDER])
def test_uniform_per_flow_modes_equal_the_static_policy(mode):
    """One mode on every flow is the static policy of that mode, bit for
    bit, on the port (the per-flow rows are the static rows)."""
    out = []
    for per_flow in (False, True):
        _, psim, _, palloc = _sims(5)
        src, dst, size = _flows(psim.topo, seed=9, n=N_FLOWS)
        modes = None
        if per_flow:
            modes = np.empty(N_FLOWS, dtype=object)
            modes[:] = PortMode[mode]
        pol = port.RoutingPolicy(PortMode[mode] if not per_flow
                                 else PortMode.ADAPTIVE_0)
        plan = psim.plan_for(src, dst, size)
        out.append(psim.run_phase(src, dst, size, pol, palloc, modes=modes,
                                  plan=plan))
    a, b = out
    assert np.array_equal(a.t_us, b.t_us)
    assert np.array_equal(a.stalls_per_flit, b.stalls_per_flit)
    assert a.nonmin_fraction == b.nonmin_fraction
