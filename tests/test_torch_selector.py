"""The port's collective-schedule selector, its cost model and serving's
KV-transfer policy against the reference.

``ICICostModel.predict`` and the selector's decisions are held equal to
the bit, given equal ``HwSpec`` values: once with the values of the
reference's ``repro.analysis.roofline.V5E`` (read from the reference
object here; the port carries no TPU figure) and once with the port's
``H100``.  The ``route_kv_transfer`` cases are tests/test_faults.py's
and tests/test_tenancy.py's, on the port's engine and cost model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.roofline import V5E
from repro.analysis.roofline import HwSpec as RefHwSpec
from repro.collectives.modes import CollectiveMode as RefMode
from repro.collectives.modes import mode_for_routing as ref_mode_for_routing
from repro.collectives.selector import AppAwareSelector as RefSelector
from repro.collectives.selector import ICICostModel as RefCostModel
from repro.collectives.selector import MeshSpec as RefMeshSpec
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.core.strategies import RoutingMode as RefRoutingMode
from repro.models import registry as ref_registry
from repro.policy import make_engine as ref_make_engine
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefServeEngine
from repro.serve.engine import route_kv_transfer as ref_route_kv_transfer
from repro_torch.analysis import H100, HwSpec, classify_collective
from repro_torch.collectives import (AppAwareSelector, CollectiveMode,
                                     ICICostModel, mode_for_routing)
from repro_torch.collectives.selector import MeshSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.strategies import RoutingMode
from repro_torch.models.convert import dense_lm_from_reference
from repro_torch.policy import DecisionBatch, make_engine, scoped_site_filter
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import kv_bytes, route_kv_transfer

SPECS = ["v5e_values", "h100"]
MESHES = [(2, 256), (2, 8), (1, 8)]
SIZES = [2 ** e for e in range(10, 31)]
#: granite-moe-3b-a800m's KV transfer: 8 x 512 prompt tokens, 32 layers
#: x 8 KV heads x 64 x K and V x bf16
GRANITE_KV_BYTES = 268_435_456


def _specs(which):
    """(reference HwSpec, port HwSpec) with equal values."""
    src = V5E if which == "v5e_values" else H100
    vals = dict(name=src.name, peak_flops=src.peak_flops, hbm_bw=src.hbm_bw,
                ici_bw=src.ici_bw, dcn_bw=src.dcn_bw)
    return RefHwSpec(**vals), HwSpec(**vals)


def _models(which, mesh):
    ref_hw, hw = _specs(which)
    return (RefCostModel(RefMeshSpec(*mesh), hw=ref_hw),
            ICICostModel(MeshSpec(*mesh), hw=hw))


def test_mode_table_equals_reference():
    """tests/test_selector_hlo.py:125, over every routing mode."""
    assert mode_for_routing(RoutingMode.ADAPTIVE_3) == CollectiveMode.DIRECT
    assert mode_for_routing(RoutingMode.ADAPTIVE_0) == \
        CollectiveMode.HIERARCHICAL
    for mode in RoutingMode:
        assert mode_for_routing(mode).value == \
            ref_mode_for_routing(RefRoutingMode[mode.name]).value


def test_h100_spec_is_the_datasheet_and_the_default():
    assert (H100.peak_flops, H100.hbm_bw, H100.ici_bw, H100.dcn_bw) == \
        (989e12, 3.35e12, 450e9, 50e9)
    assert ICICostModel(MeshSpec(2, 8)).hw is H100
    assert classify_collective([0, 1], (2, 2, 2)) == "intra"
    assert classify_collective([0, 4], (2, 2, 2)) == "cross_pod"
    assert classify_collective([0, 4], (2, 4)) == "intra"


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("which", SPECS)
def test_predict_equals_reference_to_the_bit(which, mesh):
    ref, got = _models(which, mesh)
    for size in SIZES:
        for mode in CollectiveMode:
            a = got.predict(size, mode)
            b = ref.predict(size, RefMode(mode.value))
            assert (a.latency_cycles, a.stall_cycles_per_flit) == \
                (b.latency_cycles, b.stall_cycles_per_flit), (size, mode)


def _sequence(sel, modes_of, sizes):
    out = []
    for size in sizes:
        out.append(modes_of(sel.select(size)))
        sel.observe_predicted(size)
    batch = sel.decide_batch(np.array(sizes[:5], float), site="b")
    sel.update_predicted(np.array(sizes[:5], float))
    out += [modes_of(m) for m in batch]
    out.append(sel.traffic_fraction_direct())
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("which", SPECS)
def test_selector_decisions_equal_reference(which, mesh):
    """The scalar API over small and large messages, then a batch, the
    model-fed feedback after each, and the traffic fraction."""
    ref, got = _models(which, mesh)
    sizes = [2048, 64 << 20, 64 << 20, 4096, 64 << 20, 64 << 20, 256 << 20,
             1 << 10, 16 << 20, 64 << 20]
    want = _sequence(RefSelector(ref), lambda m: m.value, sizes)
    assert _sequence(AppAwareSelector(got), lambda m: m.value, sizes) == want


def test_h100_stall_term_is_zero_and_selector_settles_on_direct():
    """The H100 finding: both link classes drain faster than the 12.8 GB/s
    flit clock, so s = 0 for both modes at 256 MiB (at V5E's values DIRECT
    stalls), and the selector settles on DIRECT where V5E's values keep
    HIERARCHICAL."""
    cm = ICICostModel(MeshSpec(2, 256))
    for mode in CollectiveMode:
        assert cm.predict(256 << 20, mode).stall_cycles_per_flit == 0.0
    v5e = _models("v5e_values", (2, 256))[1]
    assert v5e.predict(256 << 20, CollectiveMode.DIRECT) \
        .stall_cycles_per_flit > 0.0

    def last(model):
        sel = AppAwareSelector(model)
        for _ in range(4):
            mode = sel.select(64 << 20)
            sel.observe_predicted(64 << 20)
        return mode

    assert last(cm) == CollectiveMode.DIRECT
    assert last(v5e) == CollectiveMode.HIERARCHICAL


@pytest.mark.parametrize("which,want", [
    ("h100", ["hierarchical", "direct", "direct", "direct"]),
    ("v5e_values", ["hierarchical", "direct", "hierarchical",
                    "hierarchical"])])
def test_granite_kv_transfer_decisions(which, want):
    """granite-moe-3b-a800m's 268,435,456-byte KV transfer over four
    calls, in both packages."""
    ref_cost, cost = _models(which, (2, 256))
    eng = make_engine("app_aware", mode_a=CollectiveMode.HIERARCHICAL,
                      mode_b=CollectiveMode.DIRECT,
                      mode_a_alltoall=CollectiveMode.HIERARCHICAL)
    ref_eng = ref_make_engine("app_aware", mode_a=RefMode.HIERARCHICAL,
                              mode_b=RefMode.DIRECT,
                              mode_a_alltoall=RefMode.HIERARCHICAL)
    got = [route_kv_transfer(eng, cost, GRANITE_KV_BYTES).value
           for _ in range(4)]
    ref = [ref_route_kv_transfer(ref_eng, ref_cost, GRANITE_KV_BYTES).value
           for _ in range(4)]
    assert got == ref == want


# ---------------------------------------------------------------------------
# route_kv_transfer: tests/test_faults.py:302-375, tests/test_tenancy.py:223
# ---------------------------------------------------------------------------
def _serve_engine():
    eng = make_engine("app_aware", mode_a=CollectiveMode.HIERARCHICAL,
                      mode_b=CollectiveMode.DIRECT,
                      mode_a_alltoall=CollectiveMode.HIERARCHICAL)
    return eng, ICICostModel(MeshSpec(n_pods=2, inner_chips=256))


def test_route_kv_transfer_retries_then_falls_back_to_direct():
    eng, cost = _serve_engine()
    attempts, sleeps = [], []

    def transfer(mode):
        attempts.append(mode)
        return mode is CollectiveMode.DIRECT   # only DIRECT works

    # big volume => the first decision is HIERARCHICAL, which fails
    used = route_kv_transfer(eng, cost, 1 << 30, site=("A", "kv_transfer"),
                             transfer=transfer, max_retries=2,
                             backoff_s=0.1, sleep=sleeps.append)
    assert used is CollectiveMode.DIRECT
    assert attempts == [CollectiveMode.HIERARCHICAL] * 3 \
        + [CollectiveMode.DIRECT]
    assert sleeps == [0.1, 0.2]                # exponential backoff


def test_route_kv_transfer_success_needs_no_retry():
    eng, cost = _serve_engine()
    attempts, sleeps = [], []
    used = route_kv_transfer(eng, cost, 1 << 30,
                             transfer=lambda m: attempts.append(m) or True,
                             max_retries=2, backoff_s=0.1,
                             sleep=sleeps.append)
    assert len(attempts) == 1 and attempts[0] is used
    assert sleeps == []
    assert route_kv_transfer(eng, cost, 1 << 10) is not None


def test_route_kv_transfer_raises_when_fallback_fails():
    eng, cost = _serve_engine()
    with pytest.raises(RuntimeError, match="fallback"):
        route_kv_transfer(eng, cost, 1 << 30, transfer=lambda m: False,
                          max_retries=1, sleep=lambda s: None)


def test_kv_transfer_failures_stay_allocation_scoped():
    eng, cost = _serve_engine()
    for _ in range(3):
        route_kv_transfer(eng, cost, 1 << 30, site=("B", "kv_transfer"))
    before = eng.decide(DecisionBatch.single(
        1 << 30, site=("B", "kv_transfer")))[0]
    for _ in range(3):
        route_kv_transfer(eng, cost, 1 << 30, site=("A", "kv_transfer"),
                          transfer=lambda m: m is CollectiveMode.DIRECT,
                          max_retries=1, sleep=lambda s: None)
    after = eng.decide(DecisionBatch.single(
        1 << 30, site=("B", "kv_transfer")))[0]
    assert after == before             # B's automaton is untouched
    assert eng.policy.traffic_fraction(
        CollectiveMode.DIRECT, site_filter=scoped_site_filter("A")) > 0.0


def test_serve_scoped_kv_site_and_shared_engine():
    class _FakePerf:
        latency_cycles = 1000.0
        stall_cycles_per_flit = 0.1

    class _FakeCost:
        def predict(self, nbytes, mode):
            return _FakePerf()

    eng = make_engine("app_aware", mode_a="DIRECT", mode_b="HIER",
                      granularity="message")
    for alloc_id in ("job0", "job1"):
        mode = route_kv_transfer(eng, _FakeCost(), 1 << 20,
                                 site=(alloc_id, "kv_transfer"))
        assert mode == "DIRECT"
    keys = eng.policy.site_keys()
    assert ("job0", "kv_transfer") in keys
    assert ("job1", "kv_transfer") in keys


# ---------------------------------------------------------------------------
# ServeEngine(comm_policy=...) against the reference engine
# ---------------------------------------------------------------------------
PROMPTS = [[5, 17, 3, 99, 250, 7, 8], [11, 12], [300, 301, 302, 303, 1]]


@pytest.fixture(scope="module")
def granite_smoke():
    jc = ref_smoke_config("granite-moe-3b-a800m").scaled(dtype=jnp.float32)
    tc = get_smoke_config("granite-moe-3b-a800m").scaled(dtype=torch.float32)
    params = ref_registry.init_params(jc, 0)
    model = dense_lm_from_reference(jax.tree_util.tree_map(np.asarray,
                                                           params), tc,
                                    device="cpu")
    return jc, tc, params, model


@pytest.mark.parametrize("which", SPECS)
def test_policy_decisions_equal_reference_engine(granite_smoke, which):
    """Three runs of each engine with ``comm_policy="app_aware"`` and the
    same ``HwSpec`` values: the same KV bytes and schedules per run, and
    the same greedy tokens; then a shared engine with scoped sites."""
    jc, tc, params, model = granite_smoke
    ref_hw, hw = _specs(which)
    scfg = dict(batch=4, max_len=32, comm_policy="app_aware", n_pods=2,
                inner_chips=8, allocation_id="job0")
    ref = RefServeEngine(jc, params, RefServeConfig(**scfg))
    ref._cost_model = RefCostModel(RefMeshSpec(2, 8), hw=ref_hw)
    got = ServeEngine(tc, model, ServeConfig(**scfg), device="cpu")
    got._cost_model = ICICostModel(MeshSpec(2, 8), hw=hw)
    assert got.kv_site == ref.kv_site == ("job0", "kv_transfer")
    for _ in range(3):
        want = ref.run([RefRequest(prompt=list(p), max_new_tokens=3)
                        for p in PROMPTS])
        out = got.run([Request(prompt=list(p), max_new_tokens=3)
                       for p in PROMPTS])
        assert [r.out_tokens for r in out] == [r.out_tokens for r in want]
    assert [(n, m.value) for n, m in got.policy_decisions] == \
        [(n, m.value) for n, m in ref.policy_decisions]
    assert kv_bytes(tc, 4 * 7) == ref._kv_bytes(4 * 7) == \
        2 * tc.n_layers * tc.n_kv_heads * tc.hd * 4 * 7 * 2
    shared = make_engine("app_aware", mode_a=CollectiveMode.HIERARCHICAL,
                         mode_b=CollectiveMode.DIRECT)
    a = ServeEngine(tc, model, ServeConfig(batch=4, max_len=32,
                                           allocation_id="a"),
                    comm_engine=shared, device="cpu")
    a.run([Request(prompt=[1, 2], max_new_tokens=1)])
    assert ("a", "kv_transfer") in shared.policy.site_keys()
    assert len(a.policy_decisions) == 1


def test_granite_kv_bytes_at_the_serving_shape():
    """The engine counts granite's KV transfer as the reference does."""
    assert kv_bytes(get_config("granite-moe-3b-a800m"), 8 * 512) == \
        GRANITE_KV_BYTES
