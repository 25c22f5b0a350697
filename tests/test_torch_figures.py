"""The port's paper-figure benchmarks (``repro_torch.benchmarks``) against the
reference's ``benchmarks/`` at the golden tests' arguments
(tests/test_benchmarks_golden.py).

Each pair of runs is traced phase by phase (``repro_torch.benchmarks.
parity``): the port's run is anchored to the reference's carried state
before each phase, its generator must stay in lockstep, its phase times
agree at the jax engine's ``JAX_RTOL`` and its decisions match under the
tie rule.  Where no decision flips, the figure's whole result is held at
``JAX_RTOL``.  These are simulated times, not speed.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import fig7_routing_pingpong as ref_fig7  # noqa: E402
from benchmarks import fig8_microbench as ref_fig8        # noqa: E402
from benchmarks import fig10_applications as ref_fig10    # noqa: E402
from benchmarks import fig3_allocation as ref_fig3        # noqa: E402
from benchmarks import fig4_fig5_hostnoise as ref_fig45   # noqa: E402
from benchmarks import model_validation as ref_mv         # noqa: E402
from benchmarks import table1_correlation as ref_table1   # noqa: E402
from repro.dragonfly import DragonflySimulator as RefSim  # noqa: E402
from repro.dragonfly import TopologyParams as RefTopologyParams  # noqa: E402
from repro.dragonfly import make_topology as ref_make_topology  # noqa: E402
from repro.policy import PolicyEngine as RefEngine        # noqa: E402
from repro_torch.benchmarks import common                 # noqa: E402
from repro_torch.benchmarks import fig7_routing_pingpong as fig7  # noqa: E402
from repro_torch.benchmarks import fig8_microbench as fig8  # noqa: E402
from repro_torch.benchmarks import fig10_applications as fig10  # noqa: E402
from repro_torch.benchmarks import fig3_allocation as fig3  # noqa: E402
from repro_torch.benchmarks import fig4_fig5_hostnoise as fig45  # noqa: E402
from repro_torch.benchmarks import model_validation as mv  # noqa: E402
from repro_torch.benchmarks import table1_correlation as table1  # noqa: E402
from repro_torch.benchmarks.parity import (compare_traces,  # noqa: E402
                                           trace_protocol)
from repro_torch.dragonfly import DragonflySimulator as PortSim  # noqa: E402
from repro_torch.dragonfly import make_topology  # noqa: E402
from repro_torch.policy import PolicyEngine as PortEngine  # noqa: E402

from test_torch_simulator import JAX_RTOL  # noqa: E402

#: the golden tests' small machine
SMALL = "aries:n_groups=4,chassis_per_group=2,blades_per_chassis=4"
#: the same machine as the parameters the reference drivers that
#: hard-code DAINT are given (monkeypatched, as
#: tests/test_benchmarks_golden.py patches fig8's SWEEP)
SMALL_PARAMS = RefTopologyParams(n_groups=4, chassis_per_group=2,
                                 blades_per_chassis=4)
#: model validation's sizes at test scale
MV_SIZES = (128, 16384, 4 << 20)
FIG8_SWEEP = {"alltoall": [dict(size_per_pair=1024)],
              "halo3d": [dict(nx=256)]}


def _canon(obj):
    """Mode-keyed results as plain nested values (modes by name)."""
    if isinstance(obj, dict):
        return {getattr(k, "name", k): _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    return obj


def _assert_tree_close(got, want, path="result"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=1e-9,
                                   err_msg=path)


@contextlib.contextmanager
def _paired():
    """Trace a reference run, then a port run anchored to it."""
    traces = {}

    @contextlib.contextmanager
    def ref_run():
        with trace_protocol(RefSim, RefEngine, record_state=True) as t:
            yield
        traces["ref"] = t

    @contextlib.contextmanager
    def port_run():
        with trace_protocol(PortSim, PortEngine,
                            anchor=traces["ref"]) as t:
            yield
        traces["port"] = t

    yield ref_run, port_run, traces


def _held(traces, got, want, what: str) -> int:
    n = len(traces["ref"].phases)
    compared = compare_traces(traces["ref"], traces["port"], JAX_RTOL)
    print(f"{what}: {compared} of {n} phases compared")
    assert compared >= n / 2
    if compared == n:
        _assert_tree_close(_canon(got), _canon(want))
    return compared


def test_fig7_matches_the_reference():
    with _paired() as (ref_run, port_run, traces):
        with ref_run():
            want = ref_fig7.run(iters=2, seeds=1, topology=SMALL)
        with port_run():
            got = fig7.run(iters=2, seeds=1, topology=SMALL, device="cpu")
    # static arms only: nothing can flip, every phase is held
    assert _held(traces, got, want, "fig7") == len(traces["ref"].phases)


def test_fig8_matches_the_reference(monkeypatch):
    monkeypatch.setattr(ref_fig8, "SWEEP", FIG8_SWEEP)
    with _paired() as (ref_run, port_run, traces):
        with ref_run():
            want = ref_fig8.run(machine="cori", iters=2, seed=0,
                                full_scale=False, policy="app_aware",
                                topology=SMALL)
        with port_run():
            got = fig8.run(machine="cori", iters=2, seed=0,
                           full_scale=False, policy="app_aware",
                           topology=SMALL, sweep=FIG8_SWEEP, device="cpu")
    if _held(traces, got, want, "fig8") == len(traces["ref"].phases):
        for key, row in want.items():
            assert got[key]["policy_pct_default_traffic"] == \
                row["policy_pct_default_traffic"]


def test_fig10_matches_the_reference():
    with _paired() as (ref_run, port_run, traces):
        with ref_run():
            want = ref_fig10.run_app(ref_make_topology(SMALL), "bfs",
                                     "alltoall", dict(size_per_pair=2048),
                                     64, 0.5, iters=2, seed=0,
                                     policy="app_aware")
        with port_run():
            got = fig10.run_app(make_topology(SMALL), "bfs", "alltoall",
                                dict(size_per_pair=2048), 64, 0.5, iters=2,
                                seed=0, policy="app_aware", device="cpu")
    _held(traces, got, want, "fig10")


def _rows(text: str) -> dict:
    out = {}
    for line in text.strip().splitlines():
        name, us, derived = line.split(",", 2)
        out[name] = (float(us), derived)
    return out


def test_fig7_main_prints_the_reference_rows():
    """The printed rows (the CLI contract) of the reduced run."""
    with _paired() as (ref_run, port_run, traces):
        buf_ref, buf_port = io.StringIO(), io.StringIO()
        with ref_run(), contextlib.redirect_stdout(buf_ref):
            ref_fig7.main(topology=SMALL)
        with port_run(), contextlib.redirect_stdout(buf_port):
            fig7.main(topology=SMALL, device="cpu")
    compare_traces(traces["ref"], traces["port"], JAX_RTOL)
    want, got = _rows(buf_ref.getvalue()), _rows(buf_port.getvalue())
    assert list(got) == list(want)
    for name, (us, _) in want.items():
        np.testing.assert_allclose(got[name][0], us, rtol=JAX_RTOL,
                                   atol=1e-3, err_msg=name)


def test_common_helpers_match_the_reference():
    from benchmarks import common as ref_common
    assert vars(common.DAINT) == vars(ref_common.DAINT)
    assert vars(common.CORI) == vars(ref_common.CORI)
    assert {getattr(k, "name", k): v for k, v in common.MODE_LABEL.items()} \
        == {getattr(k, "name", k): v
            for k, v in ref_common.MODE_LABEL.items()}
    xs = np.random.default_rng(0).lognormal(size=50)
    assert common.boxstats(xs) == ref_common.boxstats(xs)
    topo = common.bench_topology(SMALL, common.DAINT)
    assert common.group_spread(topo, 6) == \
        ref_common.group_spread(ref_make_topology(SMALL), 6)


@pytest.mark.parametrize("figure", ["fig7", "fig8", "fig10", "fig3",
                                    "fig5", "table1", "model_validation"])
def test_figures_default_to_the_card(figure):
    """No device means CUDA; without one the figure runs raise."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if figure == "fig7":
            fig7.run(iters=1, seeds=1, topology=SMALL)
        elif figure == "fig8":
            fig8.run(machine="cori", iters=1, topology=SMALL,
                     sweep=FIG8_SWEEP)
        elif figure == "fig10":
            fig10.run_app(make_topology(SMALL), "bfs", "alltoall",
                          dict(size_per_pair=2048), 8, 0.5, iters=1)
        elif figure == "fig3":
            fig3.run(iters=1, seeds=1, topology=SMALL)
        elif figure == "fig5":
            fig45.fig5_qcd_exec_vs_latency(iters=1, seeds=1,
                                           topology=SMALL)
        elif figure == "table1":
            table1.run(idle_seconds=(1e-4,), topology=SMALL)
        else:
            mv.run(n_allocations=1, iters=1, topology=SMALL)


# ------------------------------------------ fig3, fig4/5, table 1, §2.4
@pytest.fixture
def small_daint(monkeypatch):
    """The reference drivers that hard-code DAINT, on the small machine;
    model validation at three sizes in both packages."""
    for mod in (ref_fig3, ref_fig45, ref_table1, ref_mv):
        monkeypatch.setattr(mod, "DAINT", SMALL_PARAMS)
    monkeypatch.setattr(ref_mv, "SIZES", MV_SIZES)
    monkeypatch.setattr(mv, "SIZES", MV_SIZES)


def test_fig3_matches_the_reference(small_daint):
    with _paired() as (ref_run, port_run, traces):
        with ref_run():
            want = ref_fig3.run(iters=4, seeds=2)
        with port_run():
            got = fig3.run(iters=4, seeds=2, topology=SMALL, device="cpu")
    # a static arm: nothing can flip, every phase is held
    assert _held(traces, got, want, "fig3") == len(traces["ref"].phases)


def test_fig4_equals_the_reference():
    """Fig. 4 runs no simulator: its own generator, equal draws."""
    assert fig45.fig4_same_node_alltoall(iters=50) == \
        ref_fig45.fig4_same_node_alltoall(iters=50)


def test_fig5_matches_the_reference(small_daint):
    sizes = (128, 16384, 4 << 20)
    with _paired() as (ref_run, port_run, traces):
        with ref_run():
            want = ref_fig45.fig5_qcd_exec_vs_latency(sizes=sizes, iters=4,
                                                      seeds=2)
        with port_run():
            got = fig45.fig5_qcd_exec_vs_latency(sizes=sizes, iters=4,
                                                 seeds=2, topology=SMALL,
                                                 device="cpu")
    assert _held(traces, got, want, "fig5") == len(traces["ref"].phases)


def test_table1_matches_the_reference(small_daint):
    idle = (0.002, 0.004)                  # 40 and 80 idle phases
    with _paired() as (ref_run, port_run, traces):
        with ref_run():
            want = ref_table1.run(idle_seconds=idle)
        with port_run():
            got = table1.run(idle_seconds=idle, topology=SMALL,
                             device="cpu")
    assert _held(traces, got, want, "table1") == len(traces["ref"].phases)
    assert [r["flits"] for r in got] == [r["flits"] for r in want]


def test_model_validation_matches_the_reference(small_daint):
    with _paired() as (ref_run, port_run, traces):
        buf_ref, buf_port = io.StringIO(), io.StringIO()
        with ref_run(), contextlib.redirect_stdout(buf_ref):
            want = ref_mv.run(n_allocations=4, iters=2)
        with port_run(), contextlib.redirect_stdout(buf_port):
            got = mv.run(n_allocations=4, iters=2, topology=SMALL,
                         device="cpu")
    assert _held(traces, got, want, "model_validation") == \
        len(traces["ref"].phases)
    assert list(_rows(buf_port.getvalue())) == \
        list(_rows(buf_ref.getvalue()))


@pytest.mark.parametrize("figure", ["fig3", "fig4_fig5", "model_validation"])
def test_new_figure_main_prints_the_reference_rows(figure, small_daint):
    """The printed rows of each reduced ``main()`` (the CLI contract)."""
    ref_mod, mod = {"fig3": (ref_fig3, fig3),
                    "fig4_fig5": (ref_fig45, fig45),
                    "model_validation": (ref_mv, mv)}[figure]
    with _paired() as (ref_run, port_run, traces):
        buf_ref, buf_port = io.StringIO(), io.StringIO()
        with ref_run(), contextlib.redirect_stdout(buf_ref):
            ref_mod.main()
        with port_run(), contextlib.redirect_stdout(buf_port):
            mod.main(topology=SMALL, device="cpu")
    assert compare_traces(traces["ref"], traces["port"], JAX_RTOL) == \
        len(traces["ref"].phases)
    want, got = _rows(buf_ref.getvalue()), _rows(buf_port.getvalue())
    assert list(got) == list(want)
    for name, (us, _) in want.items():
        np.testing.assert_allclose(got[name][0], us, rtol=JAX_RTOL,
                                   atol=1e-3, err_msg=name)
