"""The port's tenancy matrix drivers (``repro_torch.benchmarks.
{interference,fault,notification}_matrix``) at ``--smoke`` scale on the
CPU against the reference drivers (``benchmarks/``) at the same
arguments.

Every float cell (simulated times and slowdowns, not speed) is held at
the jax engine's ``JAX_RTOL``; integers (stranded flows, recovery
rounds, notification events of the tenancy cells) and the ``checks``
lists are held equal.  The port's drivers write their JSON only where
``--out`` asks.

The notification matrix's workload cells alternate four arms over one
notifying simulator for many phases, so they are compared anchored
(``repro_torch.benchmarks.parity``, as the figure tests are).  Their
``notification_events`` count the flows whose spray weight on a flagged
link is above zero: float32 weights underflow to zero where float64 ones
do not, so the count depends on the precision.  The reference's own
float32 jax engine counts 14, 22,294 and 2,361 on the three smoke cells
where its float64 NumPy backend counts 19, 27,529 and 3,050 (0.19-0.26
fewer; ``test_notification_events_depend_on_the_precision`` is the
witness).  The port's count is held at most the NumPy count and within
``EVENTS_RTOL`` of it.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import fault_matrix as ref_faults             # noqa: E402
from benchmarks import interference_matrix as ref_interf      # noqa: E402
from benchmarks import notification_matrix as ref_notif       # noqa: E402
from repro_torch.benchmarks import fault_matrix as faults     # noqa: E402
from repro_torch.benchmarks import interference_matrix as interf  # noqa: E402
from repro_torch.benchmarks import notification_matrix as notif  # noqa: E402
from repro_torch.dragonfly import torch_backend               # noqa: E402

from repro.dragonfly import DragonflySimulator as RefSim     # noqa: E402
from repro.policy import PolicyEngine as RefEngine            # noqa: E402
from repro_torch.benchmarks.parity import (compare_traces,    # noqa: E402
                                           trace_protocol)
from repro_torch.dragonfly import DragonflySimulator as PortSim  # noqa: E402
from repro_torch.policy import PolicyEngine as PortEngine     # noqa: E402

from test_torch_simulator import JAX_RTOL                     # noqa: E402

#: the sweep module (the tenancy package exports the function under
#: its name), loaded by the interference matrix driver
sweep_module = sys.modules["repro_torch.tenancy.sweep"]

#: the workload cells' notified-flow counts, port (float32) against the
#: reference's NumPy backend (float64): the reference's own float32
#: engine sits 0.19-0.26 below it on these cells
EVENTS_RTOL = 0.3


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _hold(got, want, path="doc"):
    """Floats at JAX_RTOL, everything else equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _hold(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=1e-9,
                                   err_msg=path)
    else:
        assert got == want, path


def _rows(text: str) -> list:
    return [line.split(",", 1)[0] for line in text.strip().splitlines()]


@pytest.fixture(scope="module")
def reference_docs():
    return {name: _quiet(mod.main, smoke=True) for name, mod in (
        ("interference", ref_interf), ("faults", ref_faults))}


@pytest.mark.parametrize("lockstep", [True, False])
def test_interference_matrix_matches_the_reference(lockstep,
                                                   reference_docs,
                                                   monkeypatch):
    """Sequential (the CPU's default) and in lockstep (the card's)."""
    monkeypatch.setattr(sweep_module, "_auto_lockstep",
                        lambda device: lockstep)
    want, want_rows = reference_docs["interference"]
    before = dict(torch_backend.PIPELINE_CALLS)
    got, rows = _quiet(interf.run, 3, 0.375, seed=7, device="cpu")
    batched = torch_backend.PIPELINE_CALLS["batched"] - before["batched"]
    # lockstep: one dispatch per round for each of the 4 mixes' columns,
    # for the mix and for each tenant's run-alone baselines (2, 2, 3, 2)
    assert batched == (3 * (4 + 2 + 2 + 3 + 2) if lockstep else 0)
    _hold(got, want)
    assert got["checks"] == want["checks"]
    assert _rows(rows) == _rows(want_rows)


def test_fault_matrix_matches_the_reference(reference_docs):
    want, want_rows = reference_docs["faults"]
    got, rows = _quiet(faults.main, smoke=True, device="cpu")
    _hold(got, want)
    assert got["checks"] == want["checks"]
    assert _rows(rows) == _rows(want_rows)


def test_notification_matrix_matches_the_reference():
    with trace_protocol(RefSim, RefEngine, record_state=True) as first:
        want, want_rows = _quiet(ref_notif.main, smoke=True)
    with trace_protocol(PortSim, PortEngine, anchor=first) as second:
        got, rows = _quiet(notif.main, smoke=True, device="cpu")
    n = len(first.phases)
    assert compare_traces(first, second, JAX_RTOL) == n
    events = []
    for cell in want["workloads"].values():
        events.append(cell.pop("notification_events"))
    for cell, w in zip(got["workloads"].values(), events):
        g = cell.pop("notification_events")
        assert 0 < g <= w and g >= (1 - EVENTS_RTOL) * w, (g, w)
    _hold(got, want)
    assert got["checks"] == want["checks"]
    assert _rows(rows) == _rows(want_rows)


def test_notification_events_depend_on_the_precision(monkeypatch):
    """The witness behind EVENTS_RTOL: the reference's own float32 jax
    engine counts fewer notified flows than its float64 NumPy backend
    on the smoke workload cells (weights that underflow in float32),
    by less than EVENTS_RTOL."""
    import functools
    counts, params = {}, ref_notif.SimParams
    for backend in ("numpy", "jax"):
        monkeypatch.setattr(ref_notif, "SimParams",
                            functools.partial(params, backend=backend))
        cells, _ = _quiet(ref_notif.run_workload_cells, ref_notif.TOPOLOGY,
                          3, 7)
        counts[backend] = [c["notification_events"] for c in cells.values()]
    print("notified flows, float64 / float32:", counts)
    for f64, f32 in zip(counts["numpy"], counts["jax"]):
        assert 0 < f32 < f64 and f32 >= (1 - EVENTS_RTOL) * f64


def test_matrices_write_json_only_to_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    doc, _ = _quiet(interf.run, 1, 0.1, seed=7, device="cpu")
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "interference.json"
    _quiet(interf.run, 1, 0.1, seed=7, out_path=str(out), device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))


def test_hold_holds_floats_at_jax_rtol_and_the_rest_equal(tmp_path):
    """``repro_torch.benchmarks.hold``: the comparison the card's matrix
    runs are held by against the committed JSON documents."""
    from repro_torch.benchmarks import hold
    want = {"matrix": {"m": {"a": {"t": 100.0, "events": 3, "arm": "x"}}},
            "checks": {"wins": ["m"]}, "workloads": {"w": {"t": 1.0}}}
    got = json.loads(json.dumps(want))
    assert hold.differences(got, want) == ([], 0.0)
    got["matrix"]["m"]["a"]["t"] = 101.0              # inside JAX_RTOL
    assert hold.differences(got, want)[0] == []
    got["matrix"]["m"]["a"]["t"] = 103.0              # outside
    got["matrix"]["m"]["a"]["events"] = 4
    got["checks"]["wins"] = []
    got["workloads"]["w"]["t"] = 9.0
    diffs, worst = hold.differences(got, want)
    assert [d.split(":")[0] for d in diffs] == [
        "matrix.m.a.t", "matrix.m.a.events", "checks.wins", "workloads.w.t"]
    assert worst == pytest.approx(8.0 / 9.0)
    diffs, _ = hold.differences(got, want, skip=["workloads"])
    assert len(diffs) == 3
    a, b = tmp_path / "got.json", tmp_path / "want.json"
    a.write_text(json.dumps(got))
    b.write_text(json.dumps(want))
    with contextlib.redirect_stdout(io.StringIO()):
        assert hold.main([str(a), str(b)]) == 1
        assert hold.main([str(b), str(b)]) == 0
