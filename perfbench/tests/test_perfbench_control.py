"""The control of each cell, at a size a CPU test run can hold: the
plain reference computed one precision below the configuration's
bfloat16 (fp8 products, ``perfbench/control.py``) comes out not correct
under the cell's limits."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import control, judge, spec
from perfbench.tests.smoke_cells import smoke_cell

CELLS = [w["name"] for w in spec.read_json(spec.BENCHMARK)["workloads"]]
CPU = torch.device("cpu")


def _cell_at_test_size(workload: str) -> spec.Cell:
    """The cell at d_model 256, 4 layers, a 4,096-row vocabulary and
    128-token rows."""
    cell = smoke_cell(workload, dtype=torch.bfloat16, seq_len=128,
                      batch=4, checked_batches=4)
    m = cell.model
    model = dict(m, d_model=256, n_layers=4, vocab=4096, d_ff=512,
                 d_ff_expert=128 if m["n_experts"] else 0)
    return dataclasses.replace(cell, config=dict(cell.config, model=model))


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = _cell_at_test_size(workload)
    run = control.train_control if cell.traffic["kind"] == "train" \
        else control.serve_control
    out = run(cell, 2 ** 31 + 3, CPU)
    assert not judge.passed(judge.checks(out["fp8"], cell.limits)), out
