"""A run of each cell, its chip check skipped, at SMOKE size on the CPU:
sound, it comes out correct; with its timed path broken underneath by
each fault the cell can have, ``correct`` comes out false."""

from __future__ import annotations

import pytest
import torch

from perfbench import spec
from perfbench.tests.smoke_cells import smoke_cell

CELLS = spec.read_json(spec.BENCHMARK)["workloads"]
TRAIN = [w["name"] for w in CELLS if w["traffic"].startswith("train")]
SERVE = "granite-moe-3b-a800m.serve-chunk2048"
CPU = torch.device("cpu")


def run(cell, **kw) -> dict:
    return spec.kind(cell.traffic).run(cell, 2 ** 31 + 101, 0.5, False,
                                       CPU, 0.0, **kw)


def unchanged_state(model, opt, batch, *, cfg, tcfg):
    """A step that computes its loss and returns its state unchanged."""
    from repro_torch.train.train_step import value_and_grad

    loss, metrics, _ = value_and_grad(model, batch, cfg, tcfg)
    return model, opt, dict(metrics, loss=loss)


def half_batch(model, opt, batch, *, cfg, tcfg):
    """A step over the first half of the batch's rows."""
    from repro_torch.train.train_step import train_step

    rows = batch["tokens"].shape[0] // 2
    return train_step(model, opt, {k: v[:rows] for k, v in batch.items()},
                      cfg=cfg, tcfg=tcfg)


@pytest.mark.parametrize("workload", TRAIN)
def test_train_sound_run_is_correct(workload):
    out = run(smoke_cell(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["e2e"]["train_tokens_per_s"] > 0


@pytest.mark.parametrize("fault", [unchanged_state, half_batch],
                         ids=["unchanged_state", "half_batch"])
@pytest.mark.parametrize("workload", TRAIN)
def test_train_fault_is_not_correct(workload, fault):
    out = run(smoke_cell(workload), step_fn=fault)
    assert not out["correct"], out["checks"]


def test_serve_sound_run_is_correct():
    out = run(smoke_cell(SERVE))
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["e2e"]["serve_tokens_per_s"] > 0


@pytest.mark.parametrize("rows", [None, 1], ids=["every_slot", "one_slot"])
def test_serve_altered_token_is_not_correct(rows):
    """The decode step's token altered where it is produced, in every
    slot of the batch or in its first slot only."""
    vocab = smoke_cell(SERVE).model["vocab"]

    def alter(engine):
        step = engine._step

        def altered(*args):
            tok, state = step(*args)
            tok = tok.clone()
            tok[:rows] = (tok[:rows] + 1) % vocab
            return tok, state

        engine._step = altered

    out = run(smoke_cell(SERVE), engine_hook=alter)
    assert not out["correct"], out["checks"]
