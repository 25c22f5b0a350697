"""The traffic generators repeat by seed, differ across seeds, and give
every seed the same sizes."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import spec

SEEDS = (0, 2 ** 31 + 977, 2 ** 33 + 5)


CELLS = [w["name"] for w in spec.read_json(spec.BENCHMARK)["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_repeats_by_seed(workload):
    cell = spec.load_cell(workload)
    gen, tr, vocab = spec.generator(cell.traffic), cell.traffic, \
        cell.model["vocab"]
    for seed in SEEDS:
        a = gen.draw(tr, vocab, seed, 3)
        b = gen.draw(tr, vocab, seed, 3)
        assert set(a) == ({"tokens", "labels"} if tr["kind"] == "train"
                          else {"tokens"})
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].shape == (tr["batch"], tr["seq_len"])
            assert 0 <= a[k].min() and a[k].max() < vocab
    x, y = (gen.draw(tr, vocab, s, 0)["tokens"] for s in SEEDS[:2])
    assert (x != y).mean() > 0.5
    rows = gen.draw(tr, vocab, SEEDS[1], 1)["tokens"]
    assert len({r.tobytes() for r in rows}) == tr["batch"]


def test_labels_are_the_next_tokens():
    cell = spec.load_cell("zamba2-7b.train-8x512")
    b = spec.generator(cell.traffic).draw(cell.traffic, 32000, 5, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
