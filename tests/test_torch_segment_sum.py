"""The port's segment sum against the reference Pallas kernel.

On the CPU the wrappers run their plain PyTorch versions; the same
numpy-seeded inputs go through ``segment_sum_pallas`` (interpret mode)
and ``segment_sum_ref``.  Float32 sums of a few hundred values in
different orders agree to ~1e-6, so the tolerance is the reference
kernel test's own (rtol = atol = 1e-5).  The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py
and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.segment_sum import segment_sum_ref
from repro.kernels.segment_sum.segment_sum import segment_sum_pallas
from repro_torch.kernels.segment_sum import (segment_sum,
                                             segment_sum_scatter,
                                             segment_sum_sorted)

TOL = 1e-5

#: the shapes of the reference kernel test (tests/test_kernels.py)
SHAPES = [
    (1000, 300, 256, 128),       # multi-block both axes
    (257, 64, 256, 64),          # ragged pair tail
    (64, 1000, 64, 256),         # more segments than pairs
    (5, 3, 1024, 512),           # tiny, single block
]


def _inputs(n, segs, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, segs, size=n).astype(np.int32),
            rng.random(n).astype(np.float32))


def _sorted(ids, vals, segs):
    order = np.argsort(ids, kind="stable")
    off = np.zeros(segs + 1, dtype=np.int32)
    np.cumsum(np.bincount(ids, minlength=segs), out=off[1:])
    return (torch.from_numpy(vals[order]), torch.from_numpy(off))


@pytest.mark.parametrize("n,segs,bp,bs", SHAPES)
def test_plain_matches_pallas_and_ref(n, segs, bp, bs):
    ids, vals = _inputs(n, segs)
    pallas = segment_sum_pallas(jnp.asarray(vals), jnp.asarray(ids), segs,
                                block_pairs=bp, block_segs=bs,
                                interpret=True)
    ref = segment_sum_ref(jnp.asarray(vals), jnp.asarray(ids), segs)
    out = segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), segs)
    assert out.shape == (segs,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,segs,bp,bs", SHAPES)
def test_sorted_form_matches_scatter_form(n, segs, bp, bs):
    ids, vals = _inputs(n, segs, seed=1)
    v_sorted, off = _sorted(ids, vals, segs)
    a = segment_sum_sorted(v_sorted, off, torch.zeros(segs))
    b = segment_sum_scatter(torch.from_numpy(vals), torch.from_numpy(ids),
                            torch.zeros(segs))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_empty_untouched_and_out_of_range_segments():
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0])
    ids = torch.tensor([2, 2, 5, -1, 8, 100], dtype=torch.int32)
    want = [0, 0, 3.0, 0, 0, 4.0, 0, 0]
    out = segment_sum(vals, ids, 8)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-7)
    pallas = segment_sum_pallas(jnp.asarray(vals[:3].numpy()),
                                jnp.asarray(ids[:3].numpy()), 8,
                                interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-7)
    # sorted form: segments 0, 1, 3, 4, 6, 7 are empty
    off = torch.tensor([0, 0, 0, 2, 2, 2, 3, 3, 3], dtype=torch.int32)
    out_s = segment_sum_sorted(vals[:3].contiguous(), off, torch.zeros(8))
    np.testing.assert_allclose(out_s.numpy(), want, atol=1e-7)
    # no pairs at all
    assert segment_sum(torch.zeros(0), torch.zeros(0, dtype=torch.int32),
                       4).tolist() == [0.0] * 4


def test_forms_accumulate_into_one_buffer():
    """The sorted head and the scattered tail of one link-load sum
    write the same buffer."""
    ids, vals = _inputs(600, 50, seed=2)
    head, tail = slice(0, 400), slice(400, None)
    v_sorted, off = _sorted(ids[head], vals[head], 50)
    out = torch.full((50,), 1.0)
    segment_sum_sorted(v_sorted, off, out)
    segment_sum_scatter(torch.from_numpy(vals[tail]),
                        torch.from_numpy(ids[tail]), out)
    want = 1.0 + np.bincount(ids, weights=vals, minlength=50)
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)


def test_wrappers_reject_what_the_kernel_does_not_take():
    vals, ids = torch.ones(4), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        segment_sum_scatter(vals.double(), ids, torch.zeros(2))
    with pytest.raises(ValueError):
        segment_sum_scatter(vals, ids.long(), torch.zeros(2))
    with pytest.raises(ValueError):
        segment_sum_scatter(vals, ids[:3], torch.zeros(2))
    with pytest.raises(ValueError):
        segment_sum_sorted(vals, torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2))
    with pytest.raises(ValueError):
        segment_sum_scatter(vals.to("meta"), ids.to("meta"),
                            torch.zeros(2, device="meta"))
