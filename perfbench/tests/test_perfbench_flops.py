"""``perfbench/flops.py`` against counts made by hand at SMOKE sizes."""

from __future__ import annotations

import pytest

from perfbench import flops
from perfbench.tests.smoke_cells import smoke_cell

GRANITE = "granite-moe-3b-a800m.train-8x512"
ZAMBA = "zamba2-7b.train-8x512"
SERVE = "granite-moe-3b-a800m.serve-chunk2048"


def test_granite_train_step():
    # 2 layers, d 64, 4 heads of 16 over 2 kv heads, 8 experts top-2 of
    # width 64, vocab 512; a token's products: attention 64*16*(2*4+2*2)
    # = 12,288, two experts 2*3*64*64 = 24,576, the router 64*8 = 512
    m = smoke_cell(GRANITE).model
    assert flops.token_params(m) == 2 * (12288 + 24576 + 512)
    per_seq = (2 * 74752 * 32            # products over 32 positions
               + 4 * 4 * 16 * 528 * 2    # QK^T, PV over 32*33/2 pairs
               + 2 * 64 * 512 * 32)      # the head at every position
    tr = smoke_cell(GRANITE).traffic
    assert flops.train_step_flops(m, tr) == 3 * 2 * per_seq


def test_zamba_train_step():
    # 5 Mamba2 layers (d_inner 128, 8 heads of 16, state 16) with the
    # shared block once (period 2: 2 super-blocks and 1 trailing layer)
    m = smoke_cell(ZAMBA).model
    ssm = 64 * (2 * 128 + 2 * 16 + 8) + 128 * 64
    shared = 64 * 16 * (2 * 4 + 2 * 4) + 3 * 64 * 128
    assert flops.token_params(m) == 5 * ssm + shared
    # chunks of 8: C.B^T and M.X over 36 pairs, the states and readout
    ssd = 4 * (2 * 36 * (16 + 8 * 16) + 4 * 8 * 16 * 16 * 8) * 5
    per_seq = (2 * (5 * ssm + shared) * 32 + 4 * 4 * 16 * 528 * 1 + ssd
               + 2 * 64 * 512 * 32)
    assert flops.train_step_flops(m, smoke_cell(ZAMBA).traffic) == \
        3 * 2 * per_seq


def test_granite_serve_batch():
    cell = smoke_cell(SERVE)
    m, tr = cell.model, cell.traffic
    tp = 74752
    prefill = 2 * (2 * tp * 24 + 4 * 4 * 16 * 300 * 2 + 2 * 64 * 512)
    decode = 2 * (2 * tp + 4 * 4 * 16 * 25 * 2 + 2 * 64 * 512)
    assert flops.serve_batch_flops(m, tr) == prefill + decode


def test_kernel_bounds():
    cell = smoke_cell(GRANITE, dtype=__import__("torch").bfloat16)
    m, tr = cell.model, cell.traffic
    # B4: 64 rows of 64 bf16, 5 norms a forward (2 a layer and the final)
    fwd, bwd = 2 * 64 * 64 * 2 + 64 * 2, 3 * 64 * 64 * 2 + 2 * 64 * 2
    assert flops.kernel_bound_s(m, tr, "b4") == pytest.approx(
        5 * (fwd + bwd) / flops.PEAK_BYTES)
    # B2 at q [2,4,32,16], k, v [2,2,32,16]: bytes bound
    q, kv, lse = 2 * 4 * 32 * 16 * 2, 2 * 2 * 32 * 16 * 2, 2 * 4 * 32 * 4
    want = 2 * ((2 * q + 2 * kv + lse) + (4 * q + 4 * kv + lse)) \
        / flops.PEAK_BYTES
    assert flops.kernel_bound_s(m, tr, "b2") == pytest.approx(want)
    assert flops.kernel_bound_s(m, tr, "b3") == 0.0


def test_serve_norms_and_no_backward():
    cell = smoke_cell(SERVE, dtype=__import__("torch").bfloat16)
    m, tr = cell.model, cell.traffic
    # the prefill: 4 norms over 48 rows and the final one over 2 rows;
    # one kept decode step: 5 norms over 2 rows
    fwd = 4 * (2 * 48 * 64 * 2 + 128) + (2 * 2 * 64 * 2 + 128) \
        + 5 * (2 * 2 * 64 * 2 + 128)
    assert flops.kernel_bound_s(m, tr, "b4") == pytest.approx(
        fwd / flops.PEAK_BYTES)
