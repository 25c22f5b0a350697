"""The port's SSD scan (kernel B3) against the reference.

On the CPU ``ssd_inner`` runs its plain PyTorch version.  The same
numpy-seeded inputs go through the reference's Pallas ``ssd_inner``
(interpret mode), its ``ssd_scan_op`` on that kernel
(``force_kernel=True``) and the model's ``ssd_chunked``.  All are
float32 sums of at most a few hundred terms in other orders: the inner
block agrees to ``INNER_TOL = 1e-5``, the full scan (with its
exponentials and cross-chunk recurrence) to ``SCAN_TOL = 1e-4``, inside
the reference kernel test's own 3e-4.  The CUDA kernel is held against
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan_op as ref_scan_op
from repro.kernels.ssd_scan.ssd_scan import ssd_inner as pallas_inner
from repro.models.mamba2 import ssd_chunked as ref_chunked
from repro_torch.kernels.ssd_scan import (ssd_inner, ssd_inner_plain,
                                          ssd_scan_op)
from repro_torch.kernels.ssd_scan.ops import chunk_len

INNER_TOL = 1e-5
SCAN_TOL = 1e-4

#: the shapes of the reference kernel test (tests/test_kernels.py)
SCAN_SHAPES = [(1, 32, 2, 8, 8, 8), (2, 64, 3, 8, 16, 16),
               (1, 128, 4, 16, 32, 32)]


def _scan_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            rng.uniform(0.1, 1.0, (B, S, H)).astype(f),
            rng.uniform(-1, 1, (H,)).astype(f),
            rng.standard_normal((B, S, H, N)).astype(f),
            rng.standard_normal((B, S, H, N)).astype(f))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Nc,H,Q,P,N", [(1, 4, 2, 8, 8, 8),
                                          (2, 2, 3, 16, 8, 16),
                                          (1, 3, 4, 32, 16, 32),
                                          (1, 1, 2, 10, 8, 8)])
def test_inner_plain_matches_pallas(B, Nc, H, Q, P, N):
    rng = np.random.default_rng(1)
    f = np.float32
    xdt = rng.standard_normal((B, Nc, H, Q, P)).astype(f)
    bm = rng.standard_normal((B, Nc, H, Q, N)).astype(f)
    cm = rng.standard_normal((B, Nc, H, Q, N)).astype(f)
    dacum = np.cumsum(-rng.uniform(0.05, 0.5, (B, Nc, H, Q)), -1).astype(f)
    want_y, want_s = pallas_inner(*_j((xdt, bm, cm, dacum)), interpret=True)
    before = ssd_inner.launches
    got_y, got_s = ssd_inner(*_t((xdt, bm, cm, dacum)))
    assert ssd_inner.launches == before          # no kernel on the CPU
    assert got_y.shape == (B, Nc, H, Q, P) and got_s.shape == (B, Nc, H, N, P)
    _close(got_y, want_y, INNER_TOL)
    _close(got_s, want_s, INNER_TOL)
    plain_y, plain_s = ssd_inner_plain(*_t((xdt, bm, cm, dacum)))
    assert torch.equal(plain_y, got_y) and torch.equal(plain_s, got_s)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SCAN_SHAPES + [
    (1, 50, 2, 8, 8, 16),        # 50 tokens: chunk of 10
    (1, 200, 2, 8, 8, 128),      # 200 tokens: chunk of 100
])
def test_scan_matches_model_and_pallas_scan(B, S, H, P, N, chunk):
    arrays = _scan_inputs(B, S, H, P, N)
    y_ref, f_ref = ref_chunked(*_j(arrays), chunk)
    y_k, f_k = ref_scan_op(*_j(arrays), chunk, force_kernel=True)
    y, f = ssd_scan_op(*_t(arrays), chunk)
    assert y.shape == (B, S, H, P) and f.shape == (B, H, N, P)
    for want_y, want_f in ((y_ref, f_ref), (y_k, f_k)):
        _close(y, want_y, SCAN_TOL)
        _close(f, want_f, SCAN_TOL)


def test_state_passing():
    B, S, H, P, N, chunk = 1, 64, 2, 8, 8, 16
    x, dt, a_log, bm, cm = _scan_inputs(B, S, H, P, N, seed=2)
    t = _t((x, dt, a_log, bm, cm))
    y_full, f_full = ssd_scan_op(*t, chunk)
    half = [a[:, :32] for a in (t[0], t[1])] + [t[2]] + \
        [a[:, :32] for a in (t[3], t[4])]
    rest = [a[:, 32:] for a in (t[0], t[1])] + [t[2]] + \
        [a[:, 32:] for a in (t[3], t[4])]
    y1, s1 = ssd_scan_op(*half, chunk)
    y2, f2 = ssd_scan_op(*rest, chunk, init_state=s1)
    _close(torch.cat([y1, y2], 1), y_full, SCAN_TOL)
    _close(f2, f_full, SCAN_TOL)
    # the same split through the reference
    j = _j((x[:, 32:], dt[:, 32:], a_log, bm[:, 32:], cm[:, 32:]))
    y2_ref, f2_ref = ref_chunked(*j, chunk, init_state=jnp.asarray(s1.numpy()))
    _close(y2, y2_ref, SCAN_TOL)
    _close(f2, f2_ref, SCAN_TOL)


def test_bf16_inputs_give_bf16_output():
    arrays = _scan_inputs(1, 32, 2, 8, 8)
    t = _t(arrays)
    t[0] = t[0].to(torch.bfloat16)
    y, f = ssd_scan_op(*t, 8)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    j = _j(arrays)
    j[0] = j[0].astype(jnp.bfloat16)
    y_ref, f_ref = ref_chunked(*j, 8)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32),
                               rtol=2.0 ** -7, atol=1e-3)
    _close(f, f_ref, SCAN_TOL)


@pytest.mark.parametrize("seq,chunk", [(512, 128), (200, 128), (50, 16),
                                       (7, 8), (97, 32)])
def test_chunk_rule_is_the_references(seq, chunk):
    q = min(chunk, seq)
    while seq % q:
        q -= 1
    assert chunk_len(seq, chunk) == q


@pytest.mark.parametrize("case", ["rank", "shape", "dtype", "strided"])
def test_inner_rejects_what_the_kernel_does_not_take(case):
    xdt = torch.zeros(1, 2, 2, 8, 4)
    bm = torch.zeros(1, 2, 2, 8, 6)
    cm = torch.zeros(1, 2, 2, 8, 6)
    da = torch.zeros(1, 2, 2, 8)
    if case == "rank":
        xdt = xdt[0]
    elif case == "shape":
        cm = torch.zeros(1, 2, 2, 8, 5)
    elif case == "dtype":
        bm = bm.double()
    else:
        da = torch.zeros(1, 2, 2, 16)[..., ::2]
    with pytest.raises(ValueError):
        ssd_inner(xdt, bm, cm, da)
