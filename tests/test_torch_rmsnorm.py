"""The port's RMSNorm (kernel B4) against the reference Pallas kernel.

On the CPU the wrapper runs its plain PyTorch version; the same
numpy-seeded inputs go through ``rmsnorm_fused`` (interpret mode) and
``rmsnorm_ref``.  Both compute ``x * rsqrt(mean(x**2) + eps) * gamma``
in float32 and cast once, so in float32 they agree to rounding
(``F32_TOL = 1e-5``) and in bfloat16 to one bf16 ulp: a float32
difference of a few 1e-7 can move a value across a bf16 rounding
boundary, one ulp being at most 2**-7 of the value (``BF16_RTOL``).
The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_fused as rmsnorm_pallas
from repro.models.common import rmsnorm as model_rmsnorm_ref
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd, rmsnorm_bwd_plain,
                                         rmsnorm_fused, rmsnorm_plain)
from repro_torch.kernels.rmsnorm.ops import BWD_BLOCKS_PER_SM, bwd_blocks
from repro_torch.models.common import rmsnorm as model_rmsnorm

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7

#: the shapes of the reference kernel test (tests/test_kernels.py)
SHAPES = [(8, 64), (3, 5, 128), (2, 7, 96)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    gamma = (1.0 + 0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, gamma


def _close(got: torch.Tensor, want, tdtype):
    want = np.asarray(want, np.float32)
    if tdtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_RTOL, atol=0.0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_plain_matches_pallas_and_ref(shape, jdtype, tdtype):
    x, gamma = _inputs(shape)
    jx = jnp.asarray(x, jdtype)
    pallas = rmsnorm_pallas(jx, jnp.asarray(gamma), interpret=True)
    ref = rmsnorm_ref(jx, jnp.asarray(gamma))
    tx = torch.from_numpy(x).to(tdtype)
    before = rmsnorm_fused.launches
    out = rmsnorm_fused(tx, torch.from_numpy(gamma))
    assert rmsnorm_fused.launches == before      # no kernel on the CPU
    assert out.shape == tx.shape and out.dtype == tdtype
    _close(out, pallas, tdtype)
    _close(out, ref, tdtype)


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_bf16_gamma_and_eps(jdtype, tdtype):
    x, gamma = _inputs((4, 40), seed=3)
    jg = jnp.asarray(gamma, jnp.bfloat16)
    ref = rmsnorm_ref(jnp.asarray(x, jdtype), jg, eps=1e-3)
    out = rmsnorm_fused(torch.from_numpy(x).to(tdtype),
                        torch.from_numpy(gamma).to(torch.bfloat16), eps=1e-3)
    _close(out, ref, tdtype)


def test_model_norm_is_the_kernel_function():
    """The port's model norm is the fused function.  The reference
    model's norm rounds to bf16 before multiplying by a bf16 gamma: one
    rounding more, so the two differ by at most one bf16 ulp, and agree
    exactly in float32 and where gamma is 1."""
    x, gamma = _inputs((6, 64), seed=5)
    jg = jnp.asarray(gamma, jnp.bfloat16)
    tg = torch.from_numpy(gamma).to(torch.bfloat16)
    ref = model_rmsnorm_ref(jnp.asarray(x, jnp.bfloat16), jg, 1e-5)
    out = model_rmsnorm(torch.from_numpy(x).to(torch.bfloat16), tg, 1e-5)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=BF16_RTOL, atol=0.0)
    ones = torch.ones(64, dtype=torch.bfloat16)
    ref1 = model_rmsnorm_ref(jnp.asarray(x, jnp.bfloat16),
                             jnp.ones(64, jnp.bfloat16), 1e-5)
    out1 = model_rmsnorm(torch.from_numpy(x).to(torch.bfloat16), ones, 1e-5)
    assert np.array_equal(out1.float().numpy(), np.asarray(ref1, np.float32))
    ref32 = model_rmsnorm_ref(jnp.asarray(x), jnp.asarray(gamma), 1e-5)
    out32 = model_rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma), 1e-5)
    np.testing.assert_allclose(out32.numpy(), np.asarray(ref32),
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_version_is_the_wrappers_cpu_path():
    x, gamma = _inputs((3, 33), seed=1)
    tx, tg = torch.from_numpy(x), torch.from_numpy(gamma)
    assert torch.equal(rmsnorm_fused(tx, tg), rmsnorm_plain(tx, tg))


@pytest.mark.parametrize("case", ["gamma_shape", "dtype", "strided",
                                  "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x = torch.randn(4, 16)
    gamma = torch.ones(16)
    if case == "gamma_shape":
        args = (x, torch.ones(15))
    elif case == "dtype":
        args = (x.double(), gamma)
    elif case == "strided":
        args = (torch.randn(16, 4).T, gamma)
    else:
        args = (x.to("meta"), gamma.to("meta"))
    with pytest.raises(ValueError):
        rmsnorm_fused(*args)


#: zamba2-7b's gated norm over d_inner: past the register routes, on the
#: card the wide routes' width
WIDE = (3, 7168)


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_plain_matches_pallas_and_ref_past_the_register_route(jdtype, tdtype):
    x, gamma = _inputs(WIDE, seed=9)
    jx = jnp.asarray(x, jdtype)
    pallas = rmsnorm_pallas(jx, jnp.asarray(gamma), interpret=True)
    out = rmsnorm_fused(torch.from_numpy(x).to(tdtype),
                        torch.from_numpy(gamma))
    _close(out, pallas, tdtype)
    _close(out, rmsnorm_ref(jx, jnp.asarray(gamma)), tdtype)


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_plain_backward_matches_the_refs_vjp_past_the_register_route(
        jdtype, tdtype):
    """The plain backward (the wrapper's CPU path) against ``jax.vjp`` of
    ``rmsnorm_ref`` at width 7168.  Both work in float32 from the same
    values, so in bfloat16 (inputs rounded to bf16, the reference's
    float32 gradients cast once) they agree to one bf16 ulp."""
    x, gamma = _inputs(WIDE, seed=10)
    dy = np.random.default_rng(11).standard_normal(WIDE).astype(np.float32)
    tx, tg, tdy = (torch.from_numpy(a).to(tdtype) for a in (x, gamma, dy))
    before = rmsnorm_bwd.launches
    got = rmsnorm_bwd(tx, tg, tdy)
    assert rmsnorm_bwd.launches == before        # no kernel on the CPU
    _, vjp = jax.vjp(rmsnorm_ref, *(jnp.asarray(t.float().numpy())
                                    for t in (tx, tg)))
    want = vjp(jnp.asarray(tdy.float().numpy()))
    for g, w in zip(got, want):
        assert g.dtype == tdtype and g.shape == w.shape
        _close(g, np.asarray(jnp.asarray(w, jdtype), np.float32), tdtype)


def test_backward_grid_and_scratch_arithmetic():
    """The backward's grid on each route, which sizes the ``[blocks, D]``
    float32 scratch: on the wide route two blocks an SM at most, as few
    as leave each the same number of rows but the last (256 of 16 rows
    at zamba2-7b's train step on 132 SMs: 7.3 MB of scratch at width
    7168, 4.2 % of the 176.2 MB the backward must move); the register
    route's 8 warps a block each the same number of rows; the generic
    route's four blocks an SM, at most one a row."""
    sms = 132
    for d in (3584, 7168):
        blocks = bwd_blocks("wide", 4096, sms)
        assert blocks == 256 and 4096 / blocks == 16
        scratch = blocks * d * 4
        moved = 3 * 4096 * d * 2 + 2 * d * 2
        assert scratch == {3584: 3_670_016, 7168: 7_340_032}[d]
        assert scratch / moved < 0.042
    assert bwd_blocks("register", 4096, sms) == 256
    assert bwd_blocks("generic", 4096, sms) == 528
    for kind in ("register", "wide", "generic"):
        cap = BWD_BLOCKS_PER_SM[kind] * sms
        for rows in (1, 5, 131, 132, 263, 264, 265, 1000, 4096, 12032,
                     100_000):
            blocks = bwd_blocks(kind, rows, sms)
            assert 1 <= blocks <= min(rows, cap), (kind, rows, blocks)
            per = -(-rows // blocks)      # the kernels' rows a block
            if kind != "generic":         # no block left without a row
                assert (blocks - 1) * per < rows, (kind, rows, blocks)
