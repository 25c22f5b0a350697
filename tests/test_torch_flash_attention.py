"""The port's flash attention (kernel B2) against the reference Pallas
kernel.

On the CPU the wrapper runs its plain PyTorch version; the same
numpy-seeded inputs go through the JAX ``flash_attention`` (interpret
mode) and ``attention_ref``.  Tolerances are the JAX kernel tests' own
(tests/test_kernels.py): float32 at ``rtol = atol = 3e-5``, bfloat16 at
``5e-2``.  Lengths that are not block multiples, and ``Sq != Skv``, are
held against ``attention_ref`` only, because the JAX kernel refuses
them.  The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as flash_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

F32_TOL = 3e-5
BF16_TOL = 5e-2

#: the reference kernel tests' shapes (tests/test_kernels.py)
SHAPES = [
    (1, 2, 2, 128, 32, 64, 64),      # MHA
    (2, 4, 2, 256, 64, 64, 128),     # GQA
    (1, 8, 1, 128, 32, 32, 64),      # MQA
    (2, 2, 2, 192, 16, 64, 64),      # non-pow2 seq
]


def _inputs(bsz, heads, kv_heads, sq, skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, heads, sq, hd)).astype(np.float32),
            rng.standard_normal((bsz, kv_heads, skv, hd)).astype(np.float32),
            rng.standard_normal((bsz, kv_heads, skv, hd)).astype(np.float32))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=tol, atol=tol)


def _run(arrays, tdtype, causal):
    ts = [torch.from_numpy(a).to(tdtype) for a in arrays]
    before = flash_attention.launches
    out = flash_attention(*ts, causal=causal)
    assert flash_attention.launches == before     # no kernel on the CPU
    assert out.dtype == tdtype and out.shape == ts[0].shape
    return out


@pytest.mark.parametrize("B,H,Hkv,S,hd,bq,bk", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_ref(B, H, Hkv, S, hd, bq, bk, causal):
    arrays = _inputs(B, H, Hkv, S, S, hd)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    pallas = flash_pallas(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                          interpret=True)
    ref = attention_ref(jq, jk, jv, causal=causal)
    out = _run(arrays, torch.float32, causal)
    _close(out, pallas, F32_TOL)
    _close(out, ref, F32_TOL)


@pytest.mark.parametrize("B,H,Hkv,S,hd,bq,bk", SHAPES)
def test_bf16_matches_pallas_and_ref(B, H, Hkv, S, hd, bq, bk):
    arrays = _inputs(B, H, Hkv, S, S, hd, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    pallas = flash_pallas(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                          interpret=True)
    ref = attention_ref(jq, jk, jv, causal=True)
    out = _run(arrays, torch.bfloat16, True)
    _close(out, pallas, BF16_TOL)
    _close(out, ref, BF16_TOL)


@pytest.mark.parametrize("sq,skv", [(7, 7), (200, 200), (5, 37), (37, 5),
                                    (1, 64), (65, 130)])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lengths_match_ref(sq, skv, causal):
    """Lengths the TPU kernel refuses; the mask is top-left (``kpos <=
    qpos`` from 0) as in ``attention_ref``."""
    arrays = _inputs(2, 6, 2, sq, skv, 16, seed=2)
    ref = attention_ref(*(jnp.asarray(a) for a in arrays), causal=causal)
    _close(_run(arrays, torch.float32, causal), ref, F32_TOL)


@pytest.mark.parametrize("hd", [8, 12, 128])
def test_other_head_dims_match_ref(hd):
    arrays = _inputs(1, 4, 2, 33, 33, hd, seed=3)
    ref = attention_ref(*(jnp.asarray(a) for a in arrays), causal=True)
    _close(_run(arrays, torch.float32, True), ref, F32_TOL)


def test_plain_version_is_the_wrappers_cpu_path():
    ts = [torch.from_numpy(a) for a in _inputs(1, 4, 2, 20, 20, 16, seed=4)]
    assert torch.equal(flash_attention(*ts), flash_attention_plain(*ts))


def _t(shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("q,k,v,match", [
    (_t((1, 3, 8, 16)), _t((1, 2, 8, 16)), _t((1, 2, 8, 16)), "multiple"),
    (_t((1, 2, 8, 256)), _t((1, 2, 8, 256)), _t((1, 2, 8, 256)), "head dim"),
    (_t((1, 2, 8, 16), torch.float16), _t((1, 2, 8, 16), torch.float16),
     _t((1, 2, 8, 16), torch.float16), "bfloat16"),
    (_t((1, 2, 8, 16), torch.bfloat16), _t((1, 2, 8, 16)), _t((1, 2, 8, 16)),
     "bfloat16"),
    (_t((1, 2, 16, 8)).transpose(2, 3), _t((1, 2, 8, 16)), _t((1, 2, 8, 16)),
     "contiguous"),
    (_t((1, 2, 8, 16)), _t((1, 2, 8, 16), device="meta"), _t((1, 2, 8, 16)),
     "on"),
    (_t((1, 2, 8, 16)), _t((1, 2, 8, 16)), _t((1, 2, 9, 16)), "want"),
    (_t((2, 8, 16)), _t((2, 8, 16)), _t((2, 8, 16)), "want"),
    (_t((1, 2, 8, 16)), _t((1, 2, 0, 16)), _t((1, 2, 0, 16)), "Skv = 0"),
])
def test_wrapper_refuses(q, k, v, match):
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v)
