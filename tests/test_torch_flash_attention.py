"""The port's flash attention (kernel B2) against the reference Pallas
kernel and the reference model's attention.

On the CPU the wrapper runs its plain PyTorch version; the same
numpy-seeded inputs go through the JAX ``flash_attention`` (interpret
mode) and ``attention_ref``.  Tolerances are the JAX kernel tests' own
(tests/test_kernels.py): float32 at ``rtol = atol = 3e-5``, bfloat16 at
``5e-2``.  Lengths that are not block multiples, and ``Sq != Skv``, are
held against ``attention_ref`` only, because the JAX kernel refuses
them.

In bfloat16 the plain version rounds the probabilities to bf16 before
``P.V``, as the served model does: it is held against the reference
model's ``gqa_attend`` and the port's to one bf16 ulp of the value.  The
CUDA kernel rounds the unnormalised ``exp(s - m)`` of each kv tile
instead; :func:`_kernel_order` emulates its order in plain torch, and
the witness test bounds the difference that the placement of that one
rounding makes.  The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py, at
the tolerance the witness sets.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as flash_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import attention

F32_TOL = 3e-5
BF16_TOL = 5e-2
#: one bf16 ulp of the value: at most 2**-7 of it (8 significant bits)
BF16_ULP = 2.0 ** -7
#: the CUDA kernel's bf16 tolerance against the plain version is rtol
#: BF16_ULP, for the two final roundings of the output (half an ulp
#: each), plus, per output, atol BF16_ATOL_PER_PV * sum_j p_j |v_j|, for
#: the placement of P's rounding: each placement rounds every p_j to
#: within 2**-8 p_j, so the two differ by at most 2**-7 sum_j p_j |v_j|
BF16_ATOL_PER_PV = 2.0 ** -7

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


def _bf16_limit(want, q, k, v, causal, prefix_len=0):
    """Per output of ``want``: ``BF16_ULP * |want| + BF16_ATOL_PER_PV *
    sum_j p_j |v_j|``, p the float32 probabilities, all in the kernel's
    layout."""
    pv = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                               causal=causal, prefix_len=prefix_len)
    return BF16_ULP * want.float().abs() + BF16_ATOL_PER_PV * pv


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


@pytest.mark.parametrize("causal,prefix_len,match", [
    (False, 4, "causal"), (True, -1, "outside"), (True, 9, "outside")])
def test_wrapper_refuses_prefix(causal, prefix_len, match):
    """The prefix is a mode of the causal mask, and lies in ``[0, Skv]``."""
    q = _t((1, 2, 8, 16))
    with pytest.raises(ValueError, match=match):
        flash_attention(q, q, q, causal=causal, prefix_len=prefix_len)


@pytest.mark.parametrize("q,k,v,match", [
    (_t((1, 3, 8, 16)), _t((1, 2, 8, 16)), _t((1, 2, 8, 16)), "multiple"),
    (_t((1, 2, 8, 257)), _t((1, 2, 8, 257)), _t((1, 2, 8, 257)), "head dim"),
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


# ------------------------------------------------------------- bf16 numerics
def _bf16_model_inputs(bsz, seq, heads, kv_heads, hd, seed):
    """q ``[B,S,H,hd]``, k and v ``[B,S,Hkv,hd]`` in the model's layout,
    bf16 values drawn with numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((bsz, seq, heads, hd), (bsz, seq, kv_heads, hd),
             (bsz, seq, kv_heads, hd))]


@pytest.mark.parametrize("heads,kv_heads,seq,hd", [
    (4, 2, 48, 16), (6, 2, 70, 32), (4, 4, 33, 64), (12, 2, 40, 128)])
def test_bf16_plain_is_the_model_attention(heads, kv_heads, seq, hd):
    """bf16 ``flash_attention_plain``, reached through ``flash_attend``
    (which puts the q heads in the kernel's order and back), is the
    port's ``gqa_attend`` to one bf16 ulp of the value, and the reference
    model's ``gqa_attend`` to one ulp plus ``BF16_ATOL_PER_PV * sum_j
    p_j |v_j|``: jax rounds its float32 softmax in another order, so a
    p_j next to a bf16 rounding boundary can round the other way, which
    moves an output by up to 2**-7 p_j |v_j| (5 of 26,880 outputs at 6
    heads over 2 exceed one ulp of the value, by at most 1.2e-3)."""
    arrays = _bf16_model_inputs(2, seq, heads, kv_heads, hd, seed=5)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = attention.flash_attend(q, k, v).float().numpy()
    assert got.shape == q.shape
    port = attention.gqa_attend(q, k, v, causal=True)
    np.testing.assert_allclose(got, port.float().numpy(), rtol=BF16_ULP,
                               atol=0.0)
    ref = ref_attn.gqa_attend(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                              causal=True)
    pv = attention.flash_attend(q.float(), k.float(), v.float().abs())
    gap = np.abs(got - np.asarray(ref, np.float32))
    limit = BF16_ULP * np.abs(np.asarray(ref, np.float32)) + \
        BF16_ATOL_PER_PV * pv.numpy()
    assert (gap <= limit).all(), float((gap / limit).max())


def _kernel_order(q, k, v, causal, block_q=128, block_k=64, prefix_len=0):
    """The CUDA kernel's bf16 order in plain torch: 128-row q tiles walk
    64-row kv tiles; scores are float32 products scaled by
    ``log2(e) / sqrt(hd)``; per tile the running max m and sum l are
    float32, the unnormalised ``P = exp2(s - m)`` is rounded to bf16 for
    a float32 ``P.V``, and the accumulator is rescaled by ``alpha =
    exp2(m_old - m_new)``; the output is ``acc / max(l, 1e-20)`` cast
    once.  The causal mask keeps ``kpos <= max(qpos, prefix_len - 1)``,
    and the kv loop runs to the tile of the q tile's last row's limit."""
    bsz, heads, sq, hd = q.shape
    skv, group = k.shape[2], heads // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale = torch.tensor(math.log2(math.e) / math.sqrt(hd))
    out = torch.empty(q.shape)
    for q0 in range(0, sq, block_q):
        rows = torch.arange(q0, min(q0 + block_q, sq))
        m = torch.full((bsz, heads, rows.numel()), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(bsz, heads, rows.numel(), hd)
        n_tiles = -(-skv // block_k)
        limit = rows.clamp(min=prefix_len - 1)
        if causal:
            n_tiles = min(n_tiles, int(limit[-1]) // block_k + 1)
        for k0 in range(0, n_tiles * block_k, block_k):
            cols = torch.arange(k0, min(k0 + block_k, skv))
            s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale
            if causal:
                s = torch.where(cols[None, :] <= limit[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + \
                p.to(torch.bfloat16).float() @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-20)[..., None]
    return out.to(q.dtype)


NEG_INF = -1e30


@pytest.mark.parametrize("q_shape,kv_shape,causal", [
    ((1, 4, 512, 128), (1, 4, 512, 128), True),    # serve-like
    ((8, 12, 512, 128), (8, 2, 512, 128), True),   # qwen2-1.5b prefill
    ((1, 8, 512, 64), (1, 8, 512, 64), True),      # stablelm head dim
    ((2, 4, 200, 128), (2, 2, 200, 128), True),    # ragged, GQA
    ((1, 4, 7, 64), (1, 2, 333, 64), False),       # Sq != Skv
])
def test_kernel_order_witness(q_shape, kv_shape, causal):
    """The witness behind the bf16 tolerance of the CUDA kernel against
    the plain version (tests/test_torch_cuda.py, chip_smoke.py): the
    kernel's order, emulated, agrees with the plain version to rtol
    ``BF16_ULP`` plus, per output, ``BF16_ATOL_PER_PV * sum_j p_j |v_j|``
    (``-s`` prints the largest gap as a share of its limit).  The gap is
    absolute, not relative to the output: at the prefill's shape, a
    fixed atol of 2**-8 fails 2 to 9 of the 6.3 million outputs at numpy
    seeds 0-2 (gaps up to 7.8e-3 on outputs of 0.005-0.4).  Half the
    limit's atol, one placement's worst case, fails 2 outputs at numpy
    seed 1 and q ``[2,12,512,128]``, where the full limit leaves a
    factor of 1.6 to spare."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in (q_shape, kv_shape, kv_shape))
    got = _kernel_order(q, k, v, causal).float()
    want = flash_attention_plain(q, k, v, causal=causal).float()
    gap = (got - want).abs()
    share = float((gap / _bf16_limit(want, q, k, v, causal)).max())
    print(f"{q_shape}: max gap {float(gap.max()):.3e}, {int((gap > 0).sum())}"
          f" of {gap.numel()} differ, largest gap {share:.3f} of its limit")
    assert share <= 1.0


@pytest.mark.parametrize("q_shape,kv_shape,prefix_len", [
    ((2, 8, 768, 256), (2, 1, 768, 256), 256),   # paligemma-3b's prefill
    ((1, 4, 200, 192), (1, 2, 200, 192), 130),   # ragged, hd 192
])
def test_kernel_order_witness_prefix(q_shape, kv_shape, prefix_len):
    """The bf16 witness of :func:`test_kernel_order_witness` in the
    prefix-LM mode at head dims 256 and 192: the same limit holds."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in (q_shape, kv_shape, kv_shape))
    got = _kernel_order(q, k, v, True, prefix_len=prefix_len).float()
    want = flash_attention_plain(q, k, v, prefix_len=prefix_len).float()
    gap = (got - want).abs()
    share = float((gap / _bf16_limit(want, q, k, v, True,
                                     prefix_len)).max())
    print(f"{q_shape}, prefix {prefix_len}: max gap {float(gap.max()):.3e}, "
          f"largest gap {share:.3f} of its limit")
    assert share <= 1.0


# ------------------------------------- head dims above 128, the prefix mode
#: the prefix-LM cases below, at Sq = Skv = 40: none, one position, half
#: the sequence, all of it
PREFIXES = [0, 1, 20, 40]


@pytest.mark.parametrize("prefix_len", PREFIXES)
@pytest.mark.parametrize("hd", [192, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_prefix_is_the_model_attention(dtype, hd, prefix_len):
    """``flash_attention_plain`` through ``flash_attend`` against the
    reference model's ``gqa_attend(causal=True, prefix_len=P)`` at 8
    heads over one kv head (paligemma's grouping): float32 at
    ``F32_TOL``; bf16 to one ulp of the value plus ``BF16_ATOL_PER_PV *
    sum_j p_j |v_j|``, as :func:`test_bf16_plain_is_the_model_attention`
    holds it."""
    arrays = _bf16_model_inputs(2, 40, 8, 1, hd, seed=6)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q, k, v = (torch.from_numpy(a).to(td) for a in arrays)
    got = attention.flash_attend(q, k, v, prefix_len=prefix_len)
    assert got.dtype == td and got.shape == q.shape
    got = got.float().numpy()
    ref = np.asarray(ref_attn.gqa_attend(
        *(jnp.asarray(a, jd) for a in arrays), causal=True,
        prefix_len=prefix_len), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
        return
    pv = attention.flash_attend(q.float(), k.float(), v.float().abs(),
                                prefix_len=prefix_len).numpy()
    gap = np.abs(got - ref)
    limit = BF16_ULP * np.abs(ref) + BF16_ATOL_PER_PV * pv
    assert (gap <= limit).all(), float((gap / limit).max())


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_at_head_dim_256(causal):
    """The Pallas kernel takes any head dim through its block specs;
    at 256 (interpret mode, 64-row blocks) the plain version is it, in
    float32, at ``F32_TOL``."""
    arrays = _inputs(1, 4, 1, 128, 128, 256, seed=7)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    pallas = flash_pallas(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                          interpret=True)
    _close(_run(arrays, torch.float32, causal), pallas, F32_TOL)
