"""The port's dense transformer (qwen2, stablelm, llama3, codeqwen)
against the reference.

Weights are made by the reference (``init_params``), their QKV biases
and norm gammas replaced by random values so that those paths carry
numbers, and carried across by ``repro_torch.models.convert``; inputs
are drawn with numpy.  The prefill's attention runs the flash kernel's
plain version on the CPU; the reference computes the same attention in
plain jnp.  Tolerances:

* float32 (``cfg.scaled(dtype=float32)``): the same float32 math in
  other summation orders, ``F32_TOL = 1e-5`` on outputs and logits of
  order 1 or below;
* bfloat16: the repo's own decode tolerance, 4e-2
  (tests/test_decode_consistency.py), at 2 layers.  The two frameworks
  round bf16 at other places: the port's norm rounds once where the
  reference's rounds twice, and the flash kernel on the card rounds
  each kv tile's unnormalised P where the reference model (and the
  kernel's plain version here) rounds the normalised probabilities.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_configs
from repro.models import attention as ref_attn
from repro.models import mlp as ref_mlp
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro.models.common import Family as RefFamily
from repro.models.common import ModelConfig as RefConfig
from repro.models.common import apply_rope as ref_apply_rope
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm_fused
from repro_torch.models import attention, registry, transformer
from repro_torch.models.common import Family, ModelConfig, apply_rope
from repro_torch.models.convert import (dense_lm_from_reference,
                                        dense_state_dict)
from repro_torch.models.mlp import mlp

F32_TOL = 1e-5
BF16_TOL = 4e-2

DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}

DENSE_ARCHS = ["qwen2-1.5b", "stablelm-1.6b", "llama3-8b", "codeqwen1.5-7b"]

#: tests/test_decode_consistency.py CASES["dense"] (head dim 12)
DENSE_CASE = dict(n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
                  vocab=128)


def _configs(name, dtype):
    jd, td, _ = DTYPES[dtype]
    if name == "dense_case":
        return (RefConfig(name=name, family=RefFamily.DENSE, remat=False,
                          dtype=jd, **DENSE_CASE),
                ModelConfig(name=name, family=Family.DENSE, remat=False,
                            dtype=td, **DENSE_CASE))
    return (ref_configs.get_smoke_config(name).scaled(dtype=jd),
            get_smoke_config(name).scaled(dtype=td))


def _np(x):
    return np.asarray(x, np.float32)


def _tn(x: torch.Tensor):
    return x.float().numpy()


def _close(got: torch.Tensor, want, tol, msg=""):
    np.testing.assert_allclose(_tn(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _host_params(jc, seed=0):
    """Reference weights with random biases and norm gammas, as NumPy."""
    host = jax.tree_util.tree_map(np.asarray,
                                  ref_registry.init_params(jc, seed))
    rng = np.random.default_rng(seed + 100)
    blocks = host["blocks"]
    for name in ("bq", "bk", "bv"):
        if name in blocks["attn"]:
            blocks["attn"][name] = rng.normal(
                0, 0.1, blocks["attn"][name].shape).astype(np.float32)
    for name in ("ln1", "ln2"):
        blocks[name] = (1 + 0.1 * rng.standard_normal(blocks[name].shape)) \
            .astype(np.float32)
    host["ln_f"] = (1 + 0.1 * rng.standard_normal(host["ln_f"].shape)) \
        .astype(np.float32)
    return host


def _models(name, dtype, seed=0):
    jc, tc = _configs(name, dtype)
    host = _host_params(jc, seed)
    params = jax.tree_util.tree_map(jnp.asarray, host)
    return jc, tc, params, dense_lm_from_reference(host, tc, device="cpu")


def _layer(params, i):
    return jax.tree_util.tree_map(lambda a: a[i], params["blocks"])


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_rope_matches_reference(dtype, theta):
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    want = ref_apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), theta)
    got = apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(pos),
                     theta)
    assert got.dtype == td
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_qkv_project_matches_reference(name, dtype):
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want = ref_attn.qkv_project(_layer(params, 0)["attn"],
                                jnp.asarray(x, jc.dtype), jc,
                                jnp.asarray(pos))
    got = attention.qkv_project(model.weights()["blocks"][0],
                                torch.from_numpy(x).to(tc.dtype), tc,
                                torch.from_numpy(pos.copy()))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == tc.dtype
        _close(g, w, tol)


def _qkv(rng, bsz, sq, skv, heads, kv_heads, hd):
    return (rng.standard_normal((bsz, sq, heads, hd)).astype(np.float32),
            rng.standard_normal((bsz, skv, kv_heads, hd)).astype(np.float32),
            rng.standard_normal((bsz, skv, kv_heads, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gqa_attend_decode_is_masked_like_reference(dtype):
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 3, 1, 20, 6, 2, 16)
    valid = np.array([5, 20, 1], np.int32)
    k_junk, v_junk = k.copy(), v.copy()
    k_junk[0, 5:] = 1e4                       # slots past the valid length
    v_junk[0, 5:] = -1e4
    want = ref_attn.gqa_attend(*(jnp.asarray(a, jd) for a in (q, k, v)),
                               causal=False, kv_valid_len=jnp.asarray(valid))
    for kk, vv in ((k, v), (k_junk, v_junk)):
        got = attention.gqa_attend(
            *(torch.from_numpy(a).to(td) for a in (q, kk, vv)), causal=False,
            kv_valid_len=torch.from_numpy(valid))
        _close(got, want, tol)


@pytest.mark.parametrize("sq,skv", [(6, 6), (6, 10), (10, 6)])
def test_gqa_attend_causal_matches_reference(sq, skv):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, sq, skv, 4, 2, 8)
    want = ref_attn.gqa_attend(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=True)
    got = attention.gqa_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4), (8, 1), (6, 2),
                                            (12, 2)])
@pytest.mark.parametrize("seq", [1, 7, 70])
def test_flash_attend_is_the_reference_attention(heads, kv_heads, seq):
    """The prefill's path through the flash kernel (its plain version
    here) computes the reference model's causal attention, head grouping
    included."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, seq, seq, heads, kv_heads, 16)
    want = ref_attn.gqa_attend(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=True)
    got = attention.flash_attend(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (2, seq, heads, 16)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("gelu", False), ("relu", False)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_matches_reference(dtype, act, glu):
    jc, tc = _configs("qwen2-1.5b", dtype)
    jc, tc = jc.scaled(act=act, glu=glu), tc.scaled(act=act, glu=glu)
    host = _host_params(jc)
    model = dense_lm_from_reference(host, tc, device="cpu")
    tol = DTYPES[dtype][2]
    x = np.random.default_rng(5).standard_normal((2, 5, jc.d_model)) \
        .astype(np.float32)
    want = ref_mlp.mlp(jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                              host["blocks"]["mlp"]),
                       jnp.asarray(x, jc.dtype), jc)
    got = mlp(model.weights()["blocks"][0], torch.from_numpy(x).to(tc.dtype),
              tc)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_forward_matches_reference(dtype):
    jc, tc, params, model = _models("qwen2-1.5b", dtype)
    tol = DTYPES[dtype][2]
    x = np.random.default_rng(6).standard_normal((2, 11, jc.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    y_ref, (k_ref, v_ref, _) = ref_tf.block_forward(
        _layer(params, 0), jnp.asarray(x, jc.dtype), jc, jnp.asarray(pos))
    y, (k, v, aux) = transformer.block_forward(
        model.weights()["blocks"][0], torch.from_numpy(x).to(tc.dtype), tc,
        torch.from_numpy(pos))
    assert y.dtype == tc.dtype and float(aux) == 0.0
    for got, want in ((y, y_ref), (k, k_ref), (v, v_ref)):
        _close(got, want, tol)
    # the prefix-LM mask (the VLM family's): the first 3 positions see
    # each other, as in the reference's block
    y_ref, (k_ref, v_ref, _) = ref_tf.block_forward(
        _layer(params, 0), jnp.asarray(x, jc.dtype), jc, jnp.asarray(pos),
        prefix_len=3)
    y3, (k, v, _) = transformer.block_forward(
        model.weights()["blocks"][0], torch.from_numpy(x).to(tc.dtype), tc,
        torch.from_numpy(pos), prefix_len=3)
    for got, want in ((y3, y_ref), (k, k_ref), (v, v_ref)):
        _close(got, want, tol)
    assert not torch.equal(y3[:, :2], y[:, :2])
    assert torch.equal(y3[:, 3:], y[:, 3:])


#: (model, dtype): every dense arch in float32, qwen2-1.5b in bf16 at its
#: smoke depth of 2 layers, and the decode-consistency case (head dim 12)
LM_CASES = [(n, "float32") for n in DENSE_ARCHS + ["dense_case"]] + \
    [("qwen2-1.5b", "bfloat16")]


@pytest.mark.parametrize("name,dtype", LM_CASES)
def test_lm_apply_matches_reference(name, dtype):
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    toks = np.random.default_rng(7).integers(1, jc.vocab, (2, 10)) \
        .astype(np.int32)
    want, _ = ref_registry.train_forward(params, {"tokens": jnp.asarray(toks)},
                                         jc)
    got, aux = registry.train_forward(model,
                                      {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (2, 10, tc.vocab_padded) and float(aux) == 0.0
    _close(got, want, tol)


@pytest.mark.parametrize("name,dtype", LM_CASES)
def test_prefill_and_decode_match_reference(name, dtype):
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(8)
    bsz, seq = 2, 12
    toks = rng.integers(1, jc.vocab, (bsz, seq)).astype(np.int32)
    st_ref = ref_registry.make_decode_state(jc, bsz, seq + 4)
    st = registry.make_decode_state(tc, bsz, seq + 4, device="cpu")
    before = flash_attention.launches, rmsnorm_fused.launches
    lg_ref, st_ref = ref_registry.prefill(
        params, {"tokens": jnp.asarray(toks)}, jc, st_ref)
    lg, st = registry.prefill(model, {"tokens": torch.from_numpy(toks)}, tc,
                              st)
    assert (flash_attention.launches, rmsnorm_fused.launches) == before
    assert lg.shape == (bsz, 1, tc.vocab_padded) and st.pos == seq
    _close(lg, lg_ref, tol)
    for t in range(3):
        tok = rng.integers(1, jc.vocab, (bsz, 1)).astype(np.int32)
        lg_ref, st_ref = ref_registry.decode_step(params, jnp.asarray(tok),
                                                  jc, st_ref)
        lg, st = registry.decode_step(model, torch.from_numpy(tok), tc, st)
        _close(lg, lg_ref, tol, f"decode step {t}")
    assert st.pos == seq + 3 == int(st_ref.pos)
    np.testing.assert_array_equal(st.cache.length.numpy(),
                                  np.asarray(st_ref.cache.length))
    # the cached k and v are activations of order 1, held relative to
    # their largest value
    for got, want in ((st.cache.k, st_ref.cache.k),
                      (st.cache.v, st_ref.cache.v)):
        assert tuple(got.shape) == want.shape and got.dtype == tc.dtype
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_tn(got), _np(want), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_matches_teacher_forcing(dtype):
    """tests/test_decode_consistency.py, on the port alone."""
    tc = ModelConfig(name="dense", family=Family.DENSE, remat=False,
                     dtype=DTYPES[dtype][1], **DENSE_CASE)
    model = registry.init_params(tc, 0, "cpu")
    bsz, seq = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, tc.vocab, (bsz, seq)).astype(np.int32))
    full, _ = registry.train_forward(model, {"tokens": toks}, tc)
    half = seq // 2
    state = registry.make_decode_state(tc, bsz, seq + 2, device="cpu")
    lg, state = registry.prefill(model, {"tokens": toks[:, :half]}, tc,
                                 state)
    _close(lg[:, 0], _tn(full[:, half - 1]), BF16_TOL)
    for t in range(half, seq - 1):
        lg, state = registry.decode_step(model, toks[:, t:t + 1], tc, state)
        _close(lg[:, 0], _tn(full[:, t]), BF16_TOL, f"decode diverges at {t}")


def test_cache_overflow_is_refused():
    cfg = get_smoke_config("qwen2-1.5b")
    cache = attention.init_cache(cfg, 2, 8, device="cpu")
    k = torch.zeros(2, 3, cfg.n_kv_heads, cfg.hd, dtype=cfg.dtype)
    attention.cache_update(cache.k[0], cache.v[0], k, k, 5)
    with pytest.raises(ValueError, match="do not fit"):
        attention.cache_update(cache.k[0], cache.v[0], k, k, 6)


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            v = str(v).split(".")[-1].replace("'>", "")
        elif f.name == "family":
            v = v.value
        out[f.name] = v
    return out


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_config_equals_reference_field_by_field(name, which):
    ref = (ref_configs.get_config if which == "CONFIG"
           else ref_configs.get_smoke_config)(name)
    got = (get_config if which == "CONFIG" else get_smoke_config)(name)
    assert _fields(got) == _fields(ref)
    assert got.vocab_padded == ref.vocab_padded and got.hd == ref.hd
    assert got.family == Family.DENSE


def test_qwen2_1_5b_parameter_count():
    """1,543,714,304 parameters at full width, counted from the shapes
    (the full model is built only on the card)."""
    cfg = get_config("qwen2-1.5b")
    with torch.device("meta"):
        model = transformer.DenseLM(cfg)
    assert sum(p.numel() for p in model.parameters()) == 1_543_714_304


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_init_lays_out_weights_like_reference(name):
    jc, tc = _configs(name, "float32")
    ref = dense_state_dict(_host_params(jc), tc)
    a = registry.init_params(tc, 7, "cpu")
    b = registry.init_params(tc, 7, "cpu")
    c = registry.init_params(tc, 8, "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert {k: tuple(v.shape) for k, v in sa.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    assert all(v.dtype == torch.float32 for v in sa.values())
    for key, v in sa.items():
        if key.endswith(("ln1", "ln2", "ln_f")):
            assert torch.equal(v, torch.ones_like(v))
        elif key.split(".")[-1] in ("bq", "bk", "bv"):
            assert torch.equal(v, torch.zeros_like(v))
        else:               # drawn: N(0, 0.02^2) or N(0, 1/fan_in)
            scale = 0.02 if key in ("embed", "lm_head") \
                else v.shape[0] ** -0.5
            assert 0.8 < float(v.std()) / scale < 1.2, key


def test_moe_family_builds_moe_layers():
    """The transformer builds ``moe`` in place of ``mlp`` for the MoE
    family, and refuses a family it does not hold."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    model = registry.init_params(cfg, 0, "cpu")
    assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
               for b in model.blocks)
    assert all("moe" in w for w in model.weights()["blocks"])
    with pytest.raises(ValueError, match="dense or the MoE"):
        transformer.DenseLM(get_smoke_config("mamba2-130m"))


def test_convert_checks_shapes():
    jc, tc = _configs("qwen2-1.5b", "float32")
    host = _host_params(jc)
    with pytest.raises(ValueError, match="stacked layers"):
        dense_lm_from_reference(host, tc.scaled(n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="embed"):
        dense_lm_from_reference(host, tc.scaled(vocab=1000), device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        dense_lm_from_reference(host, tc.scaled(d_ff=64), device="cpu")


#: qwen2-1.5b narrowed (GQA group 6 and depth as published) for the
#: bf16 depth witness
WITNESS_WIDTH = dict(d_model=384, n_heads=6, n_kv_heads=1, d_ff=2240,
                     vocab=4096)


def _permuted(model: transformer.DenseLM, seed: int) -> dict:
    """The state dict of the same network with its residual and MLP
    hidden coordinates permuted: every product and norm then sums in
    another order, and nothing else changes."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    pd = torch.from_numpy(rng.permutation(cfg.d_model))
    pf = torch.from_numpy(rng.permutation(cfg.d_ff))
    out = {}
    for key, v in model.state_dict().items():
        name = key.split(".")[-1]
        if name in ("embed",):
            v = v[:, pd]
        elif name in ("ln1", "ln2", "ln_f", "lm_head"):
            v = v[pd]
        elif name in ("wq", "wk", "wv"):
            v = v[pd, :]
        elif name == "wo":
            v = v[:, pd]
        elif name in ("w_in", "w_gate"):
            v = v[pd][:, pf]
        elif name == "w_out":
            v = v[pf][:, pd]
        out[key] = v.contiguous()
    return out


def test_bf16_rounding_spread_grows_with_depth():
    """Two bf16 runs of one network that differ only in summation order
    share most of their rounding at 2 layers and little of it at 28, yet
    stay as close to the float32 run as each other.  chip_smoke.py holds
    the card's bf16 logits at 28 layers to their distance from float32
    (``BF16_ACCURACY_RATIO``) for that reason."""
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, WITNESS_WIDTH["vocab"], (2, 128))
                            .astype(np.int32))
    base = get_config("qwen2-1.5b").scaled(**WITNESS_WIDTH)
    gaps = {}
    for n_layers in (2, 28):
        lg = {}
        for dtype in (torch.float32, torch.bfloat16):
            cfg = base.scaled(n_layers=n_layers, dtype=dtype)
            model = registry.init_params(cfg, 0, "cpu")
            runs = [model]
            if dtype == torch.bfloat16:
                perm = transformer.DenseLM(cfg, device="cpu")
                perm.load_state_dict(_permuted(model, 3))
                runs.append(perm)
            for i, m in enumerate(runs):
                state = registry.make_decode_state(cfg, 2, 128, device="cpu")
                out, _ = registry.prefill(m, {"tokens": toks}, cfg, state)
                lg[str(dtype)[6:], i] = _tn(out)[:, -1, :cfg.vocab]
        np.testing.assert_allclose(lg["float32", 0], lg["float32", 0])
        for stat in ("max", "mean"):
            f = lambda a: float(getattr(np, stat)(np.abs(a)))  # noqa: E731
            gaps[n_layers, stat] = {
                "bf16-f32": f(lg["bfloat16", 0] - lg["float32", 0]),
                "perm-f32": f(lg["bfloat16", 1] - lg["float32", 0]),
                "perm-bf16": f(lg["bfloat16", 1] - lg["bfloat16", 0])}
    print(f"bf16 logit gaps (layers, statistic): {gaps}")
    for (n_layers, stat), g in gaps.items():
        assert g["perm-f32"] <= 1.25 * g["bf16-f32"], (n_layers, stat, g)
    shallow = gaps[2, "mean"]["perm-bf16"] / gaps[2, "mean"]["bf16-f32"]
    deep = gaps[28, "mean"]["perm-bf16"] / gaps[28, "mean"]["bf16-f32"]
    assert shallow <= 0.5 and deep >= max(0.6, 1.5 * shallow), \
        (shallow, deep, gaps)
