"""The port's Mamba2 block and SSM language model against the reference.

Weights are made by the reference (``init_mamba2`` / ``init_params``)
and carried across by ``repro_torch.models.convert``; inputs are drawn
with numpy.  Tolerances:

* float32 (``cfg.scaled(dtype=float32)``): the same float32 math in
  other summation orders, ``F32_TOL = 1e-4`` on outputs of order 1;
* bfloat16: the repo's own decode tolerance, 4e-2
  (tests/test_decode_consistency.py).  The two frameworks round bf16 at
  other places, and the port's norm rounds once where the reference's
  rounds twice (one bf16 ulp; tests/test_torch_rmsnorm.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mamba2_130m import CONFIG as REF_CONFIG
from repro.configs.mamba2_130m import SMOKE as REF_SMOKE
from repro.models import mamba2 as ref_mamba2
from repro.models import registry as ref_registry
from repro.models.common import Family as RefFamily
from repro.models.common import ModelConfig as RefConfig
from repro_torch.configs import ARCHS, PORTED, get_config, get_smoke_config
from repro_torch.configs.mamba2_130m import CONFIG, SMOKE
from repro_torch.kernels.rmsnorm import rmsnorm_fused
from repro_torch.kernels.ssd_scan import ssd_inner
from repro_torch.models import registry
from repro_torch.models.common import Family, ModelConfig
from repro_torch.models.convert import ssm_lm_from_reference
from repro_torch.models.mamba2 import (Mamba2Block, Mamba2State,
                                       init_mamba2_state)

F32_TOL = 1e-4
BF16_TOL = 4e-2

DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}

#: tests/test_decode_consistency.py CASES["ssm"]
SSM_CASE = dict(family=Family.SSM, n_layers=3, d_model=48, n_heads=0,
                n_kv_heads=0, d_ff=0, vocab=128, ssm_state=8,
                ssm_head_dim=16, ssm_chunk=4, supports_long_context=True)


def _configs(name, dtype):
    jd, td, _ = DTYPES[dtype]
    if name == "smoke":
        return REF_SMOKE.scaled(dtype=jd), SMOKE.scaled(dtype=td)
    ref = dict(SSM_CASE, family=RefFamily.SSM)
    return (RefConfig(name="ssm", remat=False, dtype=jd, **ref),
            ModelConfig(name="ssm", remat=False, dtype=td, **SSM_CASE))


def _np(x):
    return np.asarray(x, np.float32)


def _tn(x: torch.Tensor):
    return x.float().numpy()


def _models(name, dtype, seed=0):
    jc, tc = _configs(name, dtype)
    params = ref_registry.init_params(jc, seed)
    model = ssm_lm_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                  tc, device="cpu")
    return jc, tc, params, model


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_forward_and_decode_match_reference(dtype):
    jc, tc = _configs("smoke", dtype)
    tol = DTYPES[dtype][2]
    p = ref_mamba2.init_mamba2(jax.random.PRNGKey(3), jc)
    block = Mamba2Block(tc)
    block.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in p.items()})
    rng = np.random.default_rng(0)
    B, S = 2, 24
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jc.dtype), torch.from_numpy(x).to(tc.dtype)
    y_ref, st_ref = ref_mamba2.mamba2_forward(p, jx, jc)
    y, st = block(tx)
    assert y.dtype == tc.dtype and y.shape == (B, S, jc.d_model)
    np.testing.assert_allclose(_tn(y), _np(y_ref), rtol=tol, atol=tol)
    for a, b in zip(st, st_ref):
        np.testing.assert_allclose(_tn(a), _np(b), rtol=tol, atol=tol)
    x1 = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    y1_ref, st1_ref = ref_mamba2.mamba2_decode(
        p, jnp.asarray(x1, jc.dtype), st_ref, jc)
    y1, st1 = block.decode(torch.from_numpy(x1).to(tc.dtype), st)
    np.testing.assert_allclose(_tn(y1), _np(y1_ref), rtol=tol, atol=tol)
    for a, b in zip(st1, st1_ref):
        np.testing.assert_allclose(_tn(a), _np(b), rtol=tol, atol=tol)


def test_block_state_layout_matches_reference():
    jc, tc = _configs("smoke", "bfloat16")
    ref = ref_mamba2.init_mamba2_state(jc, 3)
    got = init_mamba2_state(tc, 3, "cpu")
    assert isinstance(got, Mamba2State)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["smoke", "ssm_case"])
def test_prefill_and_decode_match_reference(name, dtype):
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(1)
    B, S = 2, 12
    toks = rng.integers(1, jc.vocab, (B, S)).astype(np.int32)
    st_ref = ref_registry.make_decode_state(jc, B, S + 4)
    st = registry.make_decode_state(tc, B, S + 4, device="cpu")
    n_inner, n_norm = ssd_inner.launches, rmsnorm_fused.launches
    lg_ref, st_ref = ref_registry.prefill(
        params, {"tokens": jnp.asarray(toks)}, jc, st_ref)
    lg, st = registry.prefill(model, {"tokens": torch.from_numpy(toks)}, tc,
                              st)
    assert (ssd_inner.launches, rmsnorm_fused.launches) == (n_inner, n_norm)
    assert lg.shape == (B, 1, tc.vocab_padded) and st.pos == S
    np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=tol, atol=tol)
    for t in range(3):
        tok = rng.integers(1, jc.vocab, (B, 1)).astype(np.int32)
        lg_ref, st_ref = ref_registry.decode_step(params, jnp.asarray(tok),
                                                  jc, st_ref)
        lg, st = registry.decode_step(model, torch.from_numpy(tok), tc, st)
        np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=tol, atol=tol,
                                   err_msg=f"decode step {t}")
    assert st.pos == S + 3
    for layer, got in enumerate(st.states):
        for a, b in zip(got, st_ref.states):
            np.testing.assert_allclose(_tn(a), _np(b[layer]), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_train_forward_matches_reference(dtype):
    jc, tc, params, model = _models("ssm_case", dtype)
    tol = DTYPES[dtype][2]
    toks = np.random.default_rng(2).integers(1, jc.vocab, (2, 10)) \
        .astype(np.int32)
    lg_ref, _ = ref_registry.train_forward(
        params, {"tokens": jnp.asarray(toks)}, jc)
    lg, aux = registry.train_forward(model, {"tokens": torch.from_numpy(toks)},
                                     tc)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_matches_teacher_forcing(dtype):
    """tests/test_decode_consistency.py, on the port alone."""
    tc = ModelConfig(name="ssm", remat=False, dtype=DTYPES[dtype][1],
                     **SSM_CASE)
    model = registry.init_params(tc, 0, "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, tc.vocab, (B, S)).astype(np.int32))
    full, _ = registry.train_forward(model, {"tokens": toks}, tc)
    half = S // 2
    state = registry.make_decode_state(tc, B, S + 2, device="cpu")
    lg, state = registry.prefill(model, {"tokens": toks[:, :half]}, tc,
                                 state)
    np.testing.assert_allclose(_tn(lg[:, 0]), _tn(full[:, half - 1]),
                               rtol=BF16_TOL, atol=BF16_TOL)
    for t in range(half, S - 1):
        lg, state = registry.decode_step(model, toks[:, t:t + 1], tc, state)
        np.testing.assert_allclose(_tn(lg[:, 0]), _tn(full[:, t]),
                                   rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=f"decode diverges at {t}")


#: a narrower mamba2-130m (head dim and depth as published) for the
#: bf16 depth witness
DEPTH_WIDTH = dict(d_model=256, vocab=512, ssm_state=64, ssm_head_dim=64,
                   ssm_chunk=16, remat=False)


def test_bf16_spread_grows_with_depth_like_reference():
    """The bf16 model's rounding error against float32 grows with depth
    in the reference as in the port, to the order of the logits at 24
    layers, while the two bf16 implementations stay closer to each other
    than either is to float32.  chip_smoke.py holds the card's bf16
    logits at 24 layers to a share of this spread for that reason."""
    rng = np.random.default_rng(1)
    B, S = 2, 64
    toks = rng.integers(1, DEPTH_WIDTH["vocab"], (B, S)).astype(np.int32)
    gaps = {}
    for n_layers in (2, 24):
        params = ref_registry.init_params(REF_CONFIG.scaled(
            n_layers=n_layers, dtype=jnp.float32, **DEPTH_WIDTH), 0)
        host = jax.tree_util.tree_map(np.asarray, params)
        lg = {}
        for name, (jd, td, _) in DTYPES.items():
            jc = REF_CONFIG.scaled(n_layers=n_layers, dtype=jd, **DEPTH_WIDTH)
            tc = CONFIG.scaled(n_layers=n_layers, dtype=td, **DEPTH_WIDTH)
            out, _ = ref_registry.prefill(
                params, {"tokens": jnp.asarray(toks)}, jc,
                ref_registry.make_decode_state(jc, B, S))
            lg["ref", name] = _np(out)[:, -1]
            out, _ = registry.prefill(
                ssm_lm_from_reference(host, tc, device="cpu"),
                {"tokens": torch.from_numpy(toks)}, tc,
                registry.make_decode_state(tc, B, S, device="cpu"))
            lg["port", name] = _tn(out)[:, -1]
        np.testing.assert_allclose(lg["port", "float32"], lg["ref", "float32"],
                                   rtol=1e-3, atol=1e-3)
        for stat in ("max", "mean"):
            f = lambda a: float(getattr(np, stat)(a))  # noqa: E731
            gaps[n_layers, stat] = {
                "ref": f(abs(lg["ref", "bfloat16"] - lg["ref", "float32"])),
                "port": f(abs(lg["port", "bfloat16"] - lg["port", "float32"])),
                "port-ref": f(abs(lg["port", "bfloat16"]
                                  - lg["ref", "bfloat16"]))}
    print(f"bf16 vs float32 logit gaps (layers, statistic): {gaps}")
    shallow, deep = gaps[2, "max"], gaps[24, "max"]
    assert max(shallow.values()) <= BF16_TOL, shallow
    for impl in ("ref", "port"):
        assert deep[impl] >= 10 * shallow[impl], (impl, shallow, deep)
    assert 0.5 <= deep["port"] / deep["ref"] <= 2.0, deep
    for stat in ("max", "mean"):
        g = gaps[24, stat]
        assert g["port-ref"] <= g["ref"], (stat, g)


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
def test_config_equals_reference_field_by_field(which):
    ref, got = {"CONFIG": (REF_CONFIG, CONFIG),
                "SMOKE": (REF_SMOKE, SMOKE)}[which]
    assert _fields(got) == _fields(ref)
    assert got.vocab_padded == ref.vocab_padded == (
        50304 if which == "CONFIG" else 512)
    assert got.hd == ref.hd and got.is_attention_free
    assert get_config("mamba2-130m") is CONFIG
    assert get_smoke_config("mamba2-130m") is SMOKE


def test_other_architectures_are_refused_not_unknown():
    """Every one of the reference's ten architectures is ported (the VLM
    paligemma-3b last), each config is the reference's by name, and only
    an id outside the ten is refused."""
    from repro.configs.registry import ARCHS as REF_ARCHS
    from repro.configs.registry import get_config as ref_get_config
    assert set(ARCHS) == set(REF_ARCHS) == set(PORTED) == {
        "mamba2-130m", "qwen2-1.5b", "stablelm-1.6b", "llama3-8b",
        "codeqwen1.5-7b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b",
        "zamba2-7b", "whisper-large-v3", "paligemma-3b"}
    for arch in ARCHS:
        assert get_config(arch).name == ref_get_config(arch).name
        assert get_smoke_config(arch).family.value == \
            ref_get_config(arch).family.value
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(KeyError):
        get_smoke_config("no-such-arch")


@pytest.mark.parametrize("family", [Family.VLM])
def test_registry_refuses_unported_families(family):
    """No family is refused any more: the VLM, the last one the registry
    refused, builds and makes its decode state, and a family the
    registry does not know raises."""
    cfg = get_smoke_config("paligemma-3b")
    assert cfg.family == family
    model = registry.init_params(cfg, 0, "cpu")
    state = registry.make_decode_state(cfg, 1, 8, device="cpu")
    assert state.cache.k.shape == (cfg.n_layers, 1, 8, 1, cfg.hd)
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    bad = SMOKE.scaled(family="no-such-family")
    with pytest.raises(ValueError, match="unknown family"):
        registry.init_params(bad, 0, "cpu")
    with pytest.raises(ValueError, match="unknown family"):
        registry.make_decode_state(bad, 1, 8, device="cpu")


def test_init_is_seeded_and_device_independent():
    a = registry.init_params(SMOKE, 7, "cpu")
    b = registry.init_params(SMOKE, 7, "cpu")
    c = registry.init_params(SMOKE, 8, "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    assert sa["embed"].shape == (SMOKE.vocab_padded, SMOKE.d_model)
    assert all(v.dtype == torch.float32 for v in sa.values())
