"""The port's hybrid family (zamba2-7b) against the reference.

Weights are made by the reference (``init_params``) and carried across
by ``repro_torch.models.convert.hybrid_from_reference``; token inputs
are drawn with numpy from a seed.  The port runs on the CPU, where its
kernels (B2 for the shared block's prefill attention, B3 for the SSD
within-chunk block, B4 for every norm) run their plain versions.
The test config, ``SMOKE`` at ``N_LAYERS = 7`` layers, has 3
super-blocks of 2 Mamba2 layers, so the shared block is applied twice,
and 1 trailing layer.  Tolerances:

* float32: the same float32 math in other summation orders, ``F32_TOL
  = 1e-4`` on outputs of order 1, as tests/test_torch_mamba2.py holds
  the SSM family;
* bfloat16: end to end by the accuracy rule the repo holds bf16 to at
  depth (chip_smoke's ``BF16_ACCURACY_RATIO``;
  tests/test_torch_mamba2.py::test_bf16_spread_grows_with_depth_like_reference):
  over prefill and 4 decode steps and 3 seeds, the port's bf16 logits
  lie as far from the reference's float32 ones as the reference's own
  bf16 logits do, within a factor of 2 in the mean.  The SSM tests'
  ``BF16_TOL = 4e-2`` between the two bf16 implementations does not
  hold here, because the reference's own bf16 is farther than that
  from its float32: one Mamba2 block of the test config fed the same bf16
  input departs from float32 by 0.071 in the reference and 0.096 in
  the port (0.059 from each other, while in float32 they agree to
  2.2e-6), and the 7-layer model's logits by up to 0.142 and 0.216 over
  6 seeds, as the residual stream grows to |x| ~ 10 (one bf16 ulp 2**-4).
  The decode-vs-teacher-forcing check on the port alone keeps 4e-2.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.zamba2_7b import CONFIG as REF_CONFIG
from repro.configs.zamba2_7b import SMOKE as REF_SMOKE
from repro.models import hybrid as ref_hybrid
from repro.models import registry as ref_registry
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.zamba2_7b import CONFIG, SMOKE
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm_fused
from repro_torch.kernels.ssd_scan import ssd_inner
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry
from repro_torch.models.convert import hybrid_from_reference
from repro_torch.models.hybrid import (HybridDecodeState, HybridLM,
                                       hybrid_apply, hybrid_layout)
from repro_torch.serve import Request, ServeConfig, ServeEngine

F32_TOL = 1e-4
BF16_TOL = 4e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
#: 3 super-blocks of 2 layers (2 shared-block applications), 1 trailing
N_LAYERS = 7


def _np(x):
    return np.asarray(x, np.float32)


def _tn(x: torch.Tensor):
    return x.float().numpy()


def _models(dtype, n_layers=N_LAYERS, seed=0):
    jd, td, _ = DTYPES[dtype]
    jc = REF_SMOKE.scaled(n_layers=n_layers, dtype=jd)
    tc = SMOKE.scaled(n_layers=n_layers, dtype=td)
    params = ref_registry.init_params(jc, seed)
    model = hybrid_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                  tc, device="cpu")
    return jc, tc, params, model


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
    assert got.hd == ref.hd and got.vocab_padded == ref.vocab_padded
    assert get_config("zamba2-7b") is CONFIG
    assert get_smoke_config("zamba2-7b") is SMOKE


@pytest.mark.parametrize("n_layers", [5, 7, 81])
def test_layout_matches_reference(n_layers):
    cfg = CONFIG.scaled(n_layers=n_layers)
    assert hybrid_layout(cfg) == ref_hybrid.hybrid_layout(
        REF_CONFIG.scaled(n_layers=n_layers))


def test_parameter_count_equals_reference():
    """zamba2-7b at full size: 6,751,130,832 parameters, counted on the
    reference's abstract init and on the port's module on the meta
    device."""
    shapes = jax.eval_shape(lambda: ref_registry.init_params(REF_CONFIG, 0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        shapes))
    model = HybridLM(CONFIG, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == 6751130832
    assert {p.device.type for p in model.parameters()} == {"meta"}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_matches_reference(dtype):
    jc, tc, params, model = _models(dtype)
    tol = DTYPES[dtype][2]
    toks = np.random.default_rng(2).integers(1, jc.vocab, (2, 20)) \
        .astype(np.int32)
    want, _ = ref_hybrid.hybrid_apply(params, jnp.asarray(toks), jc)
    got, aux = hybrid_apply(model, torch.from_numpy(toks), tc)
    assert float(aux) == 0.0 and got.dtype == tc.dtype
    np.testing.assert_allclose(_tn(got), _np(want), rtol=tol, atol=tol)
    got, _ = registry.train_forward(model, {"tokens": torch.from_numpy(toks)},
                                    tc)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=tol, atol=tol)


def _assert_states(st, st_ref, tol, seq, n_super, what):
    for got, want in ((st.mamba_main, st_ref.mamba_main),
                      (st.mamba_trailing, st_ref.mamba_trailing)):
        for a, b in zip(got, want):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(_tn(a), _np(b), rtol=tol, atol=tol,
                                       err_msg=what)
    # the shared block's cache: slot 0 unused, slots 1 .. n_super-1 filled
    for a, b in ((st.attn_cache.k, st_ref.attn_cache.k),
                 (st.attn_cache.v, st_ref.attn_cache.v)):
        assert tuple(a.shape) == b.shape and a.shape[0] == n_super
        assert not bool(a[0].any())
        np.testing.assert_allclose(_tn(a[1:, :, :seq]),
                                   _np(b[1:, :, :seq]), rtol=tol, atol=tol,
                                   err_msg=what)
    np.testing.assert_array_equal(st.attn_cache.length.numpy(),
                                  np.asarray(st_ref.attn_cache.length))


def test_prefill_and_decode_match_reference():
    """float32, end to end: prefill logits, the Mamba states and the
    shared block's cache slots, then 4 decode steps."""
    dtype = "float32"
    jc, tc, params, model = _models(dtype)
    tol = DTYPES[dtype][2]
    n_super, _, rem, n_apps = hybrid_layout(tc)
    assert (n_super, rem, n_apps) == (3, 1, 2)
    rng = np.random.default_rng(1)
    B, S, steps = 2, 12, 4
    toks = rng.integers(1, jc.vocab, (B, S)).astype(np.int32)
    st_ref = ref_registry.make_decode_state(jc, B, S + steps + 2)
    st = registry.make_decode_state(tc, B, S + steps + 2, device="cpu")
    assert isinstance(st, HybridDecodeState)
    counts = (flash_attention.launches, ssd_inner.launches,
              rmsnorm_fused.launches)
    lg_ref, st_ref = ref_registry.prefill(
        params, {"tokens": jnp.asarray(toks)}, jc, st_ref)
    lg, st = registry.prefill(model, {"tokens": torch.from_numpy(toks)}, tc,
                              st)
    assert (flash_attention.launches, ssd_inner.launches,
            rmsnorm_fused.launches) == counts       # plain versions
    assert lg.shape == (B, 1, tc.vocab_padded) and st.pos == S
    np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=tol, atol=tol)
    _assert_states(st, st_ref, tol, S, n_super, "after prefill")
    for t in range(steps):
        tok = rng.integers(1, jc.vocab, (B, 1)).astype(np.int32)
        lg_ref, st_ref = ref_registry.decode_step(params, jnp.asarray(tok),
                                                  jc, st_ref)
        lg, st = registry.decode_step(model, torch.from_numpy(tok), tc, st)
        np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=tol, atol=tol,
                                   err_msg=f"decode step {t}")
    assert st.pos == S + steps
    _assert_states(st, st_ref, tol, S + steps, n_super, "after decode")


def test_bf16_spread_like_reference():
    """The whole bf16 model, end to end: over prefill and 4 decode steps
    and 3 seeds, the port's bf16 logits lie as far from the reference's
    float32 logits as the reference's own bf16 logits do, within a
    factor of 2 either way in the mean (reading: 1.04 over 4 seeds; the
    largest gaps of single seeds part by 0.5-2.2); the float32 logits
    of both at ``F32_TOL``."""
    gaps = {"port": 0.0, "ref": 0.0}
    for seed in range(3):
        lg = {}
        for dtype in sorted(DTYPES):
            jc, tc, params, model = _models(dtype, seed=seed)
            rng = np.random.default_rng(seed + 1)
            B, S = 2, 12
            toks = rng.integers(1, jc.vocab, (B, S)).astype(np.int32)
            st_ref = ref_registry.make_decode_state(jc, B, S + 6)
            st = registry.make_decode_state(tc, B, S + 6, device="cpu")
            out_r, st_ref = ref_registry.prefill(
                params, {"tokens": jnp.asarray(toks)}, jc, st_ref)
            out_p, st = registry.prefill(
                model, {"tokens": torch.from_numpy(toks)}, tc, st)
            runs = [(_np(out_r), _tn(out_p))]
            for _ in range(4):
                tok = rng.integers(1, jc.vocab, (B, 1)).astype(np.int32)
                out_r, st_ref = ref_registry.decode_step(
                    params, jnp.asarray(tok), jc, st_ref)
                out_p, st = registry.decode_step(
                    model, torch.from_numpy(tok), tc, st)
                runs.append((_np(out_r), _tn(out_p)))
            lg[dtype] = np.stack([np.stack(r) for r in runs])
        f32 = lg["float32"][:, 0]
        gaps["ref"] += float(np.abs(lg["bfloat16"][:, 0] - f32).mean())
        gaps["port"] += float(np.abs(lg["bfloat16"][:, 1] - f32).mean())
        np.testing.assert_allclose(lg["float32"][:, 1], f32, rtol=F32_TOL,
                                   atol=F32_TOL)
    print(f"bf16 vs the reference's float32, mean over 3 seeds: {gaps}")
    assert 0.5 <= gaps["port"] / gaps["ref"] <= 2.0, gaps


def _oracle_script():
    """``scripts/hybrid_f64_oracle.py`` as a module."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "hybrid_f64_oracle.py")
    spec = importlib.util.spec_from_file_location("hybrid_f64_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the port's float32 gap to the float64 oracle, at each recorded point,
#: is at most this factor times the reference's (readings: 0.35-1.33
#: over the 32 points at d_model 256 and 1024; the logits 1.12 and 0.80)
ORACLE_FACTOR = 2.0
#: and each package's logits lie within this share of the largest logit
#: from the oracle's (readings 0.49e-3 to 0.92e-3)
ORACLE_LOGITS = 2e-3


def test_float32_drift_grows_with_width():
    """ROADMAP C11: the float32 gap of the hybrid at zamba2's depth of 14
    layers (2 super-blocks, 1 shared-block application, 2 trailing
    layers), head dim 128, is float32 rounding in both packages, held
    against a float64 oracle (the reference in float64 with jax x64, in
    a subprocess: ``scripts/hybrid_f64_oracle.py``).  At every recorded
    point (each Mamba2 layer's and the shared block's hidden state over
    2 x 256 tokens, and the logits) and at d_model 256 and 1024, the
    port's largest gap to the oracle is within ``ORACLE_FACTOR`` of the
    reference's.  Readings (logits): reference 1.262e-3 and 2.164e-3,
    port 1.419e-3 and 1.726e-3, on logits up to 1.541 and 3.554; a layer
    fed the oracle's input departs by 2e-6 to 1.8e-4 in both packages,
    and 14 layers grow that to 1e-2 of hidden states up to 19.  So the
    float32 logits of a correct implementation lie about 1e-3 of the
    largest logit from the exact ones, and chip_smoke holds phase 20's
    float32 logits (card against CPU) to ``LOGITS_F32_TOL`` (1e-3) times
    the largest logit, not to 1e-3 per element."""
    gaps = _oracle_script().gaps((256, 1024), local=False)
    for d_model, g in gaps.items():
        ref, port = g[("ref", "carried")], g[("port", "carried")]
        print(f"d_model {d_model}: " + ", ".join(
            f"{k} {ref[k]:.3e}/{port[k]:.3e}" for k in ref))
        for k in ref:
            assert port[k] <= ORACLE_FACTOR * ref[k], (d_model, k, ref[k],
                                                       port[k])
        scale = g[("scale", "")]["logits"]
        for gap in (ref["logits"], port["logits"]):
            assert gap <= ORACLE_LOGITS * max(1.0, scale), (d_model, gap,
                                                            scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_matches_teacher_forcing(dtype):
    """tests/test_decode_consistency.py, on the port alone."""
    tc = SMOKE.scaled(n_layers=N_LAYERS, dtype=DTYPES[dtype][1])
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


def test_init_is_seeded_and_allocated_on_the_device():
    a = registry.init_params(SMOKE, 7, "cpu")
    b = registry.init_params(SMOKE, 7, "cpu")
    c = registry.init_params(SMOKE, 8, "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["main.0.0.mamba.w_z"], sc["main.0.0.mamba.w_z"])
    assert all(v.dtype == torch.float32 for v in sa.values())
    # the reference's names: the converter's strict load accepts them
    assert {"shared.attn.wq", "shared.mlp.w_gate", "trailing.0.ln",
            "main.1.1.mamba.a_log", "lm_head"} <= set(sa)


PROMPTS = [[5, 17, 3, 99, 250, 7, 8], [11, 12], [300, 301, 302, 303, 1]]
NEW = [6, 4, 5]


@pytest.mark.parametrize("n_layers", [SMOKE.n_layers, N_LAYERS])
def test_greedy_tokens_match_reference_engine(n_layers):
    jc, tc, params, model = _models("float32", n_layers=n_layers)
    ref = RefServeEngine(jc, params, RefServeConfig(batch=4, max_len=32))
    got = ServeEngine(tc, model, ServeConfig(batch=4, max_len=32),
                      device="cpu")
    want = ref.run([RefRequest(prompt=list(p), max_new_tokens=n)
                    for p, n in zip(PROMPTS, NEW)])
    out = got.run([Request(prompt=list(p), max_new_tokens=n)
                   for p, n in zip(PROMPTS, NEW)])
    assert [r.out_tokens for r in out] == [r.out_tokens for r in want]
    assert [len(r.out_tokens) for r in out[:3]] == NEW


def test_launcher_serves_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "zamba2-7b", "--smoke", "--device",
                             "cpu", "--requests", "3", "--prompt-len", "9",
                             "--new-tokens", "5"])
    assert len(out) == 3 and all(len(r.out_tokens) == 5 for r in out)
    assert all(0 <= t < SMOKE.vocab for r in out for t in r.out_tokens)
    assert "[serve] zamba2-7b on cpu: 3 requests, 15 tokens" in \
        capsys.readouterr().out
