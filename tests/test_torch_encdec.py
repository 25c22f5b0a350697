"""The port's enc-dec family (whisper-large-v3) against the reference.

Weights are made by the reference (``init_params``) and carried across
by ``repro_torch.models.convert.encdec_from_reference``; tokens and
frames are drawn with numpy from a seed (frames as the launchers draw
them, ``standard_normal * 0.02``).  The port runs on the CPU, where its
kernels (B2 for the encoder's and the prefill's attention, B4 for every
norm) run their plain versions.  Two configs: whisper's ``SMOKE`` (2 +
2 layers, 16 frames) and tests/test_decode_consistency.py's ``encdec``
case (2 + 2 layers, d_model 48, 8 frames).  Tolerances:

* float32: the same float32 math in other summation orders, ``F32_TOL
  = 1e-4`` on outputs of order 1;
* bfloat16: the repo's decode tolerance, ``BF16_TOL = 4e-2``
  (tests/test_decode_consistency.py).

The KV-transfer byte count of both packages' serve engines (ROADMAP
C10, kept for parity) is held for both new archs at full size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.configs.whisper_large_v3 import CONFIG as REF_CONFIG
from repro.configs.whisper_large_v3 import SMOKE as REF_SMOKE
from repro.models import encdec as ref_encdec
from repro.models import registry as ref_registry
from repro.models.common import Family as RefFamily
from repro.models.common import ModelConfig as RefConfig
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.whisper_large_v3 import CONFIG, SMOKE
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry
from repro_torch.models.common import Family, ModelConfig
from repro_torch.models.convert import encdec_from_reference
from repro_torch.models.encdec import (EncDecLM, EncDecState, encdec_apply,
                                       encode)
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import kv_bytes

F32_TOL = 1e-4
BF16_TOL = 4e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
#: tests/test_decode_consistency.py CASES["encdec"]
ENCDEC_CASE = dict(n_layers=2, n_encoder_layers=2, d_model=48, n_heads=4,
                   n_kv_heads=4, d_ff=96, vocab=128, encoder_frames=8,
                   act="gelu", glu=False)
CONFIGS = ["smoke", "encdec_case"]


def _np(x):
    return np.asarray(x, np.float32)


def _tn(x: torch.Tensor):
    return x.float().numpy()


def _configs(name, dtype):
    jd, td, _ = DTYPES[dtype]
    if name == "smoke":
        return REF_SMOKE.scaled(dtype=jd), SMOKE.scaled(dtype=td)
    return (RefConfig(name="encdec", family=RefFamily.ENCDEC, remat=False,
                      dtype=jd, **ENCDEC_CASE),
            ModelConfig(name="encdec", family=Family.ENCDEC, remat=False,
                        dtype=td, **ENCDEC_CASE))


def _models(name, dtype, seed=0):
    jc, tc = _configs(name, dtype)
    params = ref_registry.init_params(jc, seed)
    model = encdec_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                  tc, device="cpu")
    return jc, tc, params, model


def _frames(rng, cfg, batch):
    return (rng.standard_normal((batch, cfg.encoder_frames, cfg.d_model))
            * 0.02).astype(np.float32)


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
    assert get_config("whisper-large-v3") is CONFIG
    assert get_smoke_config("whisper-large-v3") is SMOKE
    assert CONFIG.encoder_frames == 1504


def test_parameter_count_equals_reference():
    """whisper-large-v3 at full size: 1,603,176,960 parameters, counted
    on the reference's abstract init and on the port's module on the
    meta device."""
    shapes = jax.eval_shape(lambda: ref_registry.init_params(REF_CONFIG, 0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        shapes))
    model = EncDecLM(CONFIG, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == 1603176960


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_encode_and_apply_match_reference(name, dtype):
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(2)
    toks = rng.integers(1, jc.vocab, (2, 10)).astype(np.int32)
    frames = _frames(rng, jc, 2)
    want = ref_encdec.encode(params, jnp.asarray(frames), jc)
    got = encode(model, torch.from_numpy(frames), tc)
    assert got.dtype == tc.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_tn(got), _np(want), rtol=tol, atol=tol)
    want, _ = ref_encdec.encdec_apply(params, jnp.asarray(frames),
                                      jnp.asarray(toks), jc)
    got, aux = encdec_apply(model, torch.from_numpy(frames),
                            torch.from_numpy(toks), tc)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_tn(got), _np(want), rtol=tol, atol=tol)
    got, _ = registry.train_forward(
        model, {"tokens": torch.from_numpy(toks),
                "frames": torch.from_numpy(frames)}, tc)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_reference(name, dtype):
    """Prefill logits, the encoder states, the cross K/V and the self
    cache, then 4 decode steps and the cache after them."""
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(1)
    B, S, steps = 2, 12, 4
    toks = rng.integers(1, jc.vocab, (B, S)).astype(np.int32)
    frames = _frames(rng, jc, B)
    st_ref = ref_registry.make_decode_state(jc, B, S + steps + 2)
    st = registry.make_decode_state(tc, B, S + steps + 2, device="cpu")
    assert isinstance(st, EncDecState)
    lg_ref, st_ref = ref_registry.prefill(
        params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
        jc, st_ref)
    lg, st = registry.prefill(model, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(frames)},
                              tc, st)
    assert lg.shape == (B, 1, tc.vocab_padded) and st.pos == S
    np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=tol, atol=tol)
    for got, want in ((st.enc, st_ref.enc), (st.cross_k, st_ref.cross_k),
                      (st.cross_v, st_ref.cross_v)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_tn(got), _np(want), rtol=tol, atol=tol)
    for t in range(steps):
        tok = rng.integers(1, jc.vocab, (B, 1)).astype(np.int32)
        lg_ref, st_ref = ref_registry.decode_step(params, jnp.asarray(tok),
                                                  jc, st_ref)
        lg, st = registry.decode_step(model, torch.from_numpy(tok), tc, st)
        np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=tol, atol=tol,
                                   err_msg=f"decode step {t}")
    assert st.pos == S + steps
    n = S + steps
    for got, want in ((st.cache.k, st_ref.cache.k),
                      (st.cache.v, st_ref.cache.v)):
        np.testing.assert_allclose(_tn(got[:, :, :n]), _np(want[:, :, :n]),
                                   rtol=tol, atol=tol)
    np.testing.assert_array_equal(st.cache.length.numpy(),
                                  np.asarray(st_ref.cache.length))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_matches_teacher_forcing(dtype):
    """tests/test_decode_consistency.py's ``encdec`` case, on the port
    alone."""
    tc = _configs("encdec_case", dtype)[1]
    model = registry.init_params(tc, 0, "cpu")
    B, S = 2, 12
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, tc.vocab, (B, S))
                            .astype(np.int32))
    frames = torch.from_numpy(_frames(rng, tc, B))
    full, _ = registry.train_forward(model, {"tokens": toks,
                                             "frames": frames}, tc)
    half = S // 2
    state = registry.make_decode_state(tc, B, S + 2, device="cpu")
    lg, state = registry.prefill(model, {"tokens": toks[:, :half],
                                         "frames": frames}, tc, state)
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
    assert not torch.equal(sa["pos_enc"], sc["pos_enc"])
    assert all(v.dtype == torch.float32 for v in sa.values())
    assert {"enc_blocks.1.attn.wq", "dec_blocks.0.cross_attn.wv",
            "dec_blocks.1.ln_x", "enc_ln", "lm_head"} <= set(sa)
    model = EncDecLM(SMOKE, device="meta")
    assert {p.device.type for p in model.parameters()} == {"meta"}


PROMPTS = [[5, 17, 3, 99, 250, 7, 8], [11, 12], [300, 301, 302, 303, 1]]
NEW = [6, 4, 5]


@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_tokens_match_reference_engine(name):
    """Both engines serve the same weights and frames (one row per slot
    of the batch, fillers included) in float32: the greedy tokens are
    identical."""
    jc, tc, params, model = _models(name, "float32")
    frames = _frames(np.random.default_rng(3), jc, 4)
    prompts = [[t % jc.vocab for t in p] for p in PROMPTS]
    ref = RefServeEngine(jc, params, RefServeConfig(batch=4, max_len=32))
    got = ServeEngine(tc, model, ServeConfig(batch=4, max_len=32),
                      device="cpu")
    want = ref.run([RefRequest(prompt=list(p), max_new_tokens=n)
                    for p, n in zip(prompts, NEW)],
                   extra={"frames": jnp.asarray(frames)})
    out = got.run([Request(prompt=list(p), max_new_tokens=n)
                   for p, n in zip(prompts, NEW)], extra={"frames": frames})
    assert [r.out_tokens for r in out] == [r.out_tokens for r in want]
    assert [len(r.out_tokens) for r in out[:3]] == NEW


def test_launcher_serves_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "whisper-large-v3", "--smoke",
                             "--device", "cpu", "--requests", "3",
                             "--prompt-len", "9", "--new-tokens", "5"])
    assert len(out) == 3 and all(len(r.out_tokens) == 5 for r in out)
    assert all(0 <= t < SMOKE.vocab for r in out for t in r.out_tokens)
    assert "[serve] whisper-large-v3 on cpu: 3 requests, 15 tokens" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3"])
def test_kv_bytes_count_as_the_reference_counts_them(arch):
    """ROADMAP C10, kept for parity: both packages count K and V over all
    ``n_layers`` at head dim ``d_model // n_heads`` (zamba2: 81 layers,
    although 12 shared-block applications hold a cache; whisper: the
    decoder's self cache, without the cross K/V)."""
    jc, tc = ref_get_config(arch), get_config(arch)
    ref = RefServeEngine.__new__(RefServeEngine)
    ref.cfg = jc
    for prompt_tokens in (1, 8 * 512):
        want = ref._kv_bytes(prompt_tokens)
        assert kv_bytes(tc, prompt_tokens) == want
    per_token = 2 * tc.n_layers * tc.n_kv_heads * tc.hd * 2
    assert kv_bytes(tc, 1) == per_token
