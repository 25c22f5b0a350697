"""The port's VLM family (paligemma-3b) against the reference.

Weights are made by the reference (``init_params``; its ``init_vlm`` is
``init_lm``), their norm gammas replaced by random values so that those
paths carry numbers, and carried across by ``repro_torch.models.convert.
dense_lm_from_reference``; the tokens and the stub patch embeddings
``[B, img_tokens, D]`` are drawn with numpy from a seed
(``standard_normal * 0.02``, as both launchers draw them).  The port
runs on the CPU, where the prefill's attention is the flash kernel B2's
plain version in its prefix-LM mode and every norm B4's plain version.
``SMOKE`` has 2 layers, 4 heads over one kv head of 16, and 8 image
tokens.  Tolerances:

* float32: the same float32 math in other summation orders, ``F32_TOL
  = 1e-4`` on logits of order 1, as the hybrid and enc-dec families;
* bfloat16: by the spread rule of tests/test_torch_hybrid.py: over
  prefill and 4 decode steps and 3 seeds, the port's bf16 logits lie as
  far from the reference's float32 ones as the reference's own bf16
  logits do, within a factor of 2 either way in the mean;
* decode against teacher forcing on the port alone: 4e-2, the repo's
  decode tolerance (tests/test_decode_consistency.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paligemma_3b import CONFIG as REF_CONFIG
from repro.configs.paligemma_3b import SMOKE as REF_SMOKE
from repro.models import registry as ref_registry
from repro.models import vlm as ref_vlm
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.paligemma_3b import CONFIG, SMOKE
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, registry
from repro_torch.models.convert import dense_lm_from_reference
from repro_torch.models.transformer import DenseLM, LMDecodeState, lm_apply
from repro_torch.models.vlm import vlm_apply
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import kv_bytes

F32_TOL = 1e-4
BF16_TOL = 4e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x, np.float32)


def _tn(x: torch.Tensor):
    return x.float().numpy()


def _models(dtype, seed=0):
    jd, td = DTYPES[dtype]
    jc, tc = REF_SMOKE.scaled(dtype=jd), SMOKE.scaled(dtype=td)
    host = jax.tree_util.tree_map(np.asarray,
                                  ref_registry.init_params(jc, seed))
    rng = np.random.default_rng(seed + 100)
    for name in ("ln1", "ln2"):
        host["blocks"][name] = (1 + 0.1 * rng.standard_normal(
            host["blocks"][name].shape)).astype(np.float32)
    host["ln_f"] = (1 + 0.1 * rng.standard_normal(host["ln_f"].shape)) \
        .astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, host)
    return jc, tc, params, dense_lm_from_reference(host, tc, device="cpu")


def _patches(rng, cfg, batch):
    return (rng.standard_normal((batch, cfg.img_tokens, cfg.d_model))
            * 0.02).astype(np.float32)


def _inputs(jc, seed, B=2, S=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, jc.vocab, (B, S)).astype(np.int32)
    return rng, toks, _patches(rng, jc, B)


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
    assert get_config("paligemma-3b") is CONFIG
    assert get_smoke_config("paligemma-3b") is SMOKE
    assert CONFIG.hd == 256 and CONFIG.img_tokens == 256


def test_parameter_count_equals_reference():
    """paligemma-3b at full size: 2,508,793,856 parameters (18 layers of
    110,104,576, the tied embedding at 257,280 x 2048 and the final
    norm), counted on the reference's abstract init and on the port's
    module on the meta device."""
    shapes = jax.eval_shape(lambda: ref_registry.init_params(REF_CONFIG, 0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        shapes))
    model = DenseLM(CONFIG, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == 2508793856
    assert "lm_head" not in dict(model.named_parameters())


def test_apply_matches_reference():
    """float32: ``vlm_apply`` over patches and tokens, every position,
    and ``train_forward``'s text positions.  The prefix-LM mask matters
    here: the same model with the plain causal mask departs by far more
    than the tolerance."""
    jc, tc, params, model = _models("float32")
    _, toks, patches = _inputs(jc, 2)
    want, _ = ref_vlm.vlm_apply(params, jnp.asarray(patches),
                                jnp.asarray(toks), jc)
    got, aux = vlm_apply(model, torch.from_numpy(patches),
                         torch.from_numpy(toks), tc)
    assert float(aux) == 0.0 and tuple(got.shape) == want.shape == (
        2, jc.img_tokens + 12, jc.vocab_padded)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)
    plain, _ = lm_apply(model, torch.from_numpy(toks), tc,
                        extra_embeds=torch.from_numpy(patches))
    assert float(np.abs(_tn(plain) - _np(want)).max()) > 100 * F32_TOL
    batch = {"tokens": toks, "patches": patches}
    want, _ = ref_registry.train_forward(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    got, _ = registry.train_forward(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, tc)
    assert tuple(got.shape) == want.shape == (2, 12, jc.vocab_padded)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_prefill_and_decode_match_reference(monkeypatch):
    """float32: the prefill's logits and K/V cache over the patches and
    the prompt, then 4 decode steps and the cache after them.  Every
    prefill attention is one B2 call in the prefix-LM mode, with the
    prefix at ``img_tokens``."""
    jc, tc, params, model = _models("float32")
    rng, toks, patches = _inputs(jc, 1)
    B, S, steps = 2, 12, 4
    P = jc.img_tokens
    prefixes = []
    real = attention.flash_attention

    def recording(*args, **kw):
        prefixes.append(kw.get("prefix_len"))
        return real(*args, **kw)

    monkeypatch.setattr(attention, "flash_attention", recording)
    st_ref = ref_registry.make_decode_state(jc, B, P + S + steps + 2)
    st = registry.make_decode_state(tc, B, P + S + steps + 2, device="cpu")
    assert isinstance(st, LMDecodeState)
    lg_ref, st_ref = ref_registry.prefill(
        params, {"tokens": jnp.asarray(toks),
                 "patches": jnp.asarray(patches)}, jc, st_ref)
    lg, st = registry.prefill(model, {"tokens": torch.from_numpy(toks),
                                      "patches": torch.from_numpy(patches)},
                              tc, st)
    assert prefixes == [P] * tc.n_layers
    assert lg.shape == (B, 1, tc.vocab_padded) and st.pos == P + S
    np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=F32_TOL,
                               atol=F32_TOL)
    for t in range(steps):
        tok = rng.integers(1, jc.vocab, (B, 1)).astype(np.int32)
        lg_ref, st_ref = ref_registry.decode_step(params, jnp.asarray(tok),
                                                  jc, st_ref)
        lg, st = registry.decode_step(model, torch.from_numpy(tok), tc, st)
        np.testing.assert_allclose(_tn(lg), _np(lg_ref), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"decode step {t}")
    assert st.pos == P + S + steps and prefixes == [P] * tc.n_layers
    n = P + S + steps
    for got, want in ((st.cache.k, st_ref.cache.k),
                      (st.cache.v, st_ref.cache.v)):
        np.testing.assert_allclose(_tn(got[:, :, :n]), _np(want[:, :, :n]),
                                   rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(st.cache.length.numpy(),
                                  np.asarray(st_ref.cache.length))


def test_bf16_spread_like_reference():
    """bf16 end to end: over prefill and 4 decode steps and 3 seeds, the
    port's bf16 logits lie as far from the reference's float32 logits as
    the reference's own bf16 logits do, within a factor of 2 either way
    in the mean; the float32 logits of both at ``F32_TOL``."""
    gaps = {"port": 0.0, "ref": 0.0}
    for seed in range(3):
        lg = {}
        for dtype in sorted(DTYPES):
            jc, tc, params, model = _models(dtype, seed=seed)
            rng, toks, patches = _inputs(jc, seed + 1)
            B, S = toks.shape
            max_len = jc.img_tokens + S + 6
            st_ref = ref_registry.make_decode_state(jc, B, max_len)
            st = registry.make_decode_state(tc, B, max_len, device="cpu")
            out_r, st_ref = ref_registry.prefill(
                params, {"tokens": jnp.asarray(toks),
                         "patches": jnp.asarray(patches)}, jc, st_ref)
            out_p, st = registry.prefill(
                model, {"tokens": torch.from_numpy(toks),
                        "patches": torch.from_numpy(patches)}, tc, st)
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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_matches_teacher_forcing(dtype):
    """tests/test_decode_consistency.py, on the port alone: the prefill
    over the patches and half the prompt, then decode steps, against the
    teacher-forced logits of the whole sequence."""
    tc = SMOKE.scaled(dtype=DTYPES[dtype][1])
    model = registry.init_params(tc, 0, "cpu")
    rng = np.random.default_rng(0)
    B, S = 2, 12
    toks = torch.from_numpy(rng.integers(1, tc.vocab, (B, S))
                            .astype(np.int32))
    patches = torch.from_numpy(_patches(rng, tc, B))
    full, _ = registry.train_forward(model, {"tokens": toks,
                                             "patches": patches}, tc)
    half = S // 2
    state = registry.make_decode_state(tc, B, tc.img_tokens + S + 2,
                                       device="cpu")
    lg, state = registry.prefill(model, {"tokens": toks[:, :half],
                                         "patches": patches}, tc, state)
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
    assert not torch.equal(sa["embed"], sc["embed"])
    assert all(v.dtype == torch.float32 for v in sa.values())
    assert {"blocks.1.attn.wq", "blocks.0.mlp.w_gate", "ln_f"} <= set(sa)
    assert "lm_head" not in sa                          # tied embeddings
    model = DenseLM(SMOKE, device="meta")
    assert {p.device.type for p in model.parameters()} == {"meta"}


PROMPTS = [[5, 17, 3, 99, 250, 7, 8], [11, 12], [300, 301, 302, 303, 1]]
NEW = [6, 4, 5]


def test_greedy_tokens_match_reference_engine():
    """Both engines serve the same weights and patches (one row per slot
    of the batch, fillers included) in float32: the greedy tokens are
    identical."""
    jc, tc, params, model = _models("float32")
    patches = _patches(np.random.default_rng(3), jc, 4)
    max_len = jc.img_tokens + 32
    ref = RefServeEngine(jc, params, RefServeConfig(batch=4, max_len=max_len))
    got = ServeEngine(tc, model, ServeConfig(batch=4, max_len=max_len),
                      device="cpu")
    want = ref.run([RefRequest(prompt=list(p), max_new_tokens=n)
                    for p, n in zip(PROMPTS, NEW)],
                   extra={"patches": jnp.asarray(patches)})
    out = got.run([Request(prompt=list(p), max_new_tokens=n)
                   for p, n in zip(PROMPTS, NEW)],
                  extra={"patches": patches})
    assert [r.out_tokens for r in out] == [r.out_tokens for r in want]
    assert [len(r.out_tokens) for r in out[:3]] == NEW


def test_launcher_draws_the_reference_inputs(capsys, monkeypatch):
    """The launcher serves paligemma's SMOKE on the CPU, with a
    ``max_len`` that holds the image tokens, and draws the prompts and
    then the patches from one generator, as the reference's launcher
    does: a seed gives both packages the same inputs."""
    seen = {}
    real = ServeEngine.run

    def recording(self, requests, **kw):
        seen["prompts"] = [list(r.prompt) for r in requests]
        seen["extra"], seen["max_len"] = kw["extra"], self.scfg.max_len
        return real(self, requests, **kw)

    monkeypatch.setattr(ServeEngine, "run", recording)
    out = launch_serve.main(["--arch", "paligemma-3b", "--smoke", "--device",
                             "cpu", "--requests", "3", "--prompt-len", "9",
                             "--new-tokens", "5", "--seed", "4"])
    assert len(out) == 3 and all(len(r.out_tokens) == 5 for r in out)
    assert all(0 <= t < SMOKE.vocab for r in out for t in r.out_tokens)
    assert "[serve] paligemma-3b on cpu: 3 requests, 15 tokens" in \
        capsys.readouterr().out
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(1, SMOKE.vocab, 9)) for _ in range(3)]
    patches = rng.standard_normal((3, SMOKE.img_tokens, SMOKE.d_model)) \
        .astype(np.float32) * 0.02
    assert seen["prompts"][:3] == prompts
    np.testing.assert_array_equal(seen["extra"]["patches"], patches)
    assert set(seen["extra"]) == {"patches"}
    assert seen["max_len"] == 9 + 5 + SMOKE.img_tokens + 8


def test_kv_bytes_count_as_the_reference_counts_them():
    """ROADMAP C10, kept for parity: both packages count K and V of the
    text tokens over all ``n_layers`` at head dim ``d_model // n_heads``
    (256 here, paligemma's own); the ``img_tokens`` image slots that each
    row's cache also holds are not counted."""
    jc, tc = REF_CONFIG, get_config("paligemma-3b")
    ref = RefServeEngine.__new__(RefServeEngine)
    ref.cfg = jc
    for prompt_tokens in (1, 8 * 512):
        assert kv_bytes(tc, prompt_tokens) == ref._kv_bytes(prompt_tokens)
    assert kv_bytes(tc, 1) == 2 * 18 * 1 * 256 * 2
