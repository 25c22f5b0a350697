"""The port's ServeEngine and serve launcher against the reference's.

Both engines serve the same reference-made weights (carried across by
``repro_torch.models.convert``) in float32, where the greedy tokens
must be identical; the prompts have unequal lengths, so left-padding
with token 0 and filler requests are exercised.  Every case runs for
the SMOKE configs of mamba2-130m (SSM family) and qwen2-1.5b (dense
family, whose prefill runs the flash kernel's plain version here).
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models import registry as ref_registry
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.common import Family
from repro_torch.models.convert import (dense_lm_from_reference,
                                        ssm_lm_from_reference)
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import (next_tokens, route_kv_transfer,
                                      sampling_probs)

PROMPTS = [[5, 17, 3, 99, 250, 7, 8], [11, 12], [300, 301, 302, 303, 1]]
NEW = [6, 4, 5]
ARCHS = ["mamba2-130m", "qwen2-1.5b"]


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    jc = ref_smoke_config(request.param).scaled(dtype=jnp.float32)
    tc = get_smoke_config(request.param).scaled(dtype=torch.float32)
    params = ref_registry.init_params(jc, 0)
    convert = (dense_lm_from_reference if tc.family == Family.DENSE
               else ssm_lm_from_reference)
    model = convert(jax.tree_util.tree_map(np.asarray, params), tc,
                    device="cpu")
    return jc, tc, params, model


def _serve_both(weights, eos_id=-1):
    jc, tc, params, model = weights
    ref = RefServeEngine(jc, params, RefServeConfig(batch=4, max_len=32,
                                                    eos_id=eos_id))
    got = ServeEngine(tc, model, ServeConfig(batch=4, max_len=32,
                                             eos_id=eos_id), device="cpu")
    want = ref.run([RefRequest(prompt=list(p), max_new_tokens=n)
                    for p, n in zip(PROMPTS, NEW)])
    out = got.run([Request(prompt=list(p), max_new_tokens=n)
                   for p, n in zip(PROMPTS, NEW)])
    return want, out


def test_greedy_tokens_match_reference_engine(weights):
    want, out = _serve_both(weights)
    assert len(out) == len(want) == 4           # one filler request
    assert out[3].prompt == [0] and out[3].out_tokens == []
    assert [r.out_tokens for r in out] == [r.out_tokens for r in want]
    assert [len(r.out_tokens) for r in out[:3]] == NEW


def test_eos_stops_like_the_reference(weights):
    free, _ = _serve_both(weights)
    eos = free[1].out_tokens[1]
    want, out = _serve_both(weights, eos_id=eos)
    assert [r.out_tokens for r in out] == [r.out_tokens for r in want]
    assert out[1].out_tokens[-1] == eos and len(out[1].out_tokens) == 2


def test_sampling_is_seeded(weights):
    _, tc, _, model = weights
    eng = ServeEngine(tc, model, ServeConfig(batch=2, max_len=32),
                      device="cpu")

    def run(seed):
        reqs = [Request(prompt=[1, 2, 3], max_new_tokens=6, temperature=0.8)
                for _ in range(2)]
        return [r.out_tokens for r in eng.run(reqs, seed=seed)]

    a, b = run(3), run(3)
    assert a == b
    assert all(0 <= t < tc.vocab for toks in a for t in toks)


def _reference_probs(lg: np.ndarray, temperature: float) -> np.ndarray:
    """The distribution the reference step draws from:
    ``jax.random.categorical(rng, lg / max(T, 1e-6))``."""
    return np.asarray(jax.nn.softmax(
        jnp.asarray(lg) / jnp.maximum(jnp.float32(temperature), 1e-6),
        axis=-1))


@pytest.mark.parametrize("temperature", [0.3, 0.8, 1.5])
def test_sampling_probs_match_the_reference(temperature):
    """Temperature scaling and softmax over the unpadded vocabulary, on
    the same numpy-seeded float32 logits, at rtol 1e-6."""
    rng = np.random.default_rng(21)
    lg = (2.0 * rng.standard_normal((4, 97))).astype(np.float32)
    got = sampling_probs(torch.from_numpy(lg), temperature)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _reference_probs(lg, temperature),
                               rtol=1e-6, atol=0.0)


def test_sampled_frequencies_follow_the_reference_probs():
    """20,000 seeded draws over 16 categories: each frequency within 5
    standard errors of the reference's probability.  The seed is fixed,
    so the outcome is fixed."""
    n, temperature = 20_000, 0.8
    rng = np.random.default_rng(22)
    lg = rng.standard_normal(16).astype(np.float32)
    p = _reference_probs(lg, temperature).astype(np.float64)
    gen = torch.Generator().manual_seed(5)
    toks = next_tokens(torch.from_numpy(np.tile(lg, (n, 1))), temperature,
                       gen)
    assert toks.dtype == torch.int32 and toks.shape == (n,)
    freq = np.bincount(toks.numpy(), minlength=16) / n
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 5 * se), np.abs(freq - p) / se


def test_temperature_zero_is_greedy():
    rng = np.random.default_rng(23)
    lg = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    got = next_tokens(lg, 0.0, torch.Generator().manual_seed(0))
    assert got.tolist() == torch.argmax(lg, dim=-1).tolist()


def test_comm_policy_is_refused(weights):
    _, tc, _, model = weights
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tc, model, ServeConfig(comm_policy="app_aware"),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tc, model, ServeConfig(), comm_engine=object(),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        route_kv_transfer(None, None, 1024)


def test_no_cuda_means_no_serving(weights, monkeypatch):
    _, tc, _, model = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tc, model, ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", tc.name, "--smoke"])


def test_model_on_another_device_is_refused(weights):
    _, tc, _, model = weights
    with pytest.raises(ValueError):
        ServeEngine(tc, model.to("meta"), ServeConfig(), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_the_cpu(capsys, arch):
    out = launch_serve.main(["--arch", arch, "--smoke", "--device",
                             "cpu", "--requests", "3", "--prompt-len", "9",
                             "--new-tokens", "5"])
    assert len(out) == 3
    assert all(len(r.out_tokens) == 5 for r in out)
    vocab = get_smoke_config(arch).vocab
    assert all(0 <= t < vocab for r in out for t in r.out_tokens)
    assert f"[serve] {arch} on cpu: 3 requests, 15 tokens" in \
        capsys.readouterr().out


def test_launcher_refuses_unported_architectures():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch_serve.main(["--arch", "zamba2-7b", "--smoke", "--device",
                           "cpu"])
