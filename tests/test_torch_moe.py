"""The port's MoE family (granite-moe-3b-a800m, qwen2-moe-a2.7b) against
the reference.

Weights are made by the reference (``init_params``/``init_moe``), its
norm gammas and QKV biases replaced by random values, and carried across
by ``repro_torch.models.convert``; inputs are drawn with numpy.
Tolerances:

* the router's probabilities: float32 softmax of float32 products in
  other summation orders, ``PROB_TOL = 1e-6``;
* ``topk_dispatch``: exact (the same float32 operations in the same
  order on the same probabilities);
* float32 layers and logits: ``F32_TOL = 1e-5``, and bf16: ``BF16_TOL =
  4e-2`` at the smoke depth, as tests/test_torch_transformer.py holds
  the dense family.

Whole models are compared anchored (:mod:`repro_torch.models.
moe_parity`): the reference runs eagerly (``jax.disable_jit``) with its
router calls recorded, the port runs with the reference's expert
choices, and every choice of the port's own that differs is held to the
tie rule.  In bf16 the port's norm rounds once where the reference's
rounds twice, so a token whose k-th and (k+1)-th router logits nearly
tie can pick another expert (the smoke models show one or two such
flips, at 0.06-0.13 of the rule's bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_configs
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe, moe_parity, registry, transformer
from repro_torch.models.common import Family
from repro_torch.models.convert import (dense_lm_from_reference,
                                        dense_state_dict)

PROB_TOL = 1e-6
F32_TOL = 1e-5
BF16_TOL = 4e-2

DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}

MOE_ARCHS = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"]


def _configs(name, dtype):
    jd, td, _ = DTYPES[dtype]
    return (ref_configs.get_smoke_config(name).scaled(dtype=jd),
            get_smoke_config(name).scaled(dtype=td))


def _np(x):
    return np.asarray(x, np.float32)


def _close(got: torch.Tensor, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol, err_msg=msg)


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


def _ref_layer(params, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], params["blocks"]["moe"])


def _tokens_x(jc, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (jc.d_model,)).astype(np.float32)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_router_probs_match_reference(name):
    jc, tc, params, model = _models(name, "float32")
    x = _tokens_x(jc, (37,), 1)
    want = ref_moe.router_probs(_ref_layer(params), jnp.asarray(x), jc)
    got = moe.router_probs(model.weights()["blocks"][0]["moe"],
                           torch.from_numpy(x), tc)
    assert got.dtype == torch.float32
    _close(got, want, PROB_TOL)


@pytest.mark.parametrize("capacity", [3, 24])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_topk_dispatch_matches_reference_exactly(name, capacity):
    """On the reference's probabilities: dispatch and combine equal to the
    bit (capacity 3 drops tokens, 24, a group's length, none), aux at
    PROB_TOL."""
    jc, tc, params, _ = _models(name, "float32")
    x = _tokens_x(jc, (2, 24), 2)
    probs = np.array(ref_moe.router_probs(
        _ref_layer(params), jnp.asarray(x.reshape(48, -1)), jc)) \
        .reshape(2, 24, jc.n_experts)
    d_ref, c_ref, aux_ref = ref_moe.topk_dispatch(jnp.asarray(probs), jc,
                                                  capacity)
    disp, comb, aux = moe.topk_dispatch(torch.from_numpy(probs), tc,
                                        capacity)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(c_ref))
    _close(aux, aux_ref, PROB_TOL)
    kept = disp.sum().item()
    assert (kept < 2 * 24 * tc.top_k) == (capacity == 3)


def test_topk_orders_ties_like_reference():
    """Equal probabilities: the lower expert index comes first, as
    ``jax.lax.top_k`` puts it; the dispatch of a row of ties is equal to
    the reference's."""
    row = np.array([0.1, 0.2, 0.2, 0.05, 0.2, 0.2, 0.05, 0.0],
                   np.float32)
    probs = np.stack([row, np.full(8, 0.125, np.float32)])[None]
    for k in (1, 2, 3, 5):
        v_ref, i_ref = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = moe.topk(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    assert moe.topk(torch.from_numpy(probs), 3)[1][0, 0].tolist() == [1, 2, 4]
    assert moe.topk(torch.from_numpy(probs), 3)[1][0, 1].tolist() == [0, 1, 2]
    jc, tc = _configs("granite-moe-3b-a800m", "float32")
    jc, tc = jc.scaled(top_k=3), tc.scaled(top_k=3)
    tied = np.repeat(probs, 3, axis=1)           # 6 tokens, capacity 2
    d_ref, c_ref, _ = ref_moe.topk_dispatch(jnp.asarray(tied), jc, 2)
    disp, comb, _ = moe.topk_dispatch(torch.from_numpy(tied), tc, 2)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_einsum_matches_reference(name, dtype):
    """Two groups of MOE_GROUP tokens and a ragged batch of 15 (one
    group), y and aux."""
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    w = model.weights()["blocks"][0]["moe"]
    for shape, seed in (((2, moe.MOE_GROUP), 3), ((3, 5), 4)):
        x = _tokens_x(jc, shape, seed)
        y_ref, aux_ref = ref_moe.moe_einsum(_ref_layer(params),
                                            jnp.asarray(x, jc.dtype), jc)
        y, aux = moe.moe_einsum(w, torch.from_numpy(x).to(tc.dtype), tc)
        assert y.dtype == tc.dtype and aux.dtype == torch.float32
        _close(y, y_ref, tol, f"y at {shape}")
        _close(aux, aux_ref, tol, f"aux at {shape}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_block_forward_matches_reference(name, dtype):
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    x = _tokens_x(jc, (2, 11), 6)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    y_ref, (k_ref, v_ref, aux_ref) = ref_tf.block_forward(
        jax.tree_util.tree_map(lambda a: a[0], params["blocks"]),
        jnp.asarray(x, jc.dtype), jc, jnp.asarray(pos))
    y, (k, v, aux) = transformer.block_forward(
        model.weights()["blocks"][0], torch.from_numpy(x).to(tc.dtype), tc,
        torch.from_numpy(pos))
    for got, want in ((y, y_ref), (k, k_ref), (v, v_ref), (aux, aux_ref)):
        _close(got, want, tol)
    with pytest.raises(ValueError, match="mesh"):
        transformer.block_forward(model.weights()["blocks"][0],
                                  torch.from_numpy(x).to(tc.dtype),
                                  tc.scaled(moe_impl="ep"),
                                  torch.from_numpy(pos))


#: every MoE arch in float32 and in bf16, at its smoke depth of 2 layers
LM_CASES = [(n, d) for n in MOE_ARCHS for d in sorted(DTYPES)]


def _ref_traced(fn):
    """``fn()`` of the reference run eagerly, its router calls recorded
    (with ``jax.lax.top_k``'s choices) in a RouterTrace."""
    trace, real = moe_parity.RouterTrace(), ref_moe.router_probs

    def hook(p, x, cfg):
        probs = real(p, x, cfg)
        trace.add(x, p["router"], probs, jax.lax.top_k(probs, cfg.top_k)[1])
        return probs

    ref_moe.router_probs = hook
    try:
        with jax.disable_jit():
            return fn(), trace
    finally:
        ref_moe.router_probs = real


def _held(own, anchor, tc):
    """Every router call compared; each flip within the tie rule."""
    got = moe_parity.flips(own, anchor, tc.n_layers)
    assert got["calls"] == len(anchor.calls) > 0
    assert got["share"] <= 1.0, got
    return got


@pytest.mark.parametrize("name,dtype", LM_CASES)
def test_lm_apply_matches_reference(name, dtype):
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    toks = np.random.default_rng(7).integers(1, jc.vocab, (2, 10)) \
        .astype(np.int32)
    (want, aux_ref), anchor = _ref_traced(lambda: ref_registry.train_forward(
        params, {"tokens": jnp.asarray(toks)}, jc))
    with moe_parity.anchored(anchor, moe_parity.RouterTrace()) as own:
        got, aux = registry.train_forward(
            model, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (2, 10, tc.vocab_padded)
    _close(got, want, tol)
    _close(aux, aux_ref, tol)
    _held(own, anchor, tc)


@pytest.mark.parametrize("name,dtype", LM_CASES)
def test_prefill_and_decode_match_reference(name, dtype):
    jc, tc, params, model = _models(name, dtype)
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(8)
    bsz, seq = 2, 12
    toks = rng.integers(1, jc.vocab, (bsz, seq)).astype(np.int32)
    steps = [rng.integers(1, jc.vocab, (bsz, 1)).astype(np.int32)
             for _ in range(3)]

    def ref_run():
        st = ref_registry.make_decode_state(jc, bsz, seq + 4)
        lg, st = ref_registry.prefill(params, {"tokens": jnp.asarray(toks)},
                                      jc, st)
        out = [lg]
        for tok in steps:
            lg, st = ref_registry.decode_step(params, jnp.asarray(tok), jc,
                                              st)
            out.append(lg)
        return out, int(st.pos)

    (want, pos_ref), anchor = _ref_traced(ref_run)
    st = registry.make_decode_state(tc, bsz, seq + 4, device="cpu")
    with moe_parity.anchored(anchor, moe_parity.RouterTrace()) as own:
        lg, st = registry.prefill(model, {"tokens": torch.from_numpy(toks)},
                                  tc, st)
        assert lg.shape == (bsz, 1, tc.vocab_padded) and st.pos == seq
        _close(lg, want[0], tol)
        for t, tok in enumerate(steps):
            lg, st = registry.decode_step(model, torch.from_numpy(tok), tc,
                                          st)
            _close(lg, want[t + 1], tol, f"decode step {t}")
    assert st.pos == seq + 3 == pos_ref
    assert _held(own, anchor, tc)["calls"] == 4 * tc.n_layers


def test_tie_rule_admits_only_near_ties():
    """The rule's witness: a run whose router input is rounded to bf16
    flips only where the anchor's margin is within the bound, and a run
    with another router (so other choices at any margin) is refused."""
    jc, tc, params, model = _models("granite-moe-3b-a800m", "float32")
    toks = np.random.default_rng(9).integers(1, jc.vocab, (4, 16)) \
        .astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    with moe_parity.recording(moe_parity.RouterTrace()) as anchor:
        registry.train_forward(model, batch, tc)
    with moe_parity.anchored(anchor, moe_parity.RouterTrace()) as same:
        registry.train_forward(model, batch, tc)
    assert moe_parity.flips(same, anchor, tc.n_layers)["n"] == 0
    other = registry.init_params(tc, 1, "cpu")
    with moe_parity.anchored(anchor, moe_parity.RouterTrace()) as far:
        registry.train_forward(other, batch, tc)
    got = moe_parity.flips(far, anchor, tc.n_layers)
    assert got["n"] > 0 and got["share"] > 1.0


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
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_config_equals_reference_field_by_field(name, which):
    ref = (ref_configs.get_config if which == "CONFIG"
           else ref_configs.get_smoke_config)(name)
    got = (get_config if which == "CONFIG" else get_smoke_config)(name)
    assert _fields(got) == _fields(ref)
    assert got.vocab_padded == ref.vocab_padded and got.hd == ref.hd
    assert got.family == Family.MOE


@pytest.mark.parametrize("name,count", [("granite-moe-3b-a800m",
                                         3_298_985_472),
                                        ("qwen2-moe-a2.7b", 14_315_735_040)])
def test_parameter_count(name, count):
    """The reference's count (``jax.eval_shape`` of ``init_params``),
    from the shapes: the full model is built only on the card."""
    with torch.device("meta"):
        model = transformer.DenseLM(get_config(name))
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_init_lays_out_weights_like_reference(name):
    jc, tc = _configs(name, "float32")
    ref = dense_state_dict(_host_params(jc), tc)
    a = registry.init_params(tc, 7, "cpu")
    b = registry.init_params(tc, 7, "cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert {k: tuple(v.shape) for k, v in sa.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for key, v in sa.items():
        assert v.dtype == ref[key].dtype == torch.float32, key
        name = key.split(".")[-1]
        if name in ("w_in", "w_gate", "w_out") and ".moe." in key \
                and ".shared." not in key:
            assert 0.8 < float(v.std()) * v.shape[1] ** 0.5 < 1.2, key
        elif name == "router":
            assert 0.8 < float(v.std()) * v.shape[0] ** 0.5 < 1.2, key


def test_router_stays_float32_in_bf16_masters():
    """``_cast`` and the conversion keep the router in float32 whatever
    ``param_dtype`` is, as the reference's ``x.astype(float32) @ router``
    needs."""
    jc, tc = _configs("granite-moe-3b-a800m", "bfloat16")
    tc = tc.scaled(param_dtype=torch.bfloat16)
    sd = dense_state_dict(_host_params(jc), tc)
    assert sd["blocks.0.moe.router"].dtype == torch.float32
    assert sd["blocks.0.moe.w_in"].dtype == torch.bfloat16
    model = registry.init_params(tc, 0, "cpu")
    w = model.weights()["blocks"][0]["moe"]
    assert w["router"].dtype == torch.float32
    assert w["w_in_gate"].dtype == w["w_out"].dtype == torch.bfloat16
