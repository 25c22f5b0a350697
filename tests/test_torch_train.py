"""The port's training path against the reference's.

Inputs are made with numpy and handed to both packages; the model
weights are the reference's (``init_params``, with random QKV biases
and norm gammas so that those paths carry numbers), carried across by
``repro_torch.models.convert``.  Tolerances:

* loss at ``1e-5`` relative (float32 sums in other orders);
* each gradient within ``GRAD_TOL = 1e-4`` of its tensor's largest
  entry: the reference's gradient pytree, stacked ``[L, ...]``, is
  mapped to the port's parameter names by ``convert.dense_state_dict``;
* the sign rule for updated parameters: AdamW's first step moves a
  parameter by ``lr * g / (|g| + eps)``, about ``+-lr``, so a gradient at
  float32 noise may move it by ``+lr`` in one package and ``-lr`` in the
  other.  Updated parameters are compared only where ``|g_ref|`` exceeds
  ``SIGN_FLOOR = 1e-3`` of its tensor's largest ``|g_ref|`` (there the
  two gradients, within ``GRAD_TOL`` of each other, share a sign), at
  ``PARAM_TOL = 1e-6``;
* the optimizer on a random tree, 5 steps: ``1e-6`` relative;
* the plain backward of B2 and B4 against autograd of their plain
  forwards: float32 at ``1e-5``;
* bf16 gradients by the spread rule: the port's bf16 gradients lie as
  far from the reference's float32 gradients as the reference's own
  bf16 gradients do, within a factor of 2 either way in the mean.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.roofline import V5E
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import train as ref_launch
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.train import grad_comm as ref_grad_comm
from repro.train import optimizer as ref_opt
from repro_torch.analysis import HwSpec
from repro_torch.collectives.selector import ICICostModel, MeshSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import MAX_HEAD_DIM
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain, rmsnorm_plain
from repro_torch.launch import train as launch
from repro_torch.models import registry
from repro_torch.models import moe_parity
from repro_torch.models.convert import (dense_lm_from_reference,
                                        dense_state_dict,
                                        encdec_from_reference,
                                        encdec_state_dict,
                                        hybrid_from_reference,
                                        hybrid_state_dict,
                                        ssm_lm_from_reference,
                                        ssm_state_dict)
from repro_torch.models.encdec import encdec_apply
from repro_torch.models.transformer import DenseLM, lm_apply
from repro_torch.models.vlm import vlm_apply
from repro_torch.train import grad_comm
from repro_torch.train import optimizer as opt

# the packages' ``train`` exports a function named like the module
ref_ts = importlib.import_module("repro.train.train_step")
ts = importlib.import_module("repro_torch.train.train_step")

GRAD_TOL = 1e-4
SIGN_FLOOR = 1e-3
PARAM_TOL = 1e-6
OPT_RTOL = 1e-6
PLAIN_TOL = 1e-5
#: a short warm-up, so that the first step moves parameters by about lr
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: -A's range over the heads in the SSM and hybrid comparisons: the
#: reference's gradient is NaN once a chunk's decay exp(dA_i - dA_j)
#: overflows float32 above the diagonal, which its initial -A up to 16
#: reaches (ROADMAP C13; test_reference_ssd_gradient_overflows_where_the_
#: ports_stays_finite)
REF_A_RANGE = (0.5, 2.0)


def _np(x):
    return np.asarray(x, np.float32)


def _perturb_constants(tree: dict, rng) -> None:
    """Every leaf of ``tree`` that its initialiser made constant (norm
    gammas, conv biases, ``d_skip``, ``dt_bias``) gets random values
    around its constant, so that those paths carry numbers; ``a_log``
    becomes ``log(linspace(0.5, 2, H))`` (REF_A_RANGE), where the
    reference's gradient is finite (ROADMAP C13)."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _perturb_constants(leaf, rng)
        elif name == "a_log":
            tree[name] = np.broadcast_to(np.log(np.linspace(
                *REF_A_RANGE, leaf.shape[-1])), leaf.shape).astype(np.float32)
        elif np.ptp(leaf) == 0:
            tree[name] = (leaf + 0.1 * rng.standard_normal(leaf.shape)) \
                .astype(np.float32)


def _host_params(jc, seed=0):
    """Reference weights with random QKV biases, norm gammas and (in the
    Mamba2 layers) every other constant, as NumPy."""
    host = jax.tree_util.tree_map(np.asarray,
                                  ref_registry.init_params(jc, seed))
    rng = np.random.default_rng(seed + 100)
    if "blocks" not in host or "ln1" not in host["blocks"]:
        _perturb_constants(host, rng)     # the SSM and hybrid families
        return host
    blocks = host["blocks"]
    for name in ("bq", "bk", "bv"):
        if name in blocks["attn"]:       # the configs with QKV biases
            blocks["attn"][name] = rng.normal(
                0, 0.1, blocks["attn"][name].shape).astype(np.float32)
    for name in ("ln1", "ln2"):
        blocks[name] = (1 + 0.1 * rng.standard_normal(blocks[name].shape)) \
            .astype(np.float32)
    host["ln_f"] = (1 + 0.1 * rng.standard_normal(host["ln_f"].shape)) \
        .astype(np.float32)
    return host


#: each family's state dict of a reference tree, and its port model
CONVERT = {"qwen2-1.5b": (dense_state_dict, dense_lm_from_reference),
           "mamba2-130m": (ssm_state_dict, ssm_lm_from_reference),
           "zamba2-7b": (hybrid_state_dict, hybrid_from_reference),
           "paligemma-3b": (dense_state_dict, dense_lm_from_reference),
           "granite-moe-3b-a800m": (dense_state_dict,
                                    dense_lm_from_reference),
           "qwen2-moe-a2.7b": (dense_state_dict, dense_lm_from_reference),
           "whisper-large-v3": (encdec_state_dict, encdec_from_reference)}


def _state_dict(tree, tc) -> dict:
    """A reference tree (parameters or gradients) under the port's
    names, as NumPy."""
    return {k: v.numpy() for k, v in CONVERT[tc.name][0](tree, tc).items()}


def _port_model(host, tc):
    return CONVERT[tc.name][1](host, tc, device="cpu")


def _setup(dtype="float32", seed=0, batch=2, seq=16, arch="qwen2-1.5b"):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    # vocab 500: 12 padded rows (the smoke config's 512 has none)
    jc = ref_smoke(arch).scaled(dtype=jd, vocab=500)
    tc = get_smoke_config(arch).scaled(dtype=td, vocab=500)
    host = _host_params(jc, seed)
    rng = np.random.default_rng(seed + 7)
    toks = rng.integers(0, jc.vocab, (batch, seq + 1)).astype(np.int32)
    batch_np = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jc.img_tokens:       # the VLM's stub patch embeddings
        batch_np["patches"] = rng.standard_normal(
            (batch, jc.img_tokens, jc.d_model)).astype(np.float32)
    if jc.n_encoder_layers:   # the enc-dec family's stub conv output
        batch_np["frames"] = rng.standard_normal(
            (batch, jc.encoder_frames, jc.d_model)).astype(np.float32)
    return jc, tc, host, batch_np


def _ref_grads(jc, host, batch_np, tcfg):
    params = jax.tree_util.tree_map(jnp.asarray, host)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_ts._step_loss(p, b, jc, tcfg), has_aux=True))(
        params, batch)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _port_batch(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_loss_fn_matches_reference(z_loss):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 130)).astype(np.float32) * 3
    labels = rng.integers(0, 130, (2, 5)).astype(np.int32)
    want = float(ref_ts.loss_fn(jnp.asarray(logits), jnp.asarray(labels),
                                z_loss=z_loss))
    got = ts.loss_fn(torch.from_numpy(logits), torch.from_numpy(labels),
                     z_loss=z_loss)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=OPT_RTOL)
    # bf16 logits are read in float32, as the reference reads them
    got16 = ts.loss_fn(torch.from_numpy(logits).bfloat16(),
                       torch.from_numpy(labels), z_loss=z_loss)
    want16 = ref_ts.loss_fn(jnp.asarray(logits, jnp.bfloat16),
                            jnp.asarray(labels), z_loss=z_loss)
    np.testing.assert_allclose(float(got16), float(want16), rtol=OPT_RTOL)


# -------------------------------------------------------------- optimizer
def test_cosine_schedule_matches_reference():
    cfg = dict(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in range(0, 120, 3):
        want = float(ref_opt.cosine_schedule(ref_opt.AdamWConfig(**cfg),
                                             jnp.asarray(step)))
        got = opt.cosine_schedule(opt.AdamWConfig(**cfg), step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=OPT_RTOL)


def test_adamw_matches_reference_over_five_steps():
    """A random tree through 5 steps (the gradients of steps 1 and 3
    large enough to be clipped): parameters, moments, lr, gradient norm
    and the clipped gradients at 1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    ref_p = {"a": jnp.asarray(p_np["a"]),
             "n": {"b": jnp.asarray(p_np["b"]), "c": jnp.asarray(p_np["c"])}}
    port = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1,
               grad_clip_norm=1.0)
    ref_state, state = ref_opt.adamw_init(ref_p), opt.adamw_init(port)
    for step in range(5):
        scale = 3.0 if step in (1, 3) else 0.05
        g_np = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                for k, s in shapes.items()}
        ref_g = {"a": jnp.asarray(g_np["a"]),
                 "n": {"b": jnp.asarray(g_np["b"]),
                       "c": jnp.asarray(g_np["c"])}}
        clipped, ref_norm = ref_opt.clip_by_global_norm(ref_g, 1.0)
        mine, norm = opt.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in g_np.items()}, 1.0)
        np.testing.assert_allclose(float(norm), float(ref_norm),
                                   rtol=OPT_RTOL)
        for k, want in (("a", clipped["a"]), ("b", clipped["n"]["b"]),
                        ("c", clipped["n"]["c"])):
            np.testing.assert_allclose(mine[k].numpy(), _np(want),
                                       rtol=OPT_RTOL, atol=1e-9)
        ref_p, ref_state, ref_m = ref_opt.adamw_update(
            ref_opt.AdamWConfig(**cfg), ref_p, ref_g, ref_state)
        port, state, m = opt.adamw_update(
            opt.AdamWConfig(**cfg), port,
            {k: torch.from_numpy(v) for k, v in g_np.items()}, state)
        assert state.step == int(ref_state.step) == step + 1
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=OPT_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=OPT_RTOL)
        for k, path in (("a", ("a",)), ("b", ("n", "b")),
                        ("c", ("n", "c"))):
            want_p, want_m, want_v = ref_p, ref_state.m, ref_state.v
            for key in path:
                want_p, want_m, want_v = (want_p[key], want_m[key],
                                          want_v[key])
            for got, want in ((port[k], want_p), (state.m[k], want_m),
                              (state.v[k], want_v)):
                np.testing.assert_allclose(got.numpy(), _np(want),
                                           rtol=OPT_RTOL, atol=1e-9,
                                           err_msg=f"{k} step {step}")


# ------------------------------------------------------- plain backwards
@pytest.mark.parametrize("group,hd", [(1, 16), (3, 16), (6, 16), (8, 256)])
@pytest.mark.parametrize("causal,prefix_len", [(True, 0), (False, 0),
                                               (True, 7)])
def test_flash_bwd_plain_matches_autograd(causal, prefix_len, group, hd):
    """Head dim 256 with G = 8 over one kv head: paligemma-3b's
    geometry at a short sequence."""
    rng = np.random.default_rng(group)
    kv_heads = 1 if hd == 256 else 2
    q = torch.from_numpy(rng.standard_normal((2, kv_heads * group, 19, hd))
                         .astype(np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((2, kv_heads, 19, hd))
                             .astype(np.float32)).requires_grad_()
            for _ in range(2))
    o = flash_attention_plain(q, k, v, causal=causal, prefix_len=prefix_len)
    do = torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    o.detach(), do, causal=causal,
                                    prefix_len=prefix_len)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=PLAIN_TOL, atol=PLAIN_TOL)


@pytest.mark.parametrize("shape", [(4, 32), (2, 3, 100), (1, 1536)])
def test_rmsnorm_bwd_plain_matches_autograd(shape):
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .requires_grad_()
    gamma = torch.from_numpy((1 + 0.3 * rng.standard_normal(shape[-1]))
                             .astype(np.float32)).requires_grad_()
    y = rmsnorm_plain(x, gamma)
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    want = torch.autograd.grad(y, (x, gamma), dy)
    got = rmsnorm_bwd_plain(x.detach(), gamma.detach(), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=PLAIN_TOL, atol=PLAIN_TOL)


# ------------------------------------------------------------- train step
def _grad_gap(got: torch.Tensor, want) -> float:
    """Largest gap as a share of the reference gradient's largest entry."""
    want = _np(want)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _hold_updated(model, grads_ref: dict, before: dict, after_ref: dict):
    """The sign rule (module docstring); returns the share compared."""
    compared = total = 0
    for name, p in model.named_parameters():
        g = np.abs(grads_ref[name])
        keep = g > SIGN_FLOOR * g.max()
        np.testing.assert_allclose(p.detach().numpy()[keep],
                                   after_ref[name][keep], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
        assert not np.array_equal(p.detach().numpy(), before[name]), name
        compared += int(keep.sum())
        total += keep.size
    return compared / total


#: the families that train, by the smoke config of one of each
TRAINED_ARCHS = ["qwen2-1.5b", "mamba2-130m", "zamba2-7b", "paligemma-3b",
                 "granite-moe-3b-a800m", "qwen2-moe-a2.7b",
                 "whisper-large-v3"]


@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_train_step_matches_reference_value_and_grad(arch):
    """One float32 step of ``arch``'s smoke config from the same weights
    and batch: the loss, every gradient (the padded embedding rows
    included, tied to the head where the config ties them) and the
    updated parameters.  mamba2-130m's and zamba2-7b's gradients run
    through B3's backward (its plain version here) and the reference's
    through ``jax.grad`` of its plain SSD; paligemma-3b's through B2
    under the prefix-LM mask over its image positions, the head applied
    to the text positions only (``vlm_train_apply``), where the
    reference keeps the text positions of logits at every position.
    The MoE configs' loss adds ``router_aux_coef`` times the layers'
    load-balancing loss, and their gradients run through the dispatch
    and combine einsums to the router (qwen2-moe-a2.7b's shared experts
    too); whisper-large-v3's through the encoder, every decoder block's
    cross K/V and ``pos_enc`` (``encdec_train_apply``)."""
    jc, tc, host, batch_np = _setup(arch=arch)
    tcfg_ref = ref_ts.TrainConfig(optimizer=ref_opt.AdamWConfig(**OPT_CFG))
    tcfg = ts.TrainConfig(optimizer=opt.AdamWConfig(**OPT_CFG))
    loss_ref, grads_ref = _ref_grads(jc, host, batch_np, tcfg_ref)
    grads_ref = _state_dict(grads_ref, tc)
    model = _port_model(host, tc)
    loss, metrics, grads = ts.value_and_grad(model, _port_batch(batch_np),
                                             tc, tcfg)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)
    assert sorted(grads) == sorted(grads_ref)
    gaps = {k: _grad_gap(g, grads_ref[k]) for k, g in grads.items()}
    assert max(gaps.values()) <= GRAD_TOL, gaps
    pad = grads["embed"][tc.vocab:]
    assert pad.shape[0] == tc.vocab_padded - tc.vocab > 0
    if tc.tie_embeddings:
        assert float(pad.abs().max()) > 0   # the head reads those rows

    params = jax.tree_util.tree_map(jnp.asarray, host)
    new_ref, _, m_ref = jax.jit(lambda p, o, b: ref_ts.train_step(
        p, o, b, cfg=jc, tcfg=tcfg_ref))(
        params, ref_opt.adamw_init(params),
        {k: jnp.asarray(v) for k, v in batch_np.items()})
    after_ref = _state_dict(jax.tree_util.tree_map(np.asarray, new_ref), tc)
    before = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    model.weights()                      # a serving cache, to be dropped
    _, state, m = ts.train_step(model, opt.adamw_init(
        dict(model.named_parameters())), _port_batch(batch_np), cfg=tc,
        tcfg=tcfg)
    assert model._cw is None and state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_ref["grad_norm"]), rtol=1e-4)
    share = _hold_updated(model, grads_ref, before, after_ref)
    assert share > 0.5, share  # most embedding rows see only the head


def _ref_choices(jc, host, batch_np):
    """The reference's forward run eagerly, each router call recorded
    with ``jax.lax.top_k``'s choices: -> (aux, RouterTrace)."""
    trace, real = moe_parity.RouterTrace(), ref_moe.router_probs

    def hook(p, x, cfg):
        probs = real(p, x, cfg)
        trace.add(x, p["router"], probs, jax.lax.top_k(probs, cfg.top_k)[1])
        return probs

    ref_moe.router_probs = hook
    try:
        with jax.disable_jit():
            _, aux = ref_registry.train_forward(
                jax.tree_util.tree_map(jnp.asarray, host),
                {k: jnp.asarray(v) for k, v in batch_np.items()}, jc)
    finally:
        ref_moe.router_probs = real
    return float(aux), trace


def _ref_aux_router_grads(jc, host, batch_np) -> np.ndarray:
    """``jax.grad`` of the reference's summed aux loss alone, for the
    stacked router ``[L, D, E]``."""
    params = jax.tree_util.tree_map(jnp.asarray, host)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}

    def aux_of(router):
        p = dict(params, blocks=dict(params["blocks"], moe=dict(
            params["blocks"]["moe"], router=router)))
        return ref_registry.train_forward(p, batch, jc)[1]

    return np.asarray(jax.jit(jax.grad(aux_of))(
        params["blocks"]["moe"]["router"]))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_moe_aux_routing_and_router_gradient_match_reference(arch):
    """The MoE step's parts that the loss tolerance could hide
    (``router_aux_coef`` is 0.01): ``metrics["aux"]``, the sum over the
    layers of each layer's load-balancing loss, at rtol 1e-5 against
    the reference's (``_scan_blocks``' sum); the port's own expert
    choices, call for call, against ``jax.lax.top_k``'s (any flip held
    to ``moe_parity``'s tie rule); each layer's router gradient of the
    whole step within ``GRAD_TOL``; and the gradient of the aux loss
    alone, which reaches the router only through ``probs.mean``, within
    ``GRAD_TOL`` of ``jax.grad`` of the reference's aux."""
    jc, tc, host, batch_np = _setup(arch=arch)
    aux_ref, anchor = _ref_choices(jc, host, batch_np)
    assert len(anchor.calls) == tc.n_layers and aux_ref > 0
    tcfg_ref = ref_ts.TrainConfig(optimizer=ref_opt.AdamWConfig(**OPT_CFG))
    _, grads_ref = _ref_grads(jc, host, batch_np, tcfg_ref)
    grads_ref = _state_dict(grads_ref, tc)
    model = _port_model(host, tc)
    with moe_parity.recording(moe_parity.RouterTrace()) as own:
        _, metrics, grads = ts.value_and_grad(
            model, _port_batch(batch_np), tc,
            ts.TrainConfig(optimizer=opt.AdamWConfig(**OPT_CFG)))
    np.testing.assert_allclose(float(metrics["aux"]), aux_ref, rtol=1e-5)
    held = moe_parity.flips(own, anchor, tc.n_layers)
    assert held["calls"] == tc.n_layers and held["share"] <= 1.0, held
    routers = [f"blocks.{i}.moe.router" for i in range(tc.n_layers)]
    for name in routers:
        assert grads[name].dtype == torch.float32
        assert float(grads[name].abs().max()) > 0, name
        assert _grad_gap(grads[name], grads_ref[name]) <= GRAD_TOL, name

    want = _ref_aux_router_grads(jc, host, batch_np)
    _, aux = registry.train_forward(model, _port_batch(batch_np), tc)
    got = torch.autograd.grad(aux, [dict(model.named_parameters())[n]
                                    for n in routers])
    for i, g in enumerate(got):
        assert float(g.abs().max()) > 0
        assert _grad_gap(g, want[i]) <= GRAD_TOL, routers[i]


def test_reference_ssd_gradient_overflows_where_the_ports_stays_finite():
    """ROADMAP C13, the witness of REF_A_RANGE: at the initialiser's own
    -A (1 to 16 over the heads), a chunk's decay exp(dA_i - dA_j)
    overflows float32 above the diagonal, where the reference's
    ``jnp.where`` drops the value but not its gradient, so ``jax.grad``
    gives NaN.  The port's backward never differentiates that
    exponential (the plain version's explicit formulas; the kernel
    masks before it): the same step's gradients are finite, and the
    losses agree."""
    jc, tc, host, batch_np = _setup(arch="mamba2-130m")
    a_log = ref_registry.init_params(jc, 0)["blocks"]["mamba"]["a_log"]
    host["blocks"]["mamba"]["a_log"] = np.asarray(a_log)
    assert float(np.exp(host["blocks"]["mamba"]["a_log"]).max()) == \
        pytest.approx(16.0)
    tcfg_ref = ref_ts.TrainConfig(optimizer=ref_opt.AdamWConfig(**OPT_CFG))
    loss_ref, grads_ref = _ref_grads(jc, host, batch_np, tcfg_ref)
    assert any(np.isnan(g).any()
               for g in jax.tree_util.tree_leaves(grads_ref))
    model = _port_model(host, tc)
    loss, _, grads = ts.value_and_grad(
        model, _port_batch(batch_np), tc,
        ts.TrainConfig(optimizer=opt.AdamWConfig(**OPT_CFG)))
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_microbatch_matches_full_batch():
    """Two microbatches of 2 rows: float32 gradients summed over the
    splits and divided by 2 give the full batch's step (its loss, and
    its updated parameters under the sign rule)."""
    _, tc, host, batch_np = _setup(batch=4)
    tcfg = ts.TrainConfig(optimizer=opt.AdamWConfig(**OPT_CFG))
    full = dense_lm_from_reference(host, tc, device="cpu")
    micro = copy.deepcopy(full)
    _, _, grads = ts.value_and_grad(full, _port_batch(batch_np), tc, tcfg)
    before = {n: p.detach().numpy().copy()
              for n, p in full.named_parameters()}
    _, _, m_full = ts.train_step(full, opt.adamw_init(dict(
        full.named_parameters())), _port_batch(batch_np), cfg=tc, tcfg=tcfg)
    _, _, m_micro = ts.train_step(
        micro, opt.adamw_init(dict(micro.named_parameters())),
        _port_batch(batch_np), cfg=tc,
        tcfg=ts.TrainConfig(optimizer=tcfg.optimizer, microbatch=2))
    np.testing.assert_allclose(float(m_micro["loss"]), float(m_full["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m_micro["grad_norm"]),
                               float(m_full["grad_norm"]), rtol=1e-5)
    after = {n: p.detach().numpy() for n, p in full.named_parameters()}
    share = _hold_updated(micro, {k: g.numpy() for k, g in grads.items()},
                          before, after)
    assert share > 0.5, share


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m"])
def test_bf16_gradients_spread_like_reference(arch):
    """bf16 compute: over 2 seeds, the port's gradients lie as far from
    the reference's float32 gradients as the reference's own bf16
    gradients do, within a factor of 2 either way (the mean over the
    parameters of each one's mean gap over its largest entry).  The SSM
    family's run through B3's bf16 route and its backward (the plain
    versions here: float32 math on the bf16 inputs)."""
    gaps = {"port": 0.0, "ref": 0.0}
    for seed in range(2):
        grads = {}
        for dtype in ("float32", "bfloat16"):
            jc, tc, host, batch_np = _setup(dtype, seed=seed, arch=arch)
            tcfg_ref = ref_ts.TrainConfig()
            _, g_ref = _ref_grads(jc, host, batch_np, tcfg_ref)
            grads["ref", dtype] = _state_dict(g_ref, tc)
            model = _port_model(host, tc)
            _, _, g = ts.value_and_grad(model, _port_batch(batch_np), tc,
                                        ts.TrainConfig())
            grads["port", dtype] = {k: v.float().numpy()
                                    for k, v in g.items()}
        f32 = grads["ref", "float32"]
        for k, want in f32.items():
            assert _grad_gap(torch.from_numpy(grads["port", "float32"][k]),
                             want) <= GRAD_TOL, k
        for who in ("port", "ref"):
            gaps[who] += float(np.mean([
                np.abs(grads[who, "bfloat16"][k] - w).mean()
                / np.abs(w).max() for k, w in f32.items()]))
    print(f"{arch}: bf16 gradient gaps to the reference's float32: {gaps}")
    assert 0.5 <= gaps["port"] / gaps["ref"] <= 2.0, gaps


# ------------------------------------------------------------ train loop
def test_train_loop_loss_falls():
    history = []
    _, state, losses = launch.train_loop(
        get_smoke_config("qwen2-1.5b"), steps=30, batch=4, seq=32, seed=0,
        ckpt_dir=None, ckpt_every=0, lr=3e-3, device="cpu", log_every=100,
        history=history)
    assert state.step == 30 and len(losses) == len(history) == 30
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
    assert [h["loss"] for h in history] == losses


def _v5e_values() -> HwSpec:
    return HwSpec(**{f: getattr(V5E, f) for f in
                     ("name", "peak_flops", "hbm_bw", "ici_bw", "dcn_bw")})


def _ref_bucket_bytes(jc) -> list:
    """The reference launcher's bucket sizes for ``jc``'s parameters,
    from their shapes alone."""
    shapes = jax.eval_shape(lambda: ref_registry.init_params(jc, 0))
    leaves = jax.tree_util.tree_leaves(shapes)
    return [sum(int(np.prod(leaves[i].shape)) for i in b) * 2
            for b in ref_grad_comm.bucketize(
                shapes, ref_grad_comm.GradCommConfig().bucket_bytes)]


def _ref_modes(bucket_bytes: list, steps: int) -> list:
    engine, cost = ref_launch.make_comm_engine("app_aware")
    return [[m.name for m in ref_launch.decide_grad_schedule(
        engine, cost, bucket_bytes)] for _ in range(steps)]


def _ref_leaf_names(tree) -> list:
    return [".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_full_width_buckets_and_modes_match_reference():
    """qwen2-1.5b at full width, by shapes only (the port's model on the
    meta device): the same leaves, buckets and bytes as the reference,
    and Algorithm 1 decides the same modes over 30 steps given the same
    hardware figures."""
    named = dict(DenseLM(get_config("qwen2-1.5b"),
                         device="meta").named_parameters())
    jc = ref_config("qwen2-1.5b")
    shapes = jax.eval_shape(lambda: ref_registry.init_params(jc, 0))
    leaves = grad_comm.reference_leaves(named)
    assert [n for n, _ in leaves] == _ref_leaf_names(shapes)
    assert [sum(t.numel() for t in ts_) for _, ts_ in leaves] == [
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes)]
    want = _ref_bucket_bytes(jc)
    got = grad_comm.bucket_bytes_on_wire(named, grad_comm.GradCommConfig())
    assert got == want and len(got) > 10
    engine, _ = launch.make_comm_engine("app_aware")
    cost = ICICostModel(MeshSpec(n_pods=2, inner_chips=256),
                        hw=_v5e_values())
    modes = [[m.name for m in launch.decide_grad_schedule(engine, cost, got)]
             for _ in range(30)]
    assert modes == _ref_modes(want, 30)
    assert {"DIRECT", "HIERARCHICAL"} <= {m for step in modes for m in step}


def test_train_loop_decides_the_references_bucket_modes(monkeypatch):
    """``--comm-policy app_aware`` through ``train_loop``: the modes
    decided at every step for the smoke model's buckets are the
    reference launcher's, given the reference's hardware figures."""
    monkeypatch.setattr(launch, "ICICostModel",
                        lambda mesh: ICICostModel(mesh, hw=_v5e_values()))
    history = []
    launch.train_loop(get_smoke_config("qwen2-1.5b"), steps=6, batch=2,
                      seq=16, seed=0, ckpt_dir=None, ckpt_every=0, lr=1e-3,
                      comm_policy="app_aware", device="cpu", history=history)
    want = _ref_modes(_ref_bucket_bytes(ref_smoke("qwen2-1.5b")), 6)
    assert [h["modes"] for h in history] == want


# --------------------------------------------------------------- families
def _family_batch(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, 8)).astype(np.int32))}
    if cfg.name == "whisper-large-v3":
        batch["frames"] = torch.zeros(1, cfg.encoder_frames, cfg.d_model)
    if cfg.name == "paligemma-3b":
        batch["patches"] = torch.zeros(1, cfg.img_tokens, cfg.d_model)
    return batch


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b",
                                  "paligemma-3b", "granite-moe-3b-a800m",
                                  "whisper-large-v3"])
def test_ssm_and_hybrid_families_train(arch):
    """The SSM, hybrid, VLM, MoE and enc-dec families, whose every kernel
    (B3, B4 and, in all but the SSM family, B2) has a backward: frozen,
    the forward runs without gradients and gives the serving forward's
    logits (the VLM's at the text positions), the same values; with
    parameters that require a gradient ``train_forward`` gives
    differentiable logits, the same values, and the launcher trains two
    steps (the VLM's batches with their patches, the enc-dec family's
    with their frames; the MoE family's aux loss in its history)."""
    cfg = get_smoke_config(arch)
    model = registry.init_params(cfg, 0, "cpu")
    batch = _family_batch(cfg)
    frozen, _ = registry.train_forward(model, batch, cfg)
    assert not frozen.requires_grad
    if "patches" in batch:   # the serving forward's text positions
        served, _ = vlm_apply(model, batch["patches"], batch["tokens"], cfg)
        torch.testing.assert_close(frozen, served[:, cfg.img_tokens:],
                                   rtol=0, atol=0)
    elif "frames" in batch:
        served, _ = encdec_apply(model, batch["frames"], batch["tokens"],
                                 cfg)
        torch.testing.assert_close(frozen, served, rtol=0, atol=0)
    elif cfg.family.value == "moe":
        served, _ = lm_apply(model, batch["tokens"], cfg)
        torch.testing.assert_close(frozen, served, rtol=0, atol=0)
    for p in model.parameters():
        p.requires_grad_(True)
    logits, _ = registry.train_forward(model, batch, cfg)
    assert logits.requires_grad
    torch.testing.assert_close(logits.detach(), frozen, rtol=0, atol=0)
    history = []
    _, state, losses = launch.train_loop(
        cfg, steps=2, batch=1, seq=8, seed=0, ckpt_dir=None, ckpt_every=0,
        lr=1e-3, device="cpu", history=history)
    assert state.step == 2 and all(np.isfinite(losses))
    aux = [h["aux"] for h in history]   # the MoE family's load balancing
    assert all(a > 0 for a in aux) if cfg.n_experts else aux == [0.0, 0.0]


def test_paligemma_head_dim_is_named():
    """paligemma-3b's head dim, 256, is the largest B2 takes
    (``MAX_HEAD_DIM``): its backward takes every head dim its forward
    takes.  A head dim above it is refused by the forward's own check,
    naming it."""
    assert get_config("paligemma-3b").hd == MAX_HEAD_DIM == 256
    cfg = get_smoke_config("qwen2-1.5b").scaled(head_dim=MAX_HEAD_DIM + 8)
    model = registry.init_params(cfg, 0, "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    with pytest.raises(ValueError, match=f"head dim {MAX_HEAD_DIM + 8}"):
        registry.train_forward(model, _family_batch(cfg), cfg)


# -------------------------------------------------------------- grad comm
def _split_layers(tree: dict, n_layers: int) -> tuple:
    """A reference gradient tree with stacked ``blocks`` and the port's
    per-layer names for the same values."""
    ref = {"blocks": {"attn": {"wq": tree["wq"]}, "ln1": tree["ln1"]},
           "embed": tree["embed"]}
    port = {"embed": tree["embed"]}
    for i in range(n_layers):
        port[f"blocks.{i}.ln1"] = tree["ln1"][i]
        port[f"blocks.{i}.attn.wq"] = tree["wq"][i]
    return ref, port


def _ref_selector():
    from repro.collectives.selector import AppAwareSelector as RefSelector
    from repro.collectives.selector import ICICostModel as RefCostModel
    from repro.collectives.selector import MeshSpec as RefMeshSpec
    return RefSelector(RefCostModel(RefMeshSpec(n_pods=2, inner_chips=256)))


def _port_selector():
    from repro_torch.collectives.selector import AppAwareSelector
    return AppAwareSelector(ICICostModel(MeshSpec(n_pods=2, inner_chips=256),
                                         hw=_v5e_values()))


def _grad_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"wq": rng.standard_normal((3, 64, 96)).astype(np.float32) * 1e-2,
            "ln1": rng.standard_normal((3, 64)).astype(np.float32),
            "embed": rng.standard_normal((400, 64)).astype(np.float32)}


def test_grad_comm_buckets_compression_and_modes_match_reference():
    """Over per-layer port tensors and the reference's stacked leaves:
    the same buckets, the same error-feedback compression bit for bit,
    and Algorithm 1's modes per bucket over 5 steps."""
    ref_np, port_np = _split_layers(_grad_tree(0), 3)
    port = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in port_np.items()}
    ref = jax.tree_util.tree_map(jnp.asarray, ref_np)
    for bucket_bytes in (8 * 1024, 80 * 1024, 1 << 30):
        assert grad_comm.bucketize(port, bucket_bytes) == \
            ref_grad_comm.bucketize(ref, bucket_bytes)
    res = {k: torch.full_like(v, 1e-4) for k, v in port.items()}
    for k, v in port.items():
        got = grad_comm.compress_decompress(v, res[k])
        want = ref_grad_comm.compress_decompress(jnp.asarray(v.numpy()),
                                                 jnp.asarray(res[k].numpy()))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cfg = grad_comm.GradCommConfig(bucket_bytes=80 * 1024)
    ref_cfg = ref_grad_comm.GradCommConfig(bucket_bytes=80 * 1024)
    sel, ref_sel = _port_selector(), _ref_selector()
    for _ in range(5):
        got = grad_comm.select_bucket_modes(sel, port, cfg)
        want = ref_grad_comm.select_bucket_modes(ref_sel, ref, ref_cfg)
        assert [(b, m.name) for b, m in got] == \
            [(b, m.name) for b, m in want]


@pytest.fixture
def gloo_mesh():
    """A world of one on gloo, as a ``(pod, data)`` mesh of 1 x 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("pod", "data"))
    finally:
        dist.destroy_process_group()


def test_reduce_bucketed_matches_reference(gloo_mesh):
    """``reduce_bucketed`` over the port's all-reduce in a world of one
    against the reference's in a 1 x 1 mesh: the reduced gradients (the
    wire values) and the residuals bit for bit, over two steps of error
    feedback, and the same modes."""
    from repro.compat import make_mesh

    ref_np, port_np = _split_layers(_grad_tree(1), 3)
    port = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in port_np.items()}
    ref = jax.tree_util.tree_map(jnp.asarray, ref_np)
    ref_mesh = make_mesh((1, 1), ("pod", "data"))
    cfg = grad_comm.GradCommConfig(bucket_bytes=80 * 1024)
    ref_cfg = ref_grad_comm.GradCommConfig(bucket_bytes=80 * 1024)
    sel, ref_sel = _port_selector(), _ref_selector()
    res = ref_res = None
    for _ in range(2):
        got, res, modes = grad_comm.reduce_bucketed(port, gloo_mesh, sel,
                                                    cfg, res)
        want, ref_res, ref_modes = ref_grad_comm.reduce_bucketed(
            ref, ref_mesh, ref_sel, ref_cfg, ref_res)
        assert [m.name for _, m in modes] == [m.name for _, m in ref_modes]
        _, want_port = _split_layers(
            {"wq": np.asarray(want["blocks"]["attn"]["wq"]),
             "ln1": np.asarray(want["blocks"]["ln1"]),
             "embed": np.asarray(want["embed"])}, 3)
        _, res_port = _split_layers(
            {"wq": np.asarray(ref_res["blocks"]["attn"]["wq"]),
             "ln1": np.asarray(ref_res["blocks"]["ln1"]),
             "embed": np.asarray(ref_res["embed"])}, 3)
        for k in port:
            np.testing.assert_array_equal(got[k].numpy(), want_port[k])
            np.testing.assert_array_equal(res[k].numpy(), res_port[k])
