"""The port's activation recomputation (``models.common.checkpoint_wrap``)
against the reference's (``jax.checkpoint`` in its ``checkpoint_wrap``).

Every trained family at its smoke config, float32, from the reference's
weights (``test_torch_train``'s helpers):

* with ``remat=True`` under each policy ("full", "dots") the port's loss
  and gradients match ``jax.value_and_grad`` of the reference with the
  same fields, loss at ``1e-5`` relative, each gradient within
  ``GRAD_TOL`` of its tensor's largest entry;
* the port with remat on equals the port with it off, loss and every
  gradient bit for bit: recomputation changes what a step keeps, not
  what it computes;
* every forward kernel call (B2, B3, B4) inside a wrapped unit runs
  again in the backward, under either policy;
* the 2-D matrix products (``aten.mm``, ``aten.addmm``) the backward
  runs: under "dots" as many as without remat (the forward's are
  saved), under "full" that many plus the forward's products inside the
  wrapped units (recomputed);
* under ``no_grad`` (every serve) the wrapper is never entered: the same
  logits and the same ops with remat on and off.

The dry run's cost tracer over a smoke MoE train step at 4 layers: with
"full" its peak is lower and its FLOPs higher than without remat; with
"dots" its FLOPs lie between the two.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import list_archs as ref_list_archs
from repro_torch.configs import InputShape, get_smoke_config, list_archs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.dryrun import lower_cell
from repro_torch.models import common, registry
from repro_torch.models.common import SAVED_PRODUCTS
from test_torch_train import (GRAD_TOL, TRAINED_ARCHS, _grad_gap,
                              _port_batch, _port_model, _ref_grads, _setup,
                              _state_dict, ref_opt, ref_ts, ts)

POLICIES = ("full", "dots")


def _remat(cfg, policy):
    """``cfg`` (either package's) with remat on under ``policy``, or off
    for None."""
    return cfg.scaled(remat=False) if policy is None else \
        cfg.scaled(remat=True, remat_policy=policy)


def _port_grads(host, tc, batch_np):
    loss, _, grads = ts.value_and_grad(_port_model(host, tc),
                                       _port_batch(batch_np), tc,
                                       ts.TrainConfig())
    return loss, grads


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_remat_matches_reference_remat(arch, policy):
    """The port under remat against ``jax.value_and_grad`` over the
    reference's ``jax.checkpoint`` with the same policy."""
    jc, tc, host, batch_np = _setup(arch=arch)
    jc, tc = _remat(jc, policy), _remat(tc, policy)
    loss_ref, grads_ref = _ref_grads(jc, host, batch_np, ref_ts.TrainConfig(
        optimizer=ref_opt.AdamWConfig()))
    grads_ref = _state_dict(grads_ref, tc)
    loss, grads = _port_grads(host, tc, batch_np)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)
    assert sorted(grads) == sorted(grads_ref)
    gaps = {k: _grad_gap(g, grads_ref[k]) for k, g in grads.items()}
    assert max(gaps.values()) <= GRAD_TOL, gaps


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_remat_equals_no_remat_bit_for_bit(arch, policy):
    _, tc, host, batch_np = _setup(arch=arch)
    loss_off, grads_off = _port_grads(host, _remat(tc, None),
                                      batch_np)
    loss, grads = _port_grads(host, _remat(tc, policy), batch_np)
    assert torch.equal(loss, loss_off)
    assert sorted(grads) == sorted(grads_off)
    for k, g in grads.items():
        assert torch.equal(g, grads_off[k]), k


class _Ops(TorchDispatchMode):
    """Counts the ops dispatched while it is active, by overload."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.order = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        self.order.append(func)
        return func(*args, **(kwargs or {}))

    def products(self) -> int:
        return sum(self.ops[f] for f in SAVED_PRODUCTS)


#: the kernel wrappers' forward entries (the plain versions on the CPU)
KERNELS = {"B2": flash_ops, "B3": ssd_ops, "B4": rms_ops}


def _step_counts(host, tc, batch_np, monkeypatch, early_stop=True):
    """One step of ``tc``: (each kernel's forward calls by where they ran:
    in a wrapped unit in the forward ("inside"), elsewhere in the forward
    ("outside"), in the backward (a recomputation); the 2-D products the
    backward ran; those the forward ran inside wrapped units)."""
    where = ["outside"]
    calls = collections.Counter()
    for name, mod in KERNELS.items():
        def counted(*a, _real=mod._forward, _name=name, **k):
            calls[_name, where[0]] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, "_forward", counted)
    inside = _Ops()
    real = common.checkpoint

    def wrapped(fn, *args, **kwargs):
        def body(*a, **k):
            if where[0] == "backward":
                return fn(*a, **k)
            where[0] = "inside"
            try:
                with inside:
                    return fn(*a, **k)
            finally:
                where[0] = "outside"
        return real(body, *args, **kwargs)

    monkeypatch.setattr(common, "checkpoint", wrapped)
    model = _port_model(host, tc)
    model.requires_grad_(True)
    batch = _port_batch(batch_np)
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        logits, aux = registry.train_forward(model, batch, tc)
    loss = ts.loss_fn(logits, batch["labels"]) + aux
    where[0] = "backward"
    with _Ops() as back:
        torch.autograd.grad(loss, list(model.parameters()))
    monkeypatch.undo()
    return calls, back.products(), inside.products()


@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_recomputation_reruns_kernels_and_dots_saves_products(
        arch, monkeypatch):
    """Every forward kernel call in a wrapped unit runs again in the
    backward under either policy (the launch counts chip_smoke asserts);
    the backward's 2-D products: under "dots" as many as without remat,
    under "full" those plus the forward's inside the units (the last
    product of a unit, which the backward does not need, is left out
    where recomputation stops early, as it does by default)."""
    _, tc, host, batch_np = _setup(arch=arch)
    off, off_mm, none_inside = _step_counts(
        host, _remat(tc, None), batch_np, monkeypatch)
    assert none_inside == 0 and off
    assert all(where == "outside" for _, where in off)
    runs = {}
    for policy, early_stop in (("full", True), ("full", False),
                               ("dots", True)):
        runs[policy, early_stop] = _step_counts(
            host, _remat(tc, policy), batch_np, monkeypatch,
            early_stop)
    for calls, _, inside in runs.values():
        for name in KERNELS:
            assert calls[name, "backward"] == calls[name, "inside"]
            assert calls[name, "inside"] + calls[name, "outside"] == \
                off[name, "outside"]
        assert inside > 0
    (_, full, inside), (_, full_all, _), (_, dots, _) = runs.values()
    assert dots == off_mm
    assert full_all == off_mm + inside
    assert off_mm < full <= full_all


@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_no_grad_never_enters_the_wrapper(arch, monkeypatch):
    """A forward without gradients (``train_forward`` under ``no_grad``
    and a prefill) runs the same ops to the same logits with remat on
    and off, and never calls ``torch.utils.checkpoint``."""
    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint entered under no_grad")

    monkeypatch.setattr(common, "checkpoint", refuse)
    _, tc, host, batch_np = _setup(arch=arch)
    runs = {}
    for remat in (False, True):
        cfg = tc.scaled(remat=remat)
        model = _port_model(host, cfg)
        batch = _port_batch(batch_np)
        with torch.no_grad(), _Ops() as ops:
            logits, _ = registry.train_forward(model, batch, cfg)
            state = registry.make_decode_state(
                cfg, batch["tokens"].shape[0],
                batch["tokens"].shape[1] + cfg.img_tokens + 1,
                device="cpu")
            last, _ = registry.prefill(model, batch, cfg, state)
        runs[remat] = (logits, last, ops.order)
    for a, b in zip(runs[False][:2], runs[True][:2]):
        assert torch.equal(a, b)
    assert runs[False][2] == runs[True][2]


def test_cost_tracer_sees_recomputation():
    """The dry run's tracer over one smoke train step of the MoE family
    at 4 layers, 4 x 256 tokens, at mesh (1, 1), where the activations
    outweigh the parameters: "full" keeps less and computes more than no
    remat, "dots" computes more than no remat and less than "full"."""
    got = {}
    for policy in (None, "full", "dots"):
        cfg = get_smoke_config("granite-moe-3b-a800m").scaled(n_layers=4)
        cfg = _remat(cfg, policy)
        _, costs = lower_cell(cfg, InputShape("train", 256, 4, "train"),
                              mesh_override=((1, 1), ("data", "model")))
        got[policy] = costs
    off, full, dots = got[None], got["full"], got["dots"]
    assert full.peak_bytes < off.peak_bytes
    assert off.flops < dots.flops < full.flops
    # the attention core runs again in every recomputed layer, and at
    # most one layer's saved tensors are live at the peak
    assert full.scope_saved_bytes["attn_core"] == \
        2 * off.scope_saved_bytes["attn_core"]
    assert full.scope_saved_at_peak["attn_core"] <= \
        off.scope_saved_bytes["attn_core"] / cfg.n_layers


def test_list_archs_matches_reference():
    assert list_archs() == ref_list_archs()
    assert all(get_smoke_config(a).name for a in list_archs())
