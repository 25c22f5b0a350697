"""The kernel wrappers give a gradient where they have a backward kernel,
and refuse one they cannot give.

B2 (flash attention), B3 (the SSD scan) and B4 (RMSNorm) return through
their ``torch.autograd.Function`` (B3 where an input needs a gradient):
on CUDA a call that needs a gradient runs the forward kernel inside the
Function (grad mode off there) and its backward runs the backward
kernels (``flash_attention_bwd``, ``ssd_inner_bwd``, ``rmsnorm_bwd``).
A bfloat16 B2 call that needs a gradient asks the forward for its LSE,
which the Function saves and hands to the backward; one under
``no_grad`` asks for none.  B1 (segment sum) writes into a fresh tensor
through ``ctypes`` and has no backward: where grad mode is on and an
input requires a gradient, its wrappers raise (saying that the kernel
has no backward) instead of returning a result whose gradient would
silently be zero.  On the CPU the plain versions stay
differentiable.  The card's branch is reached here without a card: the
routing helper's device check is patched to answer "cuda", and each
kernel library's loader to fail loudly, so a call that gets past the
guard is seen to reach the kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _route
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 flash_lse_plain)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fused
from repro_torch.kernels.segment_sum import (segment_sum, segment_sum_scatter,
                                             segment_sum_sorted)
from repro_torch.kernels.segment_sum import ops as seg_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_inner, ssd_inner_bwd


class LibraryReached(Exception):
    """Raised by a patched kernel-library loader; ``grad_mode`` is
    torch's grad mode where the library was reached."""

    def __init__(self):
        super().__init__()
        self.grad_mode = torch.is_grad_enabled()


def _t(rng, *shape, grad=True):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .requires_grad_(grad)


def _rmsnorm(rng):
    return lambda: rmsnorm_fused(_t(rng, 3, 16), _t(rng, 16, grad=False))


def _flash(rng):
    return lambda: flash_attention(_t(rng, 1, 2, 5, 8),
                                   _t(rng, 1, 1, 5, 8, grad=False),
                                   _t(rng, 1, 1, 5, 8, grad=False))


def _ssd(rng):
    def call():
        da = torch.cumsum(-torch.rand(1, 1, 2, 4, dtype=torch.float32), -1)
        return ssd_inner(_t(rng, 1, 1, 2, 4, 3), _t(rng, 1, 1, 1, 4, 5),
                         _t(rng, 1, 1, 1, 4, 5), da)
    return call


def _sorted(rng):
    off = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    return lambda: segment_sum_sorted(_t(rng, 5), off, torch.zeros(3))


def _scatter(rng):
    ids = torch.tensor([2, 0, 9, 1, 2], dtype=torch.int32)
    return lambda: segment_sum_scatter(_t(rng, 5), ids, torch.zeros(3))


def _segment_sum(rng):
    ids = torch.tensor([2, 0, -1, 1, 2], dtype=torch.int32)
    return lambda: segment_sum(_t(rng, 5), ids, 3)


WRAPPERS = {"rmsnorm_fused": _rmsnorm, "flash_attention": _flash,
            "ssd_inner": _ssd, "segment_sum_sorted": _sorted,
            "segment_sum_scatter": _scatter, "segment_sum": _segment_sum}
#: the wrappers with a backward kernel, behind an autograd Function
WITH_BACKWARD = ("rmsnorm_fused", "flash_attention", "ssd_inner")
WITHOUT_BACKWARD = tuple(n for n in WRAPPERS if n not in WITH_BACKWARD)


@pytest.fixture
def card_branch(monkeypatch):
    """Every wrapper takes its CUDA branch, and reaching a kernel library
    raises ``LibraryReached``."""
    def boom(*_args, **_kw):
        raise LibraryReached
    monkeypatch.setattr(_route, "device_type", lambda t: "cuda")
    for lib in (rms_ops.LIB, flash_ops.LIB, ssd_ops.LIB):
        monkeypatch.setattr(lib, "load", boom)
    monkeypatch.setattr(seg_ops, "load_library", boom)


@pytest.mark.parametrize("name", WITHOUT_BACKWARD)
def test_cuda_call_needing_a_gradient_is_refused(card_branch, name):
    call = WRAPPERS[name](np.random.default_rng(0))
    with pytest.raises(RuntimeError,
                       match=r"the CUDA kernel has no backward \(the "
                             r"reference's kernel has none"):
        call()


@pytest.mark.parametrize("name", WITH_BACKWARD)
def test_cuda_call_needing_a_gradient_reaches_the_kernel_through_the_function(
        card_branch, name):
    """B2, B3 and B4 take a call that needs a gradient: the forward
    kernel is reached inside the autograd Function, where grad mode is
    off."""
    call = WRAPPERS[name](np.random.default_rng(0))
    with pytest.raises(LibraryReached) as reached:
        call()
    assert reached.value.grad_mode is False


def _flash_bwd(rng):
    q, k, v = (_t(rng, *s, grad=False)
               for s in ((1, 2, 5, 8), (1, 1, 5, 8), (1, 1, 5, 8)))
    return lambda: flash_attention_bwd(q, k, v, q, q)


def _flash_bwd_lse(rng):
    q, k, v = (_t(rng, *s, grad=False).bfloat16()
               for s in ((1, 2, 5, 8), (1, 1, 5, 8), (1, 1, 5, 8)))
    lse = torch.zeros(1, 2, 5)
    return lambda: flash_attention_bwd(q, k, v, q, q, lse=lse)


def _rmsnorm_bwd(rng):
    x = _t(rng, 3, 16, grad=False)
    return lambda: rmsnorm_bwd(x, _t(rng, 16, grad=False), x)


def _ssd_bwd(rng):
    x, gy = (_t(rng, 1, 1, 2, 4, 3, grad=False) for _ in range(2))
    b, c = (_t(rng, 1, 1, 1, 4, 5, grad=False) for _ in range(2))
    da = torch.cumsum(-torch.rand(1, 1, 2, 4), -1)
    gs = _t(rng, 1, 1, 2, 5, 3, grad=False)
    return lambda: ssd_inner_bwd(x, b, c, da, gy, gs, torch.rand(1, 1, 2, 4))


@pytest.mark.parametrize("make", [_flash_bwd, _flash_bwd_lse, _rmsnorm_bwd,
                                  _ssd_bwd])
def test_cuda_backward_wrappers_reach_their_kernels(card_branch, make):
    with pytest.raises(LibraryReached):
        make(np.random.default_rng(0))()


@pytest.mark.parametrize("name", WITH_BACKWARD)
def test_cpu_gradient_runs_the_plain_backward(name, monkeypatch):
    """On the CPU the Function's backward runs the plain backward (the
    backward wrapper, reached once), never a kernel library."""
    seen = []
    wrapper = {"rmsnorm_fused": (rms_ops, "rmsnorm_bwd"),
               "flash_attention": (flash_ops, "flash_attention_bwd"),
               "ssd_inner": (ssd_ops, "ssd_inner_bwd")}[name]
    real = getattr(*wrapper)
    monkeypatch.setattr(wrapper[0], wrapper[1],
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    out = WRAPPERS[name](np.random.default_rng(0))()
    sum(o.sum() for o in (out if isinstance(out, tuple) else (out,))) \
        .backward()
    assert seen == [1]


#: each wrapper with a backward: the backward wrapper its Function calls
BACKWARD_OF = {"rmsnorm_fused": "rmsnorm_bwd",
               "flash_attention": "flash_attention_bwd",
               "ssd_inner": "ssd_inner_bwd"}


@pytest.mark.parametrize("name", WITH_BACKWARD)
def test_backward_wrappers_call_their_observers(name, monkeypatch):
    """A gradient through the Function calls each of ``_route.OBSERVERS``
    once, with the backward wrapper's name and arguments (the output
    gradient, all ones, among them)."""
    seen = []
    monkeypatch.setattr(_route, "OBSERVERS", [
        lambda *call: seen.append(call)])
    out = WRAPPERS[name](np.random.default_rng(0))()
    sum(o.sum() for o in (out if isinstance(out, tuple) else (out,))) \
        .backward()
    assert [c[0] for c in seen] == [BACKWARD_OF[name]]
    assert any(isinstance(a, torch.Tensor) and bool((a == 1).all())
               for a in seen[0][1])


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cuda_call_under_no_grad_reaches_the_kernel(card_branch, name):
    call = WRAPPERS[name](np.random.default_rng(0))
    with torch.no_grad(), pytest.raises(LibraryReached):
        call()


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cpu_call_stays_differentiable(name):
    out = WRAPPERS[name](np.random.default_rng(0))()
    first = out[0] if isinstance(out, tuple) else out
    assert first.requires_grad and first.grad_fn is not None


def test_other_devices_are_refused():
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rmsnorm_fused(x, torch.ones(4, device="meta"))


def test_cuda_gradient_at_head_dim_256_reaches_the_kernels(card_branch):
    """B2's backward kernels are built for every head dim the forward
    takes (up to 256): a call on the card that needs a gradient at 256
    is no longer refused but reaches the forward kernel inside the
    Function (grad mode off), as one under ``no_grad`` does, and the
    backward wrapper reaches its library at paligemma-3b's geometry (G
    = 8, the prefix-LM mask), bf16 with the forward's LSE and float32."""
    rng = np.random.default_rng(0)
    assert flash_ops.MAX_BWD_HEAD_DIM == flash_ops.MAX_HEAD_DIM == 256
    with pytest.raises(LibraryReached) as reached:
        flash_attention(_t(rng, 1, 1, 4, 256), _t(rng, 1, 1, 4, 256),
                        _t(rng, 1, 1, 4, 256))
    assert reached.value.grad_mode is False
    with torch.no_grad(), pytest.raises(LibraryReached):
        flash_attention(_t(rng, 1, 1, 4, 256), _t(rng, 1, 1, 4, 256),
                        _t(rng, 1, 1, 4, 256))
    for dtype, lse in ((torch.bfloat16, torch.zeros(1, 8, 6)),
                       (torch.float32, None)):
        q = _t(rng, 1, 8, 6, 256, grad=False).to(dtype)
        k = _t(rng, 1, 1, 6, 256, grad=False).to(dtype)
        with pytest.raises(LibraryReached):
            flash_attention_bwd(q, k, k, q, q, prefix_len=3, lse=lse)


def _bf16(rng, *shape, grad=True):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .bfloat16().requires_grad_(grad)


def _plain_forward(calls):
    """A stand-in for ``flash_ops._forward`` that records each call's
    ``want_lse`` and the LSE it returns, computed by the plain versions."""
    def forward(q, k, v, causal, prefix_len, *, want_lse=False):
        lse = flash_lse_plain(q, k, causal=causal,
                              prefix_len=prefix_len) if want_lse else None
        calls.append((want_lse, lse))
        return flash_attention_plain(q, k, v, causal=causal,
                                     prefix_len=prefix_len), lse
    return forward


@pytest.mark.parametrize("case,want", [("bf16 gradient", True),
                                       ("no_grad", False),
                                       ("frozen inputs", False),
                                       ("float32 gradient", False)])
def test_function_asks_the_forward_for_an_lse_only_when_a_gradient_is_needed(
        card_branch, monkeypatch, case, want):
    """On the card's branch the Function asks the forward kernel for its
    LSE only for a bfloat16 call whose gradient will be taken (the
    float32 backward recomputes it); under ``no_grad`` it passes none."""
    calls = []
    monkeypatch.setattr(flash_ops, "_forward", _plain_forward(calls))
    rng = np.random.default_rng(0)
    grad = case != "frozen inputs"
    q, k, v = (_bf16(rng, *s, grad=grad)
               for s in ((1, 4, 6, 8), (1, 2, 6, 8), (1, 2, 6, 8)))
    if case == "float32 gradient":
        q, k, v = (t.detach().float().requires_grad_() for t in (q, k, v))
    if case == "no_grad":
        with torch.no_grad():
            flash_attention(q, k, v)
    else:
        flash_attention(q, k, v)
    assert [w for w, _ in calls] == [want]
    assert (calls[0][1] is not None) == want


def test_function_hands_the_forwards_lse_to_the_backward(card_branch,
                                                         monkeypatch):
    """The LSE the forward wrote reaches the backward wrapper, and the
    gradient is the plain backward's."""
    calls, seen = [], []

    def backward(q, k, v, o, do, *, causal, prefix_len, lse=None):
        seen.append(lse)
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         prefix_len=prefix_len)
    monkeypatch.setattr(flash_ops, "_forward", _plain_forward(calls))
    monkeypatch.setattr(flash_ops, "flash_attention_bwd", backward)
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng, *s)
               for s in ((1, 4, 6, 8), (1, 2, 6, 8), (1, 2, 6, 8)))
    out = flash_attention(q, k, v, causal=True, prefix_len=3)
    out.float().sum().backward()
    (_, lse), = calls
    assert len(seen) == 1 and seen[0] is not None
    assert seen[0].data_ptr() == lse.data_ptr() and torch.equal(seen[0], lse)
    want = flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), out.detach(),
        torch.ones_like(out), causal=True, prefix_len=3)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


def test_dkdv_parts_balance_the_causal_grid():
    """The tensor-core backward splits a kv head's G q heads into the
    fewest parts (a divisor of G) that give every SM an item."""
    # qwen2-1.5b's train step: 8 x 2 x 8 = 128 kv tiles on 132 SMs
    assert flash_ops.dkdv_parts(8, 2, 512, 6, 132) == 2
    assert flash_ops.dkdv_parts(8, 8, 512, 3, 132) == 1     # 512 tiles
    assert flash_ops.dkdv_parts(1, 1, 150, 6, 132) == 6     # too few
    assert flash_ops.dkdv_parts(2, 2, 130, 3, 132) == 3
    assert flash_ops.dkdv_parts(1, 1, 64, 1, 132) == 1      # G = 1


def test_bwd_route_follows_what_tma_can_describe():
    rng = np.random.default_rng(2)
    q, k, v = (_bf16(rng, *s, grad=False)
               for s in ((1, 2, 8, 16), (1, 1, 8, 16), (1, 1, 8, 16)))
    assert flash_ops.bwd_route(q, k, v, q, q) == "wgmma"
    f32 = [t.float() for t in (q, k, v)]
    assert flash_ops.bwd_route(*f32, f32[0], f32[0]) == "simt"
    odd = [_bf16(rng, 1, 2, 8, 20, grad=False)] * 5       # hd % 8 != 0
    assert flash_ops.bwd_route(*odd) == "simt"
    shifted = torch.zeros(1 * 2 * 8 * 16 + 1, dtype=torch.bfloat16)[1:] \
        .view(1, 2, 8, 16)                                 # 2-byte aligned
    assert flash_ops.bwd_route(shifted, k, v, q, q) == "simt"
