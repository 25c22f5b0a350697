"""The kernel wrappers give a gradient where they have a backward
kernel, and refuse one they cannot give.

B2 (flash attention) and B4 (RMSNorm) return through their
``torch.autograd.Function``: on CUDA a call that needs a gradient runs
the forward kernel inside the Function (grad mode off there) and its
backward runs the backward kernels (``flash_attention_bwd``,
``rmsnorm_bwd``).  B1 (segment sum) and B3 (the SSD scan) write into a
fresh tensor through ``ctypes`` and have no backward: where grad mode is
on and an input requires a gradient, their wrappers raise (naming
ROADMAP A.5) instead of returning a result whose gradient would
silently be zero.  On the CPU the plain versions stay differentiable.
The card's branch is reached here without a card: the routing helper's
device check is patched to answer "cuda", and each kernel library's
loader to fail loudly, so a call that gets past the guard is seen to
reach the kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _route
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fused
from repro_torch.kernels.segment_sum import (segment_sum, segment_sum_scatter,
                                             segment_sum_sorted)
from repro_torch.kernels.segment_sum import ops as seg_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_inner


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
WITH_BACKWARD = ("rmsnorm_fused", "flash_attention")
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
    with pytest.raises(RuntimeError, match=r"no backward yet \(ROADMAP A\.5\)"):
        call()


@pytest.mark.parametrize("name", WITH_BACKWARD)
def test_cuda_call_needing_a_gradient_reaches_the_kernel_through_the_function(
        card_branch, name):
    """B2 and B4 take a call that needs a gradient: the forward kernel
    is reached inside the autograd Function, where grad mode is off."""
    call = WRAPPERS[name](np.random.default_rng(0))
    with pytest.raises(LibraryReached) as reached:
        call()
    assert reached.value.grad_mode is False


def _flash_bwd(rng):
    q, k, v = (_t(rng, *s, grad=False)
               for s in ((1, 2, 5, 8), (1, 1, 5, 8), (1, 1, 5, 8)))
    return lambda: flash_attention_bwd(q, k, v, q, q)


def _rmsnorm_bwd(rng):
    x = _t(rng, 3, 16, grad=False)
    return lambda: rmsnorm_bwd(x, _t(rng, 16, grad=False), x)


@pytest.mark.parametrize("make", [_flash_bwd, _rmsnorm_bwd])
def test_cuda_backward_wrappers_reach_their_kernels(card_branch, make):
    with pytest.raises(LibraryReached):
        make(np.random.default_rng(0))()


@pytest.mark.parametrize("name", WITH_BACKWARD)
def test_cpu_gradient_runs_the_plain_backward(name, monkeypatch):
    """On the CPU the Function's backward runs the plain backward (the
    backward wrapper, reached once), never a kernel library."""
    seen = []
    wrapper = {"rmsnorm_fused": (rms_ops, "rmsnorm_bwd"),
               "flash_attention": (flash_ops, "flash_attention_bwd")}[name]
    real = getattr(*wrapper)
    monkeypatch.setattr(wrapper[0], wrapper[1],
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    out = WRAPPERS[name](np.random.default_rng(0))()
    out.sum().backward()
    assert seen == [1]


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


def test_cuda_gradient_above_the_backward_builds_is_refused(card_branch):
    """B2's backward kernels are built up to head dim 128: a call on the
    card that needs a gradient at 256 raises before the forward runs."""
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match=r"ROADMAP A\.5"):
        flash_attention(_t(rng, 1, 1, 4, 256), _t(rng, 1, 1, 4, 256),
                        _t(rng, 1, 1, 4, 256))
    with torch.no_grad(), pytest.raises(LibraryReached):
        flash_attention(_t(rng, 1, 1, 4, 256), _t(rng, 1, 1, 4, 256),
                        _t(rng, 1, 1, 4, 256))
