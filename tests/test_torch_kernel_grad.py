"""The kernel wrappers refuse a gradient they cannot give.

On CUDA each wrapper writes into a fresh tensor through ``ctypes``, so
its result has no backward.  Where grad mode is on and an input
requires a gradient, the wrapper raises (naming ROADMAP A.5) instead of
returning a result whose gradient would silently be zero; on the CPU
the plain versions stay differentiable.  The card's branch is reached
here without a card: the routing helper's device check is patched to
answer "cuda", and each kernel library's loader to fail loudly, so a
call that gets past the guard is seen to reach the kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _route
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import rmsnorm_fused
from repro_torch.kernels.segment_sum import (segment_sum, segment_sum_scatter,
                                             segment_sum_sorted)
from repro_torch.kernels.segment_sum import ops as seg_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_inner


class LibraryReached(Exception):
    """Raised by a patched kernel-library loader."""


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


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cuda_call_needing_a_gradient_is_refused(card_branch, name):
    call = WRAPPERS[name](np.random.default_rng(0))
    with pytest.raises(RuntimeError, match=r"no backward yet \(ROADMAP A\.5\)"):
        call()


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
