"""The port's CUDA kernels, its phase and its serving path on the card.

Every test here needs an NVIDIA CUDA device and skips without one; on
the card run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  This file imports neither jax nor the
reference package, so it runs where only the port is installed.

Kernel vs plain version: float32 sums of positive values in another
order (and, for the scatter form, in atomic order) agree to a few 1e-7
relative per term, so both are held at ``rtol = 1e-5``.  A phase on the
card vs the same seeded phase on the CPU is held at the jax engine's
``JAX_RTOL = 2e-2``.

RMSNorm (B4) kernel vs plain version: both compute in float32 and cast
once; float32 outputs agree to ``TOL``, bfloat16 outputs to one bf16
ulp (``BF16_RTOL = 2**-7`` of the value).  SSD (B3) kernel vs plain
version: in float32 (the SIMT kernel) float32 sums of at most 128
products in possibly other orders, held at ``SSD_RTOL = 1e-5`` relative
to the largest output; in bf16 (the tensor-core kernel) within the
per-output ``bf16_limits`` of ``repro_torch.kernels.ssd_scan.ops``, the
bound of tests/test_torch_ssd_scan.py::test_bf16_route_witness.  A smoke
serve on the card vs the same model on the CPU in float32: identical
greedy tokens, logits at ``TOL``-scale ``1e-4``.

Flash attention (B2) kernel vs plain version: in float32 both compute
in float32 (the kernel scales q before the dot, the plain version the
scores after it, and they sum in other orders) and agree to
``FLASH_TOL = 3e-5`` (the JAX kernel tests' tolerance).  In bfloat16
the kernel rounds each kv tile's unnormalised P to bf16 and the plain
version the normalised probabilities, so outputs agree to one bf16 ulp
of the value plus, per output, ``FLASH_BF16_ATOL_PER_PV * sum_j p_j
|v_j|``, the bound of
tests/test_torch_flash_attention.py::test_kernel_order_witness.  The
qwen2-1.5b smoke serve is held like the mamba2-130m one.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import (DragonflySimulator, RoutingPolicy,
                                   SimParams, small_topology)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.mamba2_130m import SMOKE
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm_fused, rmsnorm_plain
from repro_torch.kernels.rmsnorm.ops import route as rms_route
from repro_torch.kernels.ssd_scan import ssd_inner, ssd_inner_plain
from repro_torch.kernels.ssd_scan.ops import bf16_limits
from repro_torch.kernels.segment_sum import (segment_sum_scatter,
                                             segment_sum_scatter_plain,
                                             segment_sum_sorted,
                                             segment_sum_sorted_plain)

pytestmark = pytest.mark.cuda

TOL = 1e-5
JAX_RTOL = 2e-2
BF16_RTOL = 2.0 ** -7
SSD_RTOL = 1e-5
FLASH_TOL = 3e-5
#: bf16 flash kernel vs plain version: rtol BF16_RTOL plus, per output,
#: this times sum_j p_j |v_j|: each placement of P's bf16 rounding moves
#: every p_j by at most 2**-8 p_j
#: (tests/test_torch_flash_attention.py::test_kernel_order_witness)
FLASH_BF16_ATOL_PER_PV = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _assert_flash_bf16_close(got, want, q, k, v, causal):
    atol = FLASH_BF16_ATOL_PER_PV * flash_attention_plain(
        q.float(), k.float(), v.float().abs(), causal=causal)
    gap = (got.float() - want.float()).abs()
    limit = atol + BF16_RTOL * want.float().abs()
    assert bool((gap <= limit).all()), \
        f"largest gap {float((gap / limit.clamp_min(1e-30)).max()):.3f} " \
        f"of its limit"


def _inputs(n, segs, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, segs, size=n).astype(np.int32)
    vals = rng.random(n).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    off = np.zeros(segs + 1, dtype=np.int32)
    np.cumsum(np.bincount(ids, minlength=segs), out=off[1:])
    return ids, vals, vals[order], off


@pytest.mark.parametrize("n,segs", [(3_500_000, 56_448), (1000, 300),
                                    (64, 1000), (5, 3)])
def test_kernels_match_plain_versions(cuda, n, segs):
    ids, vals, v_sorted, off = (torch.from_numpy(a).to(cuda)
                                for a in _inputs(n, segs, seed=3))

    def zeros():
        return torch.zeros(segs, device=cuda)

    before = segment_sum_sorted.launches, segment_sum_scatter.launches
    k_sorted = segment_sum_sorted(v_sorted, off, zeros())
    k_scatter = segment_sum_scatter(vals, ids, zeros())
    assert (segment_sum_sorted.launches, segment_sum_scatter.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        k_sorted, segment_sum_sorted_plain(v_sorted, off, zeros()),
        rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        k_scatter, segment_sum_scatter_plain(vals, ids, zeros()),
        rtol=TOL, atol=TOL)


def test_scatter_skips_out_of_range_ids(cuda):
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0], device=cuda)
    ids = torch.tensor([2, 2, 5, -1, 8, 100], dtype=torch.int32,
                       device=cuda)
    out = segment_sum_scatter(vals, ids, torch.zeros(8, device=cuda))
    assert out.tolist() == [0, 0, 3.0, 0, 0, 4.0, 0, 0]


def test_sorted_form_is_deterministic(cuda):
    _, _, v_sorted, off = (torch.from_numpy(a).to(cuda)
                           for a in _inputs(200_000, 5000, seed=4))
    runs = [segment_sum_sorted(v_sorted, off, torch.zeros(5000, device=cuda))
            for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("start", [0, 1, 3])
@pytest.mark.parametrize("length", list(range(1, 10)))
def test_scatter_slices_match_plain(cuda, start, length):
    """Lengths 1-9 at offsets 0, 1 and 3 of 16-byte aligned buffers (one
    partial warp), with out-of-range ids among the pairs."""
    rng = np.random.default_rng(10 * start + length)
    ids = torch.from_numpy(rng.integers(-3, 11, size=16).astype(np.int32))
    vals = torch.from_numpy(rng.random(16).astype(np.float32))
    ids, vals = ids.to(cuda), vals.to(cuda)
    v, i = vals[start:start + length], ids[start:start + length]
    got = segment_sum_scatter(v, i, torch.zeros(8, device=cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, segment_sum_scatter_plain(v, i, torch.zeros(8, device=cuda)),
        rtol=TOL, atol=TOL)


def test_scatter_with_ids_and_values_off_each_others_alignment(cuda):
    """ids and values at different offsets from a 16-byte boundary, with
    repeated and out-of-range ids."""
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(-2, 40, size=5001).astype(np.int32))
    vals = torch.from_numpy(rng.random(5001).astype(np.float32))
    ids, vals = ids.to(cuda)[1:], vals.to(cuda)[:-1].contiguous()[2:]
    ids = ids[:vals.shape[0]]
    got = segment_sum_scatter(vals, ids, torch.zeros(37, device=cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, segment_sum_scatter_plain(vals, ids, torch.zeros(37,
                                                              device=cuda)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_plan", [False, True])
def test_phase_on_the_card_matches_the_cpu(cuda, use_plan):
    topo = small_topology("aries")
    rng = np.random.default_rng(7)
    src = rng.integers(0, topo.n_nodes, size=400)
    dst = (src + rng.integers(1, topo.n_nodes, size=400)) % topo.n_nodes
    size = rng.pareto(1.2, size=400) * 65536 + 1024
    pol = RoutingPolicy(RoutingMode.ADAPTIVE_2)
    sims = [DragonflySimulator(topo, SimParams(seed=5), device=d)
            for d in (cuda, "cpu")]
    for _ in range(3):
        a, b = (s.run_phase(src, dst, size, pol,
                            plan=s.plan_for(src, dst, size) if use_plan
                            else None) for s in sims)
        np.testing.assert_allclose(a.t_us, b.t_us, rtol=JAX_RTOL)
        np.testing.assert_allclose(a.latency_us, b.latency_us, rtol=JAX_RTOL)
        assert np.array_equal(a.flits, b.flits)
        assert sims[0].rng.bit_generator.state == \
            sims[1].rng.bit_generator.state


@pytest.mark.parametrize("shape,xdtype,gdtype", [
    ((4096, 768), torch.bfloat16, torch.bfloat16),   # prefill ln / ln_f
    ((4096, 1536), torch.bfloat16, torch.bfloat16),  # prefill gated norm
    ((8, 768), torch.bfloat16, torch.bfloat16),      # decode step
    ((3, 5, 100), torch.bfloat16, torch.float32),    # D not a multiple of 8
    ((2, 8192), torch.float32, torch.float32),
    ((7, 8191), torch.float32, torch.bfloat16),
    ((8, 1536), torch.bfloat16, torch.bfloat16),     # decode, qwen2-1.5b
    ((16, 4096), torch.bfloat16, torch.bfloat16),    # 16 vectors per lane
    ((16, 4096), torch.bfloat16, torch.float32),
    ((5, 264), torch.bfloat16, torch.bfloat16),      # part of a lane empty
    ((5, 264), torch.float32, torch.bfloat16),
    ((4100, 768), torch.float32, torch.float32),
])
def test_rmsnorm_kernel_matches_plain(cuda, shape, xdtype, gdtype):
    """Both routes against the plain version: the register route (every
    shape whose D is a multiple of 16 bytes, up to 16 vectors per lane),
    the generic one for the rest."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=gen).to(xdtype)
    gamma = (1 + 0.5 * torch.randn(shape[-1], device=cuda,
                                   generator=gen)).to(gdtype)
    before = rmsnorm_fused.launches
    got = rmsnorm_fused(x, gamma)
    assert rmsnorm_fused.launches == before + 1
    torch.cuda.synchronize()
    want = rmsnorm_plain(x, gamma)
    assert got.dtype == xdtype and got.shape == x.shape
    if xdtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_RTOL, atol=0.0)


@pytest.mark.parametrize("shape,kv", [((4096, 768), 3), ((8, 1536), 6),
                                      ((16, 4096), 16), ((5, 264), 2)])
def test_rmsnorm_routes_match_plain(cuda, shape, kv):
    """The register route at the serving shapes and at 16 and 2 vectors
    per lane; x one element off a 16-byte boundary takes the generic
    route (its one-value loop sums in another order than the vector
    loop); both match the plain version.  Few rows spread one per
    block."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    gamma = (1 + 0.5 * torch.randn(shape[-1], device=cuda,
                                   generator=gen)).to(torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = buf[1:].view(shape)
    shifted.copy_(x)
    route, kv_got, warps = rms_route(x, gamma)
    assert (route, kv_got) == ("register", kv)
    assert warps == (1 if shape[0] <= 132 else 8)
    assert rms_route(shifted, gamma)[0] == "generic"
    got, got_generic = rmsnorm_fused(x, gamma), rmsnorm_fused(shifted, gamma)
    torch.cuda.synchronize()
    want = rmsnorm_plain(x, gamma).float()
    for out in (got, got_generic):
        torch.testing.assert_close(out.float(), want, rtol=BF16_RTOL,
                                   atol=0.0)


@pytest.mark.parametrize("with_dt", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Nc,H,G,Q,P,N", [
    (8, 4, 24, 1, 128, 64, 128),   # 8 x 512-token prefill, mamba2-130m
    (1, 2, 24, 1, 100, 64, 128),   # a 200-token prompt: chunk of 100
    (2, 3, 3, 3, 8, 16, 16),       # smoke config, one group per head
    (1, 2, 6, 2, 64, 64, 128),     # two groups
    (2, 2, 4, 2, 100, 5, 7),       # odd P and N: ordinary loads, not TMA
    (1, 1, 2, 1, 1, 5, 7),
])
def test_ssd_kernel_matches_plain(cuda, dtype, with_dt, B, Nc, H, G, Q, P,
                                  N):
    """float32: the SIMT kernel at ``SSD_RTOL``; bf16: the tensor-core
    kernel within ``bf16_limits`` (tests/test_torch_ssd_scan.py::
    test_bf16_route_witness); with dt, the first input is x and the
    kernels form x * dt."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    dt = getattr(torch, dtype)
    xdt = (torch.randn(B, Nc, H, Q, P, device=cuda, generator=gen) * 0.5) \
        .to(dt)
    bm = torch.randn(B, Nc, G, Q, N, device=cuda, generator=gen).to(dt)
    cm = torch.randn(B, Nc, G, Q, N, device=cuda, generator=gen).to(dt)
    da = torch.cumsum(-0.1 * torch.rand(B, Nc, H, Q, device=cuda,
                                        generator=gen), -1)
    dts = 0.3 + torch.rand(B, Nc, H, Q, device=cuda, generator=gen) \
        if with_dt else None
    before = ssd_inner.launches, ssd_inner.bf16_launches
    y, s = ssd_inner(xdt, bm, cm, da, dts)
    bf16 = int(dt == torch.bfloat16)
    assert (ssd_inner.launches, ssd_inner.bf16_launches) == (
        before[0] + 1, before[1] + bf16)
    torch.cuda.synchronize()
    want_y, want_s = ssd_inner_plain(xdt, bm, cm, da, dts)
    if bf16:
        lim_y, lim_s = bf16_limits(xdt, bm, cm, da, dts)
        for got, want, lim in ((y, want_y, lim_y), (s, want_s, lim_s)):
            assert bool(((got - want).abs() <= lim).all())
        return
    for got, want in ((y, want_y), (s, want_s)):
        atol = SSD_RTOL * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=SSD_RTOL, atol=atol)


def test_ssd_kernel_refuses_tiles_beyond_its_limits(cuda):
    z = torch.zeros(1, 1, 1, 129, 8, device=cuda)
    with pytest.raises(ValueError, match="Q <= 128"):
        ssd_inner(z, torch.zeros(1, 1, 1, 129, 8, device=cuda),
                  torch.zeros(1, 1, 1, 129, 8, device=cuda),
                  torch.zeros(1, 1, 1, 129, device=cuda))


def test_smoke_serve_on_the_card_matches_the_cpu(cuda):
    from repro_torch.models import registry
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = SMOKE.scaled(dtype=torch.float32)
    prompts = [[5, 17, 3, 99, 250, 7, 8, 1, 2, 3, 4, 5], [11, 12]]
    runs, logits = [], []
    for dev in (cuda, torch.device("cpu")):
        model = registry.init_params(cfg, 0, dev)
        toks = torch.tensor([prompts[0]], device=dev)
        state = registry.make_decode_state(cfg, 1, 16, device=dev)
        before = ssd_inner.launches, rmsnorm_fused.launches
        lg, _ = registry.prefill(model, {"tokens": toks}, cfg, state)
        after = ssd_inner.launches, rmsnorm_fused.launches
        n_norms = 2 * cfg.n_layers + 1
        want = (before[0] + cfg.n_layers, before[1] + n_norms) \
            if dev.type == "cuda" else before
        assert after == want
        logits.append(lg.float().cpu())
        eng = ServeEngine(cfg, model, ServeConfig(batch=3, max_len=32),
                          device=dev)
        out = eng.run([Request(prompt=list(p), max_new_tokens=6)
                       for p in prompts])
        runs.append([r.out_tokens for r in out])
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-4)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("q_shape,kv_shape,causal", [
    ((8, 12, 512, 128), (8, 2, 512, 128), True),   # qwen2-1.5b prefill
    ((2, 12, 200, 128), (2, 2, 200, 128), True),   # a 200-token prompt
    ((1, 4, 7, 64), (1, 2, 333, 64), False),       # Sq != Skv, ragged
    ((2, 4, 70, 16), (2, 2, 70, 16), True),        # smoke head dim
    ((1, 3, 65, 12), (1, 1, 130, 12), True),       # head dim 12, MQA
    ((2, 32, 512, 64), (2, 32, 512, 64), True),    # stablelm-1.6b width
    ((1, 2, 130, 72), (1, 2, 130, 72), True),      # head dim 72: padded
    ((2, 12, 700, 128), (2, 2, 700, 128), True),   # 144 q tiles: two rounds
    ((1, 2, 300, 128), (1, 2, 700, 128), False),   # Sq < Skv, non-causal
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, q_shape, kv_shape, causal,
                                              dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in (q_shape, kv_shape, kv_shape))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
    else:
        _assert_flash_bf16_close(got, want, q, k, v, causal)


def test_flash_attention_bf16_unaligned_matches_plain(cuda):
    """A q that starts 8 bytes past a 16-byte boundary, which TMA cannot
    copy: the bf16 kernel's variant with ordinary loads, at head dim
    128."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = 2 * 12 * 100 * 128
    buf = torch.randn(n + 8, device=cuda, generator=gen).to(torch.bfloat16)
    q = buf[4:4 + n].view(2, 12, 100, 128)
    k, v = (torch.randn((2, 2, 100, 128), device=cuda, generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    assert q.is_contiguous() and q.data_ptr() % 16 == 8
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v)
    _assert_flash_bf16_close(got, want, q, k, v, True)


def test_flash_attention_kernel_refuses_oversized_grids(cuda):
    z = torch.zeros(1, 65536, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="65535"):
        flash_attention(z, z, z)


def test_qwen2_smoke_serve_on_the_card_matches_the_cpu(cuda):
    from repro_torch.models import registry
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_smoke_config("qwen2-1.5b").scaled(dtype=torch.float32)
    prompts = [[5, 17, 3, 99, 250, 7, 8, 1, 2, 3, 4, 5], [11, 12]]
    runs, logits = [], []
    for dev in (cuda, torch.device("cpu")):
        model = registry.init_params(cfg, 0, dev)
        toks = torch.tensor([prompts[0]], device=dev)
        state = registry.make_decode_state(cfg, 1, 16, device=dev)
        before = flash_attention.launches, rmsnorm_fused.launches
        lg, _ = registry.prefill(model, {"tokens": toks}, cfg, state)
        after = flash_attention.launches, rmsnorm_fused.launches
        n_norms = 2 * cfg.n_layers + 1
        want = (before[0] + cfg.n_layers, before[1] + n_norms) \
            if dev.type == "cuda" else before
        assert after == want
        logits.append(lg.float().cpu())
        eng = ServeEngine(cfg, model, ServeConfig(batch=3, max_len=32),
                          device=dev)
        out = eng.run([Request(prompt=list(p), max_new_tokens=6)
                       for p in prompts])
        runs.append([r.out_tokens for r in out])
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-4)
    assert runs[0] == runs[1]
