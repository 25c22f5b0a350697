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
tests/test_torch_flash_attention.py::test_kernel_order_witness (and its
prefix-LM form at head dims 192 and 256).  The qwen2-1.5b smoke serve is
held like the mamba2-130m one.

The backward kernels (B2's, B3's and B4's, ``flash_attention_bwd``,
``ssd_inner_bwd`` and ``rmsnorm_bwd``) against their plain versions on
the same inputs: in
float32 both sum float32 products in other orders, held at
``BWD_F32_RTOL = 1e-4`` of each gradient's largest entry (dK and dV sum
up to G Skv = 3072 products at the qwen2-1.5b shape: ``n * 2**-24`` is
1.8e-4 of the sum of the terms' magnitudes at worst, a few 1e-6 for sums
of random sign); in bfloat16 by the spread rule: each gradient's largest
gap to the plain version run in float32 on the same (bf16) inputs stays
within ``BWD_SPREAD = 2`` times the bf16 plain version's own gap (both
round each gradient once at the end and P once before ``P^T dO``; the
kernel sums in another order, and its tensor-core route reads the
forward's LSE and carries dS into dQ and dK as two bf16 terms).  B2's bf16
forward writes that LSE only where asked: the output is the same bits
either way, and the LSE is a float32 logsumexp of the masked scores
within ``LSE_RTOL = 1e-5``.  The qwen2 smoke train step on the card is
held against the CPU's in float32, and so are mamba2-130m's and
zamba2-7b's.
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
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_fwd,
                                                 flash_attention_plain,
                                                 flash_lse_plain)
from repro_torch.kernels.flash_attention.ops import bwd_route
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd, rmsnorm_bwd_plain,
                                         rmsnorm_fused, rmsnorm_plain)
from repro_torch.kernels.rmsnorm.ops import bwd_route as rms_bwd_route
from repro_torch.kernels.rmsnorm.ops import route as rms_route
from repro_torch.kernels.ssd_scan import (ssd_inner, ssd_inner_bwd,
                                          ssd_inner_bwd_plain,
                                          ssd_inner_plain)
from repro_torch.kernels.ssd_scan.ops import bf16_limits, bwd_plan
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
#: backward kernels vs plain versions: float32 at this share of each
#: gradient's largest entry; bf16 gaps within BWD_SPREAD times the plain
#: version's own (the module docstring)
BWD_F32_RTOL = 1e-4
BWD_SPREAD = 2.0
#: the forward's LSE vs a float32 logsumexp of the masked scores
LSE_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _assert_flash_bf16_close(got, want, q, k, v, causal, prefix_len=0):
    atol = FLASH_BF16_ATOL_PER_PV * flash_attention_plain(
        q.float(), k.float(), v.float().abs(), causal=causal,
        prefix_len=prefix_len)
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


def _column(device, planned):
    """A sweep column on one device: a simulator per arm, same seed."""
    topo = small_topology("aries")
    rng = np.random.default_rng(9)
    src = rng.integers(0, topo.n_nodes, size=400)
    dst = (src + rng.integers(1, topo.n_nodes, size=400)) % topo.n_nodes
    size = rng.pareto(1.2, size=400) * 65536 + 1024
    calls = []
    for mode in (RoutingMode.ADAPTIVE_0, RoutingMode.ADAPTIVE_3,
                 RoutingMode.MIN_HASH):
        sim = DragonflySimulator(topo, SimParams(seed=11), device=device)
        kw = dict(src_nodes=src, dst_nodes=dst, bytes_=size,
                  policy=RoutingPolicy(mode))
        if planned:
            kw["plan"] = sim.plan_for(src, dst, size)
        calls.append((sim, kw))
    return calls


@pytest.mark.parametrize("planned", [False, True])
def test_batched_phases_on_the_card(cuda, planned):
    """run_phase_batch on the card: one dispatch launching B1 as often as
    one phase; t_us within JAX_RTOL of the batch on the CPU, and of
    sequential run_phase on the card: within 1e-4 on the first round,
    where both start from one state and only the scatter form's atomic
    order differs (a random summation order moves t_us by under 1e-5:
    tests/test_torch_batch.py::test_summation_order_witness), within
    JAX_RTOL after it, where the carried queues amplify that order
    (1.6e-4 by the second round of this column's planless phases)."""
    from repro_torch.dragonfly import torch_backend
    from repro_torch.dragonfly.simulator import run_phase_batch
    batched, sequential, cpu = (_column(cuda, planned),
                                _column(cuda, planned),
                                _column("cpu", planned))
    for r in range(3):
        before = (segment_sum_sorted.launches, segment_sum_scatter.launches,
                  dict(torch_backend.PIPELINE_CALLS))
        got = run_phase_batch(batched)
        launched = (segment_sum_sorted.launches - before[0],
                    segment_sum_scatter.launches - before[1])
        assert torch_backend.PIPELINE_CALLS["batched"] == \
            before[2]["batched"] + 1
        assert launched == ((5, 6) if planned else (0, 6))
        seq = [sim.run_phase(**kw) for sim, kw in sequential]
        ref = run_phase_batch(cpu)
        for a, b, c in zip(got, seq, ref):
            np.testing.assert_allclose(a.t_us, b.t_us,
                                       rtol=1e-4 if r == 0 else JAX_RTOL)
            np.testing.assert_allclose(a.t_us, c.t_us, rtol=JAX_RTOL)
            assert np.array_equal(a.flits, c.flits)


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
    """Every route against the plain version: the register route (every
    shape whose D is a multiple of 16 bytes, up to 16 vectors per lane),
    the wide route past it (``[2, 8192]`` in float32), the generic one
    for the rest."""
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


@pytest.mark.parametrize("q_shape,kv_shape,causal", [
    ((8, 32, 512, 112), (8, 32, 512, 112), True),   # zamba2 shared block
    ((8, 20, 1504, 64), (8, 20, 1504, 64), False),  # whisper encoder
    ((8, 20, 128, 64), (8, 20, 1504, 64), False),   # whisper cross-attention
    ((8, 20, 128, 64), (8, 20, 128, 64), True),     # whisper decoder self
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_hybrid_and_encdec_shapes(cuda, q_shape,
                                                         kv_shape, causal,
                                                         dtype):
    """B2 at zamba2-7b's head dim of 112 (the 128 builds, the bf16 one's
    tensor map zero-padding the columns) and at whisper-large-v3's three
    prefill shapes, held as above."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in (q_shape, kv_shape, kv_shape))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
    else:
        _assert_flash_bf16_close(got, want, q, k, v, causal)


@pytest.mark.parametrize("q_shape,kv_shape,causal,prefix_len", [
    ((8, 8, 768, 256), (8, 1, 768, 256), True, 256),  # paligemma prefill
    ((2, 8, 200, 256), (2, 1, 200, 256), True, 0),    # causal, ragged
    ((1, 4, 130, 256), (1, 2, 300, 256), False, 0),   # Sq < Skv
    ((2, 4, 150, 192), (2, 2, 150, 192), True, 70),   # hd 192: a box of zeros
    ((2, 4, 150, 192), (2, 2, 150, 192), False, 0),
    ((1, 2, 100, 200), (1, 2, 100, 200), True, 100),  # the prefix is all
    ((1, 2, 65, 250), (1, 1, 65, 250), True, 1),      # hd 250: ordinary loads
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_above_head_dim_128(cuda, q_shape, kv_shape, causal,
                                            prefix_len, dtype):
    """B2's hd-256 builds (head dims 129-256 run in them, the columns
    past hd zero) against the plain version: causal, non-causal and
    prefix-masked, held as above."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in (q_shape, kv_shape, kv_shape))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal,
                                 prefix_len=prefix_len)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
    else:
        _assert_flash_bf16_close(got, want, q, k, v, causal, prefix_len)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_prefix_zero_is_the_causal_kernel(cuda, dtype, hd):
    """``prefix_len = 0`` is the causal kernel bit for bit, and so is a
    prefix of 1 (``max(qpos, 0) = qpos``), through the other arithmetic
    of the limit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in ((2, 4, 333, hd), (2, 2, 333, hd), (2, 2, 333, hd)))
    want = flash_attention(q, k, v)
    for prefix_len in (0, 1):
        got = flash_attention(q, k, v, prefix_len=prefix_len)
        torch.cuda.synchronize()
        assert torch.equal(got, want), prefix_len


def test_flash_attention_bf16_hd256_build_launches(cuda):
    """The bf16 hd-256 builds (TMA and ordinary loads) launch: ptxas gave
    them the register count their setmaxnreg counts assume (else the
    wrapper raises CUDA error 200)."""
    for hd in (256, 250):
        z = torch.ones(1, 2, 64, hd, device=cuda, dtype=torch.bfloat16)
        before = flash_attention.launches
        out = flash_attention(z, z, z, prefix_len=32)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert torch.equal(out, z), hd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_at_zamba2_shape(cuda, dtype):
    """B3 at zamba2-7b's prefill block: 112 heads, N = 64 (padded into the
    N = 128 build), P = 64, one group, x and dt given."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, Nc, H, G, Q, P, N = 8, 4, 112, 1, 128, 64, 64
    dt = getattr(torch, dtype)
    x = (torch.randn(B, Nc, H, Q, P, device=cuda, generator=gen) * 0.5) \
        .to(dt)
    bm = torch.randn(B, Nc, G, Q, N, device=cuda, generator=gen).to(dt)
    cm = torch.randn(B, Nc, G, Q, N, device=cuda, generator=gen).to(dt)
    da = torch.cumsum(-0.1 * torch.rand(B, Nc, H, Q, device=cuda,
                                        generator=gen), -1)
    dts = 0.3 + torch.rand(B, Nc, H, Q, device=cuda, generator=gen)
    y, s = ssd_inner(x, bm, cm, da, dts)
    torch.cuda.synchronize()
    want_y, want_s = ssd_inner_plain(x, bm, cm, da, dts)
    if dt == torch.bfloat16:
        lim_y, lim_s = bf16_limits(x, bm, cm, da, dts)
        for got, want, lim in ((y, want_y, lim_y), (s, want_s, lim_s)):
            assert bool(((got - want).abs() <= lim).all())
        return
    for got, want in ((y, want_y), (s, want_s)):
        atol = SSD_RTOL * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=SSD_RTOL, atol=atol)


@pytest.mark.parametrize("shape,route", [
    ((4096, 3584), "register"),   # zamba2 prefill ln (14 vectors a lane)
    ((8, 3584), "register"),      # zamba2 decode
    ((4096, 7168), "wide"),       # zamba2 gated norm over d_inner
    ((8, 7168), "wide"),
    ((12032, 1280), "register"),  # whisper encoder
    ((1024, 1280), "register"),   # whisper decoder prefill
])
def test_rmsnorm_at_the_hybrid_and_encdec_shapes(cuda, shape, route):
    """B4 at zamba2-7b's and whisper-large-v3's serving shapes, in bf16 on
    the route each takes (the wide one at 7168), and a copy one element
    off a 16-byte boundary on the generic route; both at one bf16 ulp of
    the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    gamma = (1 + 0.5 * torch.randn(shape[-1], device=cuda,
                                   generator=gen)).to(torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = buf[1:].view(shape)
    shifted.copy_(x)
    assert rms_route(x, gamma)[0] == route
    assert rms_route(shifted, gamma)[0] == "generic"
    want = rmsnorm_plain(x, gamma).float()
    for out in (rmsnorm_fused(x, gamma), rmsnorm_fused(shifted, gamma)):
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want, rtol=BF16_RTOL,
                                   atol=0.0)


@pytest.mark.parametrize("shape,xdtype,gdtype", [
    ((4096, 7168), torch.bfloat16, torch.bfloat16),  # zamba2 prefill
    ((8, 7168), torch.bfloat16, torch.bfloat16),     # zamba2 decode
    ((16, 4104), torch.bfloat16, torch.float32),     # 513 vectors a row
    ((4, 4096), torch.float32, torch.float32),
])
def test_rmsnorm_wide_route_is_deterministic(cuda, shape, xdtype, gdtype):
    """The forward's wide route (a block a row, 4 vectors a thread, the
    warps' sums folded in warp order): taken past 16 vectors a lane,
    the same bits in two runs, held against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(shape, device=cuda, generator=gen).to(xdtype)
    gamma = (1 + 0.5 * torch.randn(shape[-1], device=cuda,
                                   generator=gen)).to(gdtype)
    assert rms_route(x, gamma) == ("wide", 4, 1)
    first, second = rmsnorm_fused(x, gamma), rmsnorm_fused(x, gamma)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = rmsnorm_plain(x, gamma)
    if xdtype == torch.float32:
        torch.testing.assert_close(first, want, rtol=TOL, atol=TOL)
    else:
        torch.testing.assert_close(first.float(), want.float(),
                                   rtol=BF16_RTOL, atol=0.0)


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3",
                                  "paligemma-3b"])
def test_hybrid_and_encdec_smoke_serve_on_the_card_matches_the_cpu(cuda,
                                                                   arch):
    """The smoke configs in float32 on the card and on the CPU: prefill
    logits at 1e-4 and the same greedy tokens; the prefill launches the
    kernels the family's path runs (zamba2: B2 per shared-block
    application, B3 per Mamba2 layer; whisper: B2 per encoder layer and
    twice per decoder layer; paligemma: B2 per layer, in the prefix
    mode), and none on the CPU."""
    from repro_torch.models import registry
    from repro_torch.models.common import Family
    from repro_torch.models.hybrid import hybrid_layout
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
    prompts = [[5, 17, 3, 99, 250, 7, 8, 1, 2, 3, 4, 5], [11, 12]]
    name = {Family.ENCDEC: "frames", Family.VLM: "patches"}.get(cfg.family)
    rows = cfg.encoder_frames if name == "frames" else cfg.img_tokens
    frames = np.random.default_rng(0).standard_normal(
        (3, rows, cfg.d_model)).astype(np.float32) * 0.02
    extra = {name: frames} if name else None
    if cfg.family == Family.HYBRID:
        want_b2, want_b3 = hybrid_layout(cfg)[3], cfg.n_layers
    elif cfg.family == Family.VLM:
        want_b2, want_b3 = cfg.n_layers, 0
    else:
        want_b2, want_b3 = cfg.n_encoder_layers + 2 * cfg.n_layers, 0
    runs, logits = [], []
    for dev in (cuda, torch.device("cpu")):
        model = registry.init_params(cfg, 0, dev)
        batch = {"tokens": torch.tensor([prompts[0]], device=dev)}
        if extra:
            batch[name] = torch.from_numpy(frames[:1]).to(dev)
        state = registry.make_decode_state(cfg, 1, 16 + cfg.img_tokens,
                                           device=dev)
        before = flash_attention.launches, ssd_inner.launches
        lg, _ = registry.prefill(model, batch, cfg, state)
        after = flash_attention.launches, ssd_inner.launches
        assert after == ((before[0] + want_b2, before[1] + want_b3)
                         if dev.type == "cuda" else before)
        logits.append(lg.float().cpu())
        eng = ServeEngine(cfg, model,
                          ServeConfig(batch=3, max_len=32 + cfg.img_tokens),
                          device=dev)
        out = eng.run([Request(prompt=list(p), max_new_tokens=6)
                       for p in prompts], extra=extra)
        runs.append([r.out_tokens for r in out])
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-4)
    assert runs[0] == runs[1]


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


def _hold_grads(got, plain_fn, inputs, dtype):
    """Each gradient of ``got`` against ``plain_fn(*inputs)``: a float32
    gradient at BWD_F32_RTOL of its largest entry, a bf16 one by the
    spread rule against the plain version run in float32 on the same
    inputs (``dtype``: the inputs'); a gradient the plain version does
    not give (None) the kernel does not give either."""
    want = plain_fn(*inputs)
    ref = plain_fn(*(t.float() for t in inputs)) \
        if dtype == torch.bfloat16 else want
    for g, w, r in zip(got, want, ref):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= BWD_F32_RTOL * scale
            continue
        own = float((w.float() - r).abs().max())
        gap = float((g.float() - r).abs().max())
        assert gap <= BWD_SPREAD * own, (gap, own)


BWD_SHAPES = [
    ((8, 12, 512, 128), (8, 2, 512, 128), True, 0),   # qwen2-1.5b train step
    ((2, 6, 130, 128), (2, 2, 130, 128), True, 0),    # ragged tiles, G = 3
    ((2, 4, 70, 16), (2, 2, 70, 16), True, 0),        # smoke head dim
    ((1, 3, 65, 64), (1, 1, 130, 64), False, 0),      # Sq != Skv, MQA
    ((2, 4, 200, 64), (2, 4, 200, 64), True, 100),    # prefix-LM, G = 1
    ((1, 6, 150, 72), (1, 1, 150, 72), True, 70),     # head dim 72, G = 6
    ((1, 4, 90, 20), (1, 2, 90, 20), True, 0),        # head dim 20: no TMA
    ((2, 8, 768, 256), (2, 1, 768, 256), True, 256),  # paligemma-3b, B = 2
    ((1, 8, 200, 256), (1, 1, 200, 256), True, 100),  # ragged, prefix, G = 8
    ((1, 4, 150, 192), (1, 2, 150, 192), True, 0),    # head dim 192: 256 build
    ((1, 2, 65, 256), (1, 1, 130, 256), False, 0),    # Sq != Skv at 256
    ((1, 20, 1504, 64), (1, 20, 1504, 64), False, 0),  # whisper encoder
    ((1, 20, 448, 64), (1, 20, 1504, 64), False, 0),   # whisper cross
    ((2, 24, 512, 64), (2, 8, 512, 64), True, 0),      # granite, G = 3
]


@pytest.mark.parametrize("q_shape,kv_shape,causal,prefix_len", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(cuda, q_shape, kv_shape,
                                                  causal, prefix_len, dtype):
    """bf16 takes the tensor-core route with the forward's LSE (but at
    head dim 20, which TMA cannot describe: the SIMT route), float32 the
    SIMT route, at head dims 129-256 in the 256 builds too; both held
    against the plain version, and the same bits in a second call
    without the LSE (the wrapper then runs the forward kernel for
    it)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in (q_shape, kv_shape, kv_shape))
    lse = None
    with torch.no_grad():
        if dtype == torch.bfloat16:
            o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         prefix_len=prefix_len)
        else:
            o = flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
    do = torch.randn(q_shape, device=cuda, generator=gen).to(dtype)
    tma = dtype == torch.bfloat16 and q_shape[3] % 8 == 0
    assert bwd_route(q, k, v, o, do) == ("wgmma" if tma else "simt")
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, causal=causal,
                              prefix_len=prefix_len, lse=lse)
    assert flash_attention_bwd.launches == before + 1
    torch.cuda.synchronize()
    _hold_grads(got, lambda *t: flash_attention_bwd_plain(
        *t, causal=causal, prefix_len=prefix_len), (q, k, v, o, do), dtype)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                prefix_len=prefix_len)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("q_shape,kv_shape,causal,prefix_len",
                         [s for s in BWD_SHAPES if s[0][3] % 8 == 0]
                         + [((2, 8, 768, 256), (2, 1, 768, 256), True, 256)])
def test_flash_forward_lse_output(cuda, q_shape, kv_shape, causal,
                                  prefix_len):
    """The bf16 forward asked for its LSE gives the same output bits as
    without, and an LSE within LSE_RTOL of a float32 logsumexp of the
    masked scores of the same bf16 inputs."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(torch.bfloat16)
               for s in (q_shape, kv_shape, kv_shape))
    with torch.no_grad():
        plain_out = flash_attention(q, k, v, causal=causal,
                                    prefix_len=prefix_len)
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       prefix_len=prefix_len)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    want = flash_lse_plain(q, k, causal=causal, prefix_len=prefix_len)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    gap = float(((lse - want).abs() / want.abs().clamp_min(1.0)).max())
    assert gap <= LSE_RTOL, gap


def test_bf16_gradient_through_the_function_reads_the_forwards_lse(cuda):
    """A bf16 gradient through ``flash_attention`` launches the forward
    once (with its LSE) and the backward once, and gives the bits of the
    backward wrapper called with that LSE."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(2, 6, 130, 128, device=cuda, generator=gen).bfloat16()
    k, v = (torch.randn(2, 2, 130, 128, device=cuda,
                        generator=gen).bfloat16() for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, causal=True)
    do = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, causal=True)
    want = flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,xdtype,gdtype", [
    ((4096, 1536), torch.bfloat16, torch.bfloat16),  # qwen2-1.5b train step
    ((12032, 1280), torch.bfloat16, torch.bfloat16),  # whisper's encoder
    ((3, 5, 100), torch.bfloat16, torch.float32),
    ((7, 8191), torch.float32, torch.bfloat16),
    ((1000, 7168), torch.float32, torch.float32),    # D past 48 KB of floats
    ((5, 264), torch.float32, torch.float32),
])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, xdtype, gdtype):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(shape, device=cuda, generator=gen).to(xdtype)
    gamma = (1 + 0.5 * torch.randn(shape[-1], device=cuda,
                                   generator=gen)).to(gdtype)
    dy = torch.randn(shape, device=cuda, generator=gen).to(xdtype)
    before = rmsnorm_bwd.launches
    got = rmsnorm_bwd(x, gamma, dy)
    assert rmsnorm_bwd.launches == before + 1
    torch.cuda.synchronize()
    _hold_grads(got, rmsnorm_bwd_plain, (x, gamma, dy), xdtype)


@pytest.mark.parametrize("shape,xdtype,gdtype,want", [
    ((4096, 1536), torch.bfloat16, torch.bfloat16, ("register", 6)),
    ((5, 264), torch.float32, torch.float32, ("register", 3)),
    ((3, 2048), torch.bfloat16, torch.float32, ("register", 8)),
    ((3, 5, 100), torch.bfloat16, torch.float32, ("generic", 0)),
    ((1000, 7168), torch.float32, torch.float32, ("wide", 4)),
    ((4096, 7168), torch.bfloat16, torch.bfloat16, ("wide", 4)),  # zamba2
    ((4096, 3584), torch.bfloat16, torch.bfloat16, ("wide", 2)),  # train
])
def test_rmsnorm_bwd_route_is_deterministic(cuda, shape, xdtype, gdtype,
                                            want):
    """Each route of B4's backward: the route the width picks (the wide
    one past 8 vectors a lane, as at zamba2-7b's train step), dx and
    dgamma the same bits in two runs (no atomics; every sum in a fixed
    order), held against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(shape, device=cuda, generator=gen).to(xdtype)
    gamma = (1 + 0.5 * torch.randn(shape[-1], device=cuda,
                                   generator=gen)).to(gdtype)
    dy = torch.randn(shape, device=cuda, generator=gen).to(xdtype)
    assert rms_bwd_route(x, gamma, dy) == want
    first = rmsnorm_bwd(x, gamma, dy)
    second = rmsnorm_bwd(x, gamma, dy)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _hold_grads(first, rmsnorm_bwd_plain, (x, gamma, dy), xdtype)


def test_backward_runs_the_kernels_through_the_functions(cuda):
    """A gradient through ``flash_attention`` and ``rmsnorm_fused`` on
    the card launches the backward kernels once each, and the result
    matches autograd of the plain versions in float32."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, 6, 100, 64, device=cuda, generator=gen)
    k, v = (torch.randn(2, 2, 100, 64, device=cuda, generator=gen)
            for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(64, device=cuda, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, gamma)]

    def loss(attend, norm, q, k, v, gamma):
        return norm(attend(q, k, v, causal=True), gamma).square().sum()

    before = flash_attention_bwd.launches, rmsnorm_bwd.launches
    got = torch.autograd.grad(loss(flash_attention, rmsnorm_fused, *leaves),
                              leaves)
    assert (flash_attention_bwd.launches, rmsnorm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v, gamma)]
    want = torch.autograd.grad(
        loss(flash_attention_plain, rmsnorm_plain, *plain), plain)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= BWD_F32_RTOL * float(
            w.abs().max())
    # head dim 256, which the backward builds take too: a gradient through
    # the Function, held against autograd of the plain version
    big = [torch.randn(s, device=cuda, generator=gen).requires_grad_()
           for s in ((1, 2, 70, 256), (1, 1, 70, 256), (1, 1, 70, 256))]
    before = flash_attention_bwd.launches
    got = torch.autograd.grad(
        flash_attention(*big, causal=True, prefix_len=20).square().sum(), big)
    assert flash_attention_bwd.launches == before + 1
    plain = [t.detach().clone().requires_grad_() for t in big]
    want = torch.autograd.grad(flash_attention_plain(
        *plain, causal=True, prefix_len=20).square().sum(), plain)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= BWD_F32_RTOL * float(
            w.abs().max())


SSD_BWD_SHAPES = [
    (8, 4, 24, 1, 128, 64, 128),   # mamba2-130m train step, 8 x 512 tokens
    (8, 4, 112, 1, 128, 64, 64),   # zamba2-7b train step
    (2, 3, 3, 3, 8, 16, 16),       # smoke config, one group per head
    (1, 2, 6, 2, 64, 64, 128),     # two groups
    (2, 2, 4, 2, 100, 5, 7),       # Q not a power of two, odd P and N
    (1, 1, 2, 1, 1, 5, 7),         # one row
    (4, 4, 16, 2, 100, 64, 128),   # G = 2, 4 head slices a group, Q = 100
]
#: the bf16 route of each SSD_BWD_SHAPES entry: the tensor cores wherever
#: N and P are multiples of 8 (every trained shape)
SSD_BWD_ROUTES = dict(zip(SSD_BWD_SHAPES, ["wgmma", "wgmma", "wgmma",
                                           "wgmma", "simt", "simt",
                                           "wgmma"]))


def _ssd_bwd_inputs(cuda, dtype, with_dt, B, Nc, H, G, Q, P, N, seed=2):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn(B, Nc, H, Q, P, device=cuda, generator=gen) * 0.5) \
        .to(dt)
    bm = torch.randn(B, Nc, G, Q, N, device=cuda, generator=gen).to(dt)
    cm = torch.randn(B, Nc, G, Q, N, device=cuda, generator=gen).to(dt)
    da = torch.cumsum(-0.1 * torch.rand(B, Nc, H, Q, device=cuda,
                                        generator=gen), -1)
    dts = 0.3 + torch.rand(B, Nc, H, Q, device=cuda, generator=gen) \
        if with_dt else None
    gy = torch.randn(B, Nc, H, Q, P, device=cuda, generator=gen)
    gs = torch.randn(B, Nc, H, N, P, device=cuda, generator=gen)
    return x, bm, cm, da, dts, gy, gs


@pytest.mark.parametrize("with_dt", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Nc,H,G,Q,P,N", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, with_dt, B, Nc, H, G, Q,
                                      P, N):
    """B3's backward kernels against ``ssd_inner_bwd_plain``: float32
    gradients at BWD_F32_RTOL of their largest entry, bf16 ones (gx, gB,
    gC of bf16 inputs) by the spread rule; one counted launch on the
    route the shape takes (bf16: ``SSD_BWD_ROUTES``, counted in
    ``bf16_launches`` on the tensor cores; float32: the SIMT kernels),
    and the same bits in a second call (no atomics)."""
    x, bm, cm, da, dts, gy, gs = _ssd_bwd_inputs(cuda, dtype, with_dt, B,
                                                 Nc, H, G, Q, P, N)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = SSD_BWD_ROUTES[B, Nc, H, G, Q, P, N] if dtype == "bfloat16" \
        else "simt"
    assert bwd_plan(x, bm, cm, gy, gs, sms)[0] == want
    before = ssd_inner_bwd.launches, ssd_inner_bwd.bf16_launches
    got = ssd_inner_bwd(x, bm, cm, da, gy, gs, dts)
    assert (ssd_inner_bwd.launches, ssd_inner_bwd.bf16_launches) == (
        before[0] + 1, before[1] + (want == "wgmma"))
    torch.cuda.synchronize()
    _hold_grads(got, lambda *t: ssd_inner_bwd_plain(*t, dts),
                (x, bm, cm, da, gy, gs), x.dtype)
    again = ssd_inner_bwd(x, bm, cm, da, gy, gs, dts)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_ssd_gradient_through_the_function(cuda):
    """A gradient through ``ssd_inner`` on the card launches the forward
    kernel once and the backward once, with the bits of the backward
    wrapper; the forward's output is the bits of a call under
    ``no_grad`` (the serving route)."""
    x, bm, cm, da, dts, gy, gs = _ssd_bwd_inputs(
        cuda, "bfloat16", True, 2, 2, 6, 2, 128, 64, 64, seed=3)
    leaves = [t.clone().requires_grad_() for t in (x, bm, cm, da, dts)]
    before = ssd_inner.launches, ssd_inner_bwd.launches
    y, s = ssd_inner(*leaves)
    got = torch.autograd.grad((y, s), leaves, (gy, gs))
    assert (ssd_inner.launches, ssd_inner_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        y0, s0 = ssd_inner(x, bm, cm, da, dts)
    assert torch.equal(y, y0) and torch.equal(s, s0)
    want = ssd_inner_bwd(x, bm, cm, da, gy, gs, dts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m", "zamba2-7b"])
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One float32 train step of ``arch``'s smoke config from the same
    seeded weights and batch: the loss, the gradient norm and the
    updated parameters agree (the card's own check at full width is
    chip_smoke phase 25, and for mamba2-130m phase 28)."""
    from repro_torch.launch.train import train_loop

    cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model, _, losses = train_loop(cfg, steps=2, batch=2, seq=32, seed=0,
                                      ckpt_dir=None, ckpt_every=0, lr=1e-3,
                                      device=dev)
        out[dev.type] = (losses, {n: p.detach().cpu() for n, p in
                                  model.named_parameters()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for name, p in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], p, rtol=1e-4,
                                   atol=1e-4, msg=name)
