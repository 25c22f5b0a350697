"""The port's SSD scan (kernel B3) against the reference.

On the CPU ``ssd_inner`` runs its plain PyTorch version.  The same
numpy-seeded inputs go through the reference's Pallas ``ssd_inner``
(interpret mode), its ``ssd_scan_op`` on that kernel
(``force_kernel=True``) and the model's ``ssd_chunked``.  All are
float32 sums of at most a few hundred terms in other orders: the inner
block agrees to ``INNER_TOL = 1e-5``, the full scan (with its
exponentials and cross-chunk recurrence) to ``SCAN_TOL = 1e-4``, inside
the reference kernel test's own 3e-4.  The CUDA kernel is held against
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.

B and C come per group (``[B,Nc,G,Q,N]``, head h reading group h //
(H/G)); the reference side takes them broadcast to the heads with
``np.repeat``, as its model does.  bf16 x, B and C take the tensor-core
route, which reads x and dt apart and carries its float32 operands M
and W as three bf16 terms each: its plain version is the float32
reference, and :func:`test_bf16_route_witness` holds an emulation of
the kernel's order against it within ``bf16_limits``, the card's
tolerance.  The backward's tensor-core route carries gy, gS, M and G^
as two bf16 terms each: :func:`test_bwd_kernel_order_witness` holds an
emulation of it against the plain backward under the card's rules
(tests/test_torch_cuda.py: gdA and gdt at ``BWD_F32_RTOL`` of their
largest entry, gx, gB and gC by the spread rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan_op as ref_scan_op
from repro.kernels.ssd_scan.ref import ssd_inner_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_inner as pallas_inner
from repro.models.mamba2 import ssd_chunked as ref_chunked
from repro_torch.kernels.ssd_scan import (ssd_inner, ssd_inner_bwd,
                                          ssd_inner_bwd_plain,
                                          ssd_inner_plain, ssd_scan_op)
from repro_torch.kernels.ssd_scan.ops import (bf16_limits, bwd_slices,
                                              chunk_inputs, chunk_len)

INNER_TOL = 1e-5
SCAN_TOL = 1e-4

#: the shapes of the reference kernel test (tests/test_kernels.py)
SCAN_SHAPES = [(1, 32, 2, 8, 8, 8), (2, 64, 3, 8, 16, 16),
               (1, 128, 4, 16, 32, 32)]


def _scan_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            rng.uniform(0.1, 1.0, (B, S, H)).astype(f),
            rng.uniform(-1, 1, (H,)).astype(f),
            rng.standard_normal((B, S, H, N)).astype(f),
            rng.standard_normal((B, S, H, N)).astype(f))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Nc,H,Q,P,N", [(1, 4, 2, 8, 8, 8),
                                          (2, 2, 3, 16, 8, 16),
                                          (1, 3, 4, 32, 16, 32),
                                          (1, 1, 2, 10, 8, 8)])
def test_inner_plain_matches_pallas(B, Nc, H, Q, P, N):
    rng = np.random.default_rng(1)
    f = np.float32
    xdt = rng.standard_normal((B, Nc, H, Q, P)).astype(f)
    bm = rng.standard_normal((B, Nc, H, Q, N)).astype(f)
    cm = rng.standard_normal((B, Nc, H, Q, N)).astype(f)
    dacum = np.cumsum(-rng.uniform(0.05, 0.5, (B, Nc, H, Q)), -1).astype(f)
    want_y, want_s = pallas_inner(*_j((xdt, bm, cm, dacum)), interpret=True)
    before = ssd_inner.launches
    got_y, got_s = ssd_inner(*_t((xdt, bm, cm, dacum)))
    assert ssd_inner.launches == before          # no kernel on the CPU
    assert got_y.shape == (B, Nc, H, Q, P) and got_s.shape == (B, Nc, H, N, P)
    _close(got_y, want_y, INNER_TOL)
    _close(got_s, want_s, INNER_TOL)
    plain_y, plain_s = ssd_inner_plain(*_t((xdt, bm, cm, dacum)))
    assert torch.equal(plain_y, got_y) and torch.equal(plain_s, got_s)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SCAN_SHAPES + [
    (1, 50, 2, 8, 8, 16),        # 50 tokens: chunk of 10
    (1, 200, 2, 8, 8, 128),      # 200 tokens: chunk of 100
])
def test_scan_matches_model_and_pallas_scan(B, S, H, P, N, chunk):
    arrays = _scan_inputs(B, S, H, P, N)
    y_ref, f_ref = ref_chunked(*_j(arrays), chunk)
    y_k, f_k = ref_scan_op(*_j(arrays), chunk, force_kernel=True)
    y, f = ssd_scan_op(*_t(arrays), chunk)
    assert y.shape == (B, S, H, P) and f.shape == (B, H, N, P)
    for want_y, want_f in ((y_ref, f_ref), (y_k, f_k)):
        _close(y, want_y, SCAN_TOL)
        _close(f, want_f, SCAN_TOL)


def test_state_passing():
    B, S, H, P, N, chunk = 1, 64, 2, 8, 8, 16
    x, dt, a_log, bm, cm = _scan_inputs(B, S, H, P, N, seed=2)
    t = _t((x, dt, a_log, bm, cm))
    y_full, f_full = ssd_scan_op(*t, chunk)
    half = [a[:, :32] for a in (t[0], t[1])] + [t[2]] + \
        [a[:, :32] for a in (t[3], t[4])]
    rest = [a[:, 32:] for a in (t[0], t[1])] + [t[2]] + \
        [a[:, 32:] for a in (t[3], t[4])]
    y1, s1 = ssd_scan_op(*half, chunk)
    y2, f2 = ssd_scan_op(*rest, chunk, init_state=s1)
    _close(torch.cat([y1, y2], 1), y_full, SCAN_TOL)
    _close(f2, f_full, SCAN_TOL)
    # the same split through the reference
    j = _j((x[:, 32:], dt[:, 32:], a_log, bm[:, 32:], cm[:, 32:]))
    y2_ref, f2_ref = ref_chunked(*j, chunk, init_state=jnp.asarray(s1.numpy()))
    _close(y2, y2_ref, SCAN_TOL)
    _close(f2, f2_ref, SCAN_TOL)


def test_bf16_inputs_give_bf16_output():
    arrays = _scan_inputs(1, 32, 2, 8, 8)
    t = _t(arrays)
    t[0] = t[0].to(torch.bfloat16)
    y, f = ssd_scan_op(*t, 8)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    j = _j(arrays)
    j[0] = j[0].astype(jnp.bfloat16)
    y_ref, f_ref = ref_chunked(*j, 8)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32),
                               rtol=2.0 ** -7, atol=1e-3)
    _close(f, f_ref, SCAN_TOL)


@pytest.mark.parametrize("seq,chunk", [(512, 128), (200, 128), (50, 16),
                                       (7, 8), (97, 32)])
def test_chunk_rule_is_the_references(seq, chunk):
    q = min(chunk, seq)
    while seq % q:
        q -= 1
    assert chunk_len(seq, chunk) == q


@pytest.mark.parametrize("case", ["rank", "shape", "dtype", "strided"])
def test_inner_rejects_what_the_kernel_does_not_take(case):
    xdt = torch.zeros(1, 2, 2, 8, 4)
    bm = torch.zeros(1, 2, 2, 8, 6)
    cm = torch.zeros(1, 2, 2, 8, 6)
    da = torch.zeros(1, 2, 2, 8)
    if case == "rank":
        xdt = xdt[0]
    elif case == "shape":
        cm = torch.zeros(1, 2, 2, 8, 5)
    elif case == "dtype":
        bm = bm.double()
    else:
        da = torch.zeros(1, 2, 2, 16)[..., ::2]
    with pytest.raises(ValueError):
        ssd_inner(xdt, bm, cm, da)


def _grouped(B, Nc, H, G, Q, P, N, seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, Nc, H, Q, P)).astype(f),
            rng.standard_normal((B, Nc, G, Q, N)).astype(f),
            rng.standard_normal((B, Nc, G, Q, N)).astype(f),
            np.cumsum(-rng.uniform(0.05, 0.5, (B, Nc, H, Q)), -1).astype(f))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_grouped_inner_matches_pallas(G):
    B, Nc, H, Q, P, N = 2, 2, 4, 16, 8, 16
    xdt, bm, cm, da = _grouped(B, Nc, H, G, Q, P, N)
    rep = H // G
    want_y, want_s = pallas_inner(
        *_j((xdt, np.repeat(bm, rep, 2), np.repeat(cm, rep, 2), da)),
        interpret=True)
    got_y, got_s = ssd_inner(*_t((xdt, bm, cm, da)))
    _close(got_y, want_y, INNER_TOL)
    _close(got_s, want_s, INNER_TOL)


@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16)])
def test_grouped_scan_matches_model_and_pallas_scan(G, S, chunk):
    B, H, P, N = 2, 6, 8, 16
    x, dt, a_log, bm, cm = _scan_inputs(B, S, H, P, N, seed=4)
    bm, cm = bm[:, :, :G], cm[:, :, :G]
    rep = H // G
    ref = _j((x, dt, a_log, np.repeat(bm, rep, 2), np.repeat(cm, rep, 2)))
    y_ref, f_ref = ref_chunked(*ref, chunk)
    y_k, f_k = ref_scan_op(*ref, chunk, force_kernel=True)
    y, f = ssd_scan_op(*_t((x, dt, a_log, bm, cm)), chunk)
    for want_y, want_f in ((y_ref, f_ref), (y_k, f_k)):
        _close(y, want_y, SCAN_TOL)
        _close(f, want_f, SCAN_TOL)


def test_chunk_inputs_keep_bf16_groups():
    """bf16 x, B and C give the tensor-core route's inputs: x, B and C
    bf16, B and C per group (no copy per head), dt float32 beside x;
    float32 B or C make all three float32."""
    x, dt, a_log, bm, cm = _t(_scan_inputs(2, 32, 4, 8, 16, seed=5))
    bm, cm = bm[:, :, :2].contiguous(), cm[:, :, :2].contiguous()
    bf = [t.to(torch.bfloat16) for t in (x, bm, cm)]
    x_t, b_t, c_t, da, dt_t = chunk_inputs(bf[0], dt, a_log, bf[1], bf[2], 8)
    assert (x_t.dtype, b_t.dtype, c_t.dtype, da.dtype, dt_t.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32,
        torch.float32)
    assert b_t.shape == c_t.shape == (2, 4, 2, 8, 16)
    assert torch.equal(x_t, bf[0].reshape(2, 4, 8, 4, 8).transpose(2, 3))
    assert torch.equal(dt_t, dt.reshape(2, 4, 8, 4).transpose(2, 3))
    assert torch.equal(b_t, bf[1].reshape(2, 4, 8, 2, 16).transpose(2, 3))
    mixed = chunk_inputs(bf[0], dt, a_log, bm, cm, 8)
    assert all(t.dtype == torch.float32 for t in mixed)
    assert torch.equal(mixed[0], x_t.float())


#: bf16 witness shapes: the mamba2-130m prefill's cell (one group, 24
#: heads, cut to 2 chunks), a 200-token prompt's chunk of 100, odd sizes
WITNESS = [(1, 2, 24, 1, 128, 64, 128), (1, 1, 4, 2, 100, 64, 128),
           (2, 1, 3, 3, 9, 5, 7)]


def _bf16_inputs(B, Nc, H, G, Q, P, N, seed=0):
    """bf16 x, B, C and float32 dacum, dt as a prefill makes them: dt
    about 1 (softplus around 0), A from -1 to -16."""
    rng = np.random.default_rng(seed)
    f = np.float32
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((B, Nc, H, Q, P)).astype(f)) \
        .to(bf)
    bm, cm = (torch.from_numpy(rng.standard_normal((B, Nc, G, Q, N))
                               .astype(f)).to(bf) for _ in range(2))
    dt = rng.uniform(0.3, 2.0, (B, Nc, H, Q)).astype(f)
    da = np.cumsum(-dt * rng.uniform(1.0, 16.0, (1, 1, H, 1)), -1)
    return x, bm, cm, torch.from_numpy(da.astype(f)), torch.from_numpy(dt)


def _split3(v):
    """``v`` as three bf16 terms, each the rounding of what the ones
    before leave, as the kernel splits its float32 operands."""
    terms = []
    for _ in range(3):
        terms.append(v.bfloat16().float())
        v = v - terms[-1]
    return terms


def _kernel_order(x, bm, cm, da, dt):
    """The tensor-core kernel's function in plain torch: C.B^T summed in
    k16 steps, exp2 of the difference of dA times log2(e), M and W (with
    dt_j) as their three bf16 terms, y and the states summed term by
    term."""
    B, Nc, H, Q, P = x.shape
    G = bm.shape[2]
    split = (B, Nc, G, H // G)
    xf = x.float().reshape(*split, Q, P)
    b = bm.float()[:, :, :, None]
    c = cm.float()[:, :, :, None]
    d = da.reshape(*split, Q)
    t = dt.reshape(*split, Q)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    s = sum(torch.matmul(c[..., k:k + 16], b[..., k:k + 16].transpose(-1, -2))
            for k in range(0, b.shape[-1], 16))
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    m = s * torch.where(causal, torch.exp2((d[..., :, None] - d[..., None, :])
                                           * log2e), 0.0) * t[..., None, :]
    w = (torch.exp2((d[..., -1:] - d) * log2e) * t)[..., None] * xf
    m3, w3 = _split3(m), _split3(w)
    for v, terms in ((m, m3), (w, w3)):   # the float32 value, but for
        gap = sum(u.double() for u in terms) - v.double()  # bf16 underflow
        assert float(gap.abs().max()) < 2.0 ** -120
    y = sum(torch.matmul(mu, xf) for mu in m3)
    st = sum(torch.matmul(b.transpose(-1, -2), wu) for wu in w3)
    return y.reshape(B, Nc, H, Q, P), st.reshape(B, Nc, H, -1, P)


@pytest.mark.parametrize("shape", WITNESS)
def test_bf16_route_witness(shape):
    """The witness behind the tensor-core route's card tolerance
    (``bf16_limits``): its plain version on bf16 inputs is the float32
    reference on x * dt formed in float32, and the kernel's order,
    emulated, is within the limit of it (``-s`` prints the largest gap as
    a share of its limit)."""
    x, bm, cm, da, dt = _bf16_inputs(*shape)
    y, st = ssd_inner(x, bm, cm, da, dt)
    assert y.dtype == st.dtype == torch.float32
    plain = ssd_inner_plain(x, bm, cm, da, dt)
    assert all(torch.equal(a, b) for a, b in zip((y, st), plain))
    lim_y, lim_s = bf16_limits(x, bm, cm, da, dt)
    xdt = x.float() * dt[..., None]
    ref_y, ref_s = ssd_inner_plain(xdt, bm.float(), cm.float(), da)
    emu_y, emu_s = _kernel_order(x, bm, cm, da, dt)
    shares = {}
    for name, (got, want, lim) in {
            "reference y": (y, ref_y, lim_y),
            "reference states": (st, ref_s, lim_s),
            "kernel order y": (emu_y, y, lim_y),
            "kernel order states": (emu_s, st, lim_s)}.items():
        gap = (got - want).abs()
        shares[name] = float((gap / lim.clamp_min(1e-30)).max())
        assert bool((gap <= lim).all()), (name, shares[name])
    print(f"{shape}: largest gap as a share of its limit {shares}")


@pytest.mark.parametrize("operand", ["M", "W"])
@pytest.mark.parametrize("terms", [1, 2])
def test_bf16_fewer_terms_exceed_or_approach_the_limit(operand, terms):
    """What the three terms buy: M or W as one bf16 term puts y or the
    states far outside the limit; as two, within it but at a share many
    times the kernel order's."""
    x, bm, cm, da, dt = _bf16_inputs(*WITNESS[0])
    y, st = ssd_inner(x, bm, cm, da, dt)
    lim_y, lim_s = bf16_limits(x, bm, cm, da, dt)
    B, Nc, H, Q, P = x.shape
    d = da.reshape(B, Nc, 1, H, Q)
    t = dt.reshape(B, Nc, 1, H, Q)
    xf = x.float().reshape(B, Nc, 1, H, Q, P)
    b = bm.float()[:, :, :, None]
    if operand == "M":
        causal = torch.ones(Q, Q, dtype=torch.bool).tril()
        m = torch.matmul(cm.float()[:, :, :, None], b.transpose(-1, -2)) * \
            torch.where(causal, torch.exp(d[..., :, None] - d[..., None, :]),
                        0.0) * t[..., None, :]
        got = torch.matmul(sum(_split3(m)[:terms]), xf).reshape(y.shape) - y
        lim = lim_y
    else:
        w = (torch.exp(d[..., -1:] - d) * t)[..., None] * xf
        got = torch.matmul(b.transpose(-1, -2), sum(_split3(w)[:terms])) \
            .reshape(st.shape) - st
        lim = lim_s
    share = float((got.abs() / lim.clamp_min(1e-30)).max())
    if terms == 1:
        assert share > 4.0, share
    else:
        assert 0.005 < share <= 1.0, share


@pytest.mark.parametrize("case", ["groups", "mixed", "mixed_c", "dacum",
                                  "dt"])
def test_inner_refuses_bad_groups_and_mixed_dtypes(case):
    bf = torch.bfloat16
    xdt = torch.zeros(1, 2, 4, 8, 4, dtype=bf)
    bm = torch.zeros(1, 2, 2, 8, 6, dtype=bf)
    cm = torch.zeros(1, 2, 2, 8, 6, dtype=bf)
    da = torch.zeros(1, 2, 4, 8)
    if case == "groups":
        bm, cm = torch.zeros(1, 2, 3, 8, 6, dtype=bf), \
            torch.zeros(1, 2, 3, 8, 6, dtype=bf)
    elif case == "mixed":
        bm = bm.float()
    elif case == "mixed_c":
        xdt, bm = xdt.float(), bm.float()
    elif case == "dacum":
        da = da.to(bf)
    with pytest.raises(ValueError):
        ssd_inner(xdt, bm, cm, da, da.to(bf) if case == "dt" else None)


def test_scan_refuses_groups_that_do_not_divide_the_heads():
    x, dt, a_log, bm, cm = _t(_scan_inputs(1, 16, 4, 8, 8))
    with pytest.raises(ValueError, match="groups"):
        ssd_scan_op(x, dt, a_log, bm[:, :, :3], cm[:, :, :3], 8)


# ------------------------------------------------------------- backward
#: the plain backward against autograd of the plain forward (both float32
#: sums of at most a few hundred terms in other orders), against
#: ``jax.vjp`` of the reference's ``ssd_inner_ref`` and, through the whole
#: scan, ``jax.grad`` of its ``ssd_chunked``: each gradient within this
#: share of its largest entry
BWD_TOL = 1e-5
SCAN_BWD_TOL = 1e-4


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bwd_inputs(B, Nc, H, G, Q, P, N, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    xdt = rng.standard_normal((B, Nc, H, Q, P)).astype(f)
    bm, cm = (rng.standard_normal((B, Nc, G, Q, N)).astype(f)
              for _ in range(2))
    da = np.cumsum(-rng.uniform(0.05, 0.5, (B, Nc, H, Q)), -1).astype(f)
    dt = rng.uniform(0.1, 1.0, (B, Nc, H, Q)).astype(f)
    gy = rng.standard_normal((B, Nc, H, Q, P)).astype(f)
    gs = rng.standard_normal((B, Nc, H, N, P)).astype(f)
    return xdt, bm, cm, da, dt, gy, gs


@pytest.mark.parametrize("with_dt", [False, True])
@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("Q", [16, 13])
def test_inner_bwd_plain_matches_autograd(G, Q, with_dt):
    """The explicit formulas against ``torch.autograd`` of
    ``ssd_inner_plain``, float32, for one group, one per head and one in
    between, with and without dt, Q a power of two and not."""
    xdt, bm, cm, da, dt, gy, gs = _t(_bwd_inputs(2, 2, 6, G, Q, 8, 12,
                                                 seed=G + Q))
    dt = dt if with_dt else None
    leaves = [t.clone().requires_grad_() for t in (xdt, bm, cm, da)] + \
        ([dt.clone().requires_grad_()] if with_dt else [])
    y, s = ssd_inner_plain(*leaves[:4], leaves[4] if with_dt else None)
    want = torch.autograd.grad((y, s), leaves, (gy, gs))
    got = ssd_inner_bwd_plain(xdt, bm, cm, da, gy, gs, dt)
    assert (got[4] is None) == (not with_dt)
    for name, g, w in zip(("x", "b", "c", "dacum", "dt"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _gap(g, w) <= BWD_TOL, (name, _gap(g, w))


def test_inner_bwd_plain_matches_reference_vjp():
    """G = H, the reference kernel's per-head contract: the plain
    backward against ``jax.vjp`` of ``ssd_inner_ref``."""
    xdt, bm, cm, da, _, gy, gs = _bwd_inputs(2, 3, 4, 4, 16, 8, 16, seed=3)
    _, vjp = jax.vjp(ssd_inner_ref, *_j((xdt, bm, cm, da)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    got = ssd_inner_bwd_plain(*_t((xdt, bm, cm, da, gy, gs)))
    for name, g, w in zip(("xdt", "b", "c", "dacum"), got, want):
        assert _gap(g, w) <= BWD_TOL, (name, _gap(g, w))


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16)])
def test_scan_gradients_match_reference(G, S, chunk):
    """Every input's gradient of the whole scan (``ssd_scan_op`` through
    B3's autograd Function, its plain backward here) against
    ``jax.grad`` of the reference's ``ssd_chunked`` (B and C broadcast
    to the heads there, so a group's gradient is its heads' sum), for a
    random cotangent of y and of the final state and an initial state."""
    B, H, P, N = 2, 6, 8, 16
    x, dt, a_log, bm, cm = _scan_inputs(B, S, H, P, N, seed=6)
    bm, cm = bm[:, :, :G], cm[:, :, :G]
    rng = np.random.default_rng(7)
    init = rng.standard_normal((B, H, N, P)).astype(np.float32)
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gf = rng.standard_normal((B, H, N, P)).astype(np.float32)
    rep = H // G

    def ref_loss(x, dt, a_log, bm, cm, init):
        y, f = ref_chunked(x, dt, a_log, jnp.repeat(bm, rep, 2),
                           jnp.repeat(cm, rep, 2), chunk, init_state=init)
        return jnp.sum(y * gy) + jnp.sum(f * gf)

    want = jax.grad(ref_loss, argnums=tuple(range(6)))(
        *_j((x, dt, a_log, bm, cm, init)))
    leaves = [t.requires_grad_() for t in _t((x, dt, a_log, bm, cm, init))]
    before = ssd_inner.launches
    y, f = ssd_scan_op(*leaves[:5], chunk, init_state=leaves[5])
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (f * torch.from_numpy(gf)).sum(),
        leaves)
    assert ssd_inner.launches == before           # no kernel on the CPU
    for name, g, w in zip(("x", "dt", "a_log", "b", "c", "init"), got, want):
        assert _gap(g, w) <= SCAN_BWD_TOL, (name, _gap(g, w))


def test_bwd_refuses_gradients_of_another_shape_or_dtype():
    xdt, bm, cm, da, dt, gy, gs = _t(_bwd_inputs(1, 1, 2, 1, 8, 4, 6,
                                                 seed=1))
    with pytest.raises(ValueError, match="gstates"):
        ssd_inner_bwd(xdt, bm, cm, da, gy, gs[..., :3].contiguous(), dt)
    with pytest.raises(ValueError, match="float32"):
        ssd_inner_bwd(xdt, bm, cm, da, gy.double(), gs, dt)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_inner_bwd(xdt, bm, cm, da, gy.transpose(3, 4).contiguous()
                      .transpose(3, 4), gs, dt)


# ------------------------------------------------ backward, tensor cores
#: the card's rules for a backward kernel (tests/test_torch_cuda.py): a
#: float32 gradient within BWD_F32_RTOL of its largest entry, a bf16 one
#: within BWD_SPREAD times the bf16 plain version's own gap to the plain
#: version run in float32
BWD_F32_RTOL = 1e-4
BWD_SPREAD = 2.0
#: mamba2-130m's and zamba2-7b's head, chunk and state widths (H, G, Q, P,
#: N) at their train steps, batch and chunks cut to 1
BWD_WITNESS = [(24, 1, 128, 64, 128), (112, 1, 128, 64, 64)]
#: the bf16 terms of each float32 operand on the tensor-core route
BWD_TERMS = {"gy": 2, "gS": 2, "M": 2, "G": 2}
#: the multiprocessors of an H100 SXM, whose grid the witness emulates
H100_SMS = 132


def _bwd_bf16_inputs(H, G, Q, P, N, seed=0):
    """``_bf16_inputs`` at one batch and chunk, and float32 gy and gS."""
    x, bm, cm, da, dt = _bf16_inputs(1, 1, H, G, Q, P, N, seed)
    rng = np.random.default_rng(seed + 1)
    f = np.float32
    gy = torch.from_numpy(rng.standard_normal((1, 1, H, Q, P)).astype(f))
    gs = torch.from_numpy(rng.standard_normal((1, 1, H, N, P)).astype(f))
    return x, bm, cm, da, dt, gy, gs


def _bwd_kernel_order(x, bm, cm, da, dt, gy, gs, slices, terms=BWD_TERMS):
    """The backward's tensor-core route in plain torch: S^T = B C^T in k16
    steps, decays as exp2 of the dA difference times log2(e), dt folded
    into row and column scales (x exact), gy, gS, M^T and G^ as their
    ``terms`` bf16 terms (M^T gy without the product of the two last
    terms), G^ and gB's state term summed over each slice's heads and
    then over the ``slices`` in order; gx, gB and gC rounded to bf16."""
    B, Nc, H, Q, P = x.shape
    G, N = bm.shape[2], bm.shape[-1]
    rep = H // G
    split = (B, Nc, G, rep)
    xf = x.float().reshape(*split, Q, P)
    b = bm.float()[:, :, :, None]
    c = cm.float()[:, :, :, None]
    d = da.reshape(*split, Q)
    t = dt.reshape(*split, Q)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    st = sum(torch.matmul(b[..., k:k + 16], c[..., k:k + 16].transpose(-1, -2))
             for k in range(0, N, 16))                      # [j, i]
    causal = torch.ones(Q, Q, dtype=torch.bool).triu()      # i >= j
    lt = torch.where(causal, torch.exp2((d[..., None, :] - d[..., :, None])
                                        * log2e), 0.0)
    mt = st * lt
    e = torch.exp2((d[..., -1:] - d) * log2e)
    gy_t = _split3(gy.reshape(*split, Q, P))[:terms["gy"]]
    gs_t = _split3(gs.reshape(*split, N, P))[:terms["gS"]]
    g = sum(torch.matmul(xf, u.transpose(-1, -2)) for u in gy_t) * \
        t[..., :, None]                                     # gM^T
    rt = g * mt
    m_t = _split3(mt)[:terms["M"]]
    top = max(terms["M"], terms["gy"]) - 1
    gu = sum(torch.matmul(m_t[a], gy_t[u]) for a in range(terms["M"])
             for u in range(terms["gy"]) if a + u <= top)
    bgs = sum(torch.matmul(b, u) for u in gs_t)
    r = e * t * (xf * bgs).sum(-1)
    gu = gu + e[..., None] * bgs
    w = sum(torch.matmul(xf, u.transpose(-1, -2)) for u in gs_t)
    hb = rep // slices

    def over_heads(v):                 # per slice in head order, then slices
        parts = [sum(v[:, :, :, k] for k in range(s * hb, (s + 1) * hb))
                 for s in range(slices)]
        return sum(parts[1:], parts[0])

    ght = over_heads(g * lt)
    sb = over_heads((e * t)[..., None] * w)
    g_t = _split3(ght)[:terms["G"]]
    gb = sum(torch.matmul(u, cm.float()) for u in g_t) + sb
    gc = sum(torch.matmul(u.transpose(-1, -2), bm.float()) for u in g_t)
    ga = rt.sum(-2) - rt.sum(-1) - r
    ga[..., -1] += r.sum(-1)
    return ((gu * t[..., None]).reshape(x.shape).bfloat16(), gb.bfloat16(),
            gc.bfloat16(), ga.reshape(da.shape),
            (gu * xf).sum(-1).reshape(dt.shape))


def _bwd_shares(got, x, bm, cm, da, dt, gy, gs):
    """Each gradient's largest gap as a share of its card limit."""
    want = ssd_inner_bwd_plain(x, bm, cm, da, gy, gs, dt)
    ref = ssd_inner_bwd_plain(x.float(), bm.float(), cm.float(), da, gy, gs,
                              dt)
    shares = {}
    for name, g, w, r in zip(("gx", "gB", "gC", "gdA", "gdt"), got, want,
                             ref):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            shares[name] = float((g - w).abs().max()) / (
                BWD_F32_RTOL * float(w.abs().max()))
        else:
            own = float((w.float() - r).abs().max())
            shares[name] = float((g.float() - r).abs().max()) / (
                BWD_SPREAD * own)
    return shares


@pytest.mark.parametrize("shape", BWD_WITNESS)
def test_bwd_kernel_order_witness(shape):
    """The witness behind the backward tensor-core route's terms: its
    arithmetic, emulated with the slices of the train step's grid (4 on
    132 SMs), is within the card's limits of the plain backward on the
    same bf16 inputs (``-s`` prints each gradient's share of its
    limit; gx, gB and gC round once at the end, so their share is the
    plain bf16 run's own, 0.5)."""
    H, G = shape[:2]
    slices = bwd_slices(8 * 4, H, G, H100_SMS)
    assert slices == 4
    ins = _bwd_bf16_inputs(*shape)
    shares = _bwd_shares(_bwd_kernel_order(*ins, slices), *ins)
    print(f"{shape}: share of each limit {shares}")
    assert all(v <= 1.0 for v in shares.values()), shares


@pytest.mark.parametrize("operand", sorted(BWD_TERMS))
@pytest.mark.parametrize("shape", BWD_WITNESS)
def test_bwd_fewer_terms_exceed_or_approach_the_limit(shape, operand):
    """What the second term buys: gy, gS or M^T as one bf16 term puts gdA
    or gdt (float32 gradients) past its limit; G^ as one term moves gB
    and gC from the plain bf16 run's own share (0.5, the rounding) to
    most of their limit."""
    H, G = shape[:2]
    slices = bwd_slices(8 * 4, H, G, H100_SMS)
    ins = _bwd_bf16_inputs(*shape)
    full = _bwd_shares(_bwd_kernel_order(*ins, slices), *ins)
    cut = _bwd_shares(_bwd_kernel_order(*ins, slices,
                                        dict(BWD_TERMS, **{operand: 1})),
                      *ins)
    if operand == "G":
        assert max(cut["gB"], cut["gC"]) > 0.65, cut
        assert max(full["gB"], full["gC"]) <= 0.51, full
    else:
        assert max(cut["gdA"], cut["gdt"]) > 1.0, cut
