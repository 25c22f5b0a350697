"""The plain references against the port's models on the CPU at SMOKE
sizes in float32: the same leaves, the same loss, logits and gradients
from the same weights."""

from __future__ import annotations

import pytest
import torch

from perfbench import spec, weights
from perfbench.tests.smoke_cells import smoke_cell

CELLS = ("granite-moe-3b-a800m.train-8x512", "zamba2-7b.train-8x512")


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_port(workload):
    from repro_torch.models import registry
    from repro_torch.train.train_step import TrainConfig, value_and_grad

    cell = smoke_cell(workload)
    m, ref = cell.model, spec.reference(cell.model)
    cfg = spec.model_config(m)
    model = spec.builder(cell.config)(cfg, device="cpu")
    params = dict(model.named_parameters())
    shapes = ref.param_shapes(m)
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: tuple(s) for n, s in shapes.items()}
    weights.fill(params, 2 ** 31 + 11, cell.init)
    rp = weights.make(shapes, 2 ** 31 + 11, "cpu", cell.init)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, m["vocab"], (2, 32), generator=gen)
    labels = torch.randint(0, m["vocab"], (2, 32), generator=gen)
    loss, _, grads = value_and_grad(model, {"tokens": toks,
                                            "labels": labels}, cfg,
                                    TrainConfig(z_loss=1e-4))
    for p in rp.values():
        p.requires_grad_(True)
    rl = ref.train_loss(rp, toks, labels, m, "f32", 1e-4)
    rg = dict(zip(rp, torch.autograd.grad(rl, list(rp.values()))))
    assert float(loss) == pytest.approx(float(rl.detach()), rel=1e-6)
    for name, g in rg.items():
        scale = float(g.abs().max()) + 1e-12
        assert float((grads[name] - g).abs().max()) <= 1e-4 * scale, name
    with torch.no_grad():
        logits, _ = registry.train_forward(model, {"tokens": toks}, cfg)
        want, _ = ref.forward(rp, toks, m, "f32")
    torch.testing.assert_close(logits.float(), want, rtol=1e-5, atol=1e-5)


def test_serve_segments_match_the_engine():
    """Prefill and a decode step through the port's cache against the
    reference's forward over prompt and token, grouped by call."""
    from repro_torch.models import registry

    from perfbench.kinds.serve import call_segments

    cell = smoke_cell("granite-moe-3b-a800m.serve-chunk2048")
    m, ref = cell.model, spec.reference(cell.model)
    cfg = spec.model_config(m)
    model = spec.builder(cell.config)(cfg, device="cpu")
    weights.fill(dict(model.named_parameters()), 9)
    rp = weights.make(ref.param_shapes(m), 9, "cpu")
    toks = torch.randint(0, m["vocab"], (2, 24),
                         generator=torch.Generator().manual_seed(4))
    state = registry.make_decode_state(cfg, 2, 26, device="cpu")
    lg0, state = registry.prefill(model, {"tokens": toks}, cfg, state)
    nxt = lg0[:, -1, :m["vocab"]].argmax(-1)[:, None].to(torch.int32)
    lg1, _ = registry.decode_step(model, nxt, cfg, state)
    full = torch.cat([toks, nxt.long()], 1)
    want = ref.logits_at(rp, full, m, "f32", [23, 24], call_segments(24, 2))
    torch.testing.assert_close(torch.cat([lg0, lg1], 1).float(), want,
                               rtol=1e-5, atol=1e-5)


def test_weights_repeat_by_seed_and_name():
    shapes = {"blocks.0.attn.wq": (8, 4), "blocks.1.attn.wq": (8, 4),
              "embed": (16, 8), "blocks.0.ln1": (8,)}
    a = weights.make(shapes, 2 ** 32 + 1, "cpu")
    b = weights.make(dict(reversed(list(shapes.items()))), 2 ** 32 + 1,
                     "cpu")
    for n in shapes:
        torch.testing.assert_close(a[n], b[n], rtol=0, atol=0)
    assert not torch.equal(a["blocks.0.attn.wq"], a["blocks.1.attn.wq"])
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.3)
    assert float(a["blocks.0.attn.wq"].std()) == pytest.approx(8 ** -0.5,
                                                             rel=0.4)
    assert torch.equal(a["blocks.0.ln1"], torch.ones(8))


def test_dt_range_gives_the_published_time_steps():
    """A configuration's ``init.dt_range`` sets ``dt_bias`` so that
    ``softplus(dt_bias)`` is log-spaced over the range; without it the
    time step is 1."""
    shapes = {"main.0.0.mamba.dt_bias": (5,), "main.0.1.mamba.dt_bias": (5,)}
    got = weights.make(shapes, 3, "cpu", {"dt_range": [0.001, 0.1]})
    for t in got.values():
        torch.testing.assert_close(
            torch.nn.functional.softplus(t.double()),
            torch.logspace(-3, -1, 5, dtype=torch.float64), rtol=1e-6,
            atol=0)
    plain = weights.make(shapes, 3, "cpu")["main.0.0.mamba.dt_bias"]
    torch.testing.assert_close(torch.nn.functional.softplus(plain),
                               torch.ones(5))
