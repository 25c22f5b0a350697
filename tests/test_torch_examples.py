"""The port's user-facing entry points on the CPU:
``repro_torch.examples.{quickstart,serve_lm,train_lm,
noise_aware_collectives}`` (at their own sizes, which are the
reference's; train_lm cut to 3 steps) and the figure runner
``repro_torch.benchmarks.run`` (its reduced pass); and
``repro_torch.benchmarks.h100_selector`` against the reference's
``benchmarks/tpu_selector.py`` size for size, given the reference's
``V5E`` values as its ``HwSpec`` (read from the reference object here;
the port carries no TPU figure).
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import tpu_selector as ref_tpu_selector  # noqa: E402
from repro.analysis.roofline import V5E  # noqa: E402
from repro_torch.analysis import HwSpec  # noqa: E402
from repro_torch.benchmarks import h100_selector  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.examples import (noise_aware_collectives,  # noqa: E402
                                  quickstart, serve_lm, train_lm)

SMALL_ARIES = "aries:n_groups=4,chassis_per_group=2,blades_per_chassis=4"


def rows_of(text: str, prefix: str) -> dict:
    """``name -> (value, derived)`` of the CSV rows whose name starts
    with ``prefix``."""
    out = {}
    for line in text.splitlines():
        if line.startswith(prefix):
            name, value, derived = line.split(",", 2)
            out[name[len(prefix):]] = (float(value), derived)
    return out


def test_quickstart_trains_serves_and_routes():
    got = quickstart.main(["--device", "cpu"])
    vocab = get_smoke_config("qwen2-1.5b").vocab
    losses = got["losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert len(got["generated"]) == 4
    assert all(len(t) == 8 and all(0 <= x < vocab for x in t)
               for t in got["generated"])
    assert sorted(got["medians"]) == ["ADAPTIVE_0", "ADAPTIVE_3",
                                      "app_aware"]
    assert all(np.isfinite(m) and m > 0 for m in got["medians"].values())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-large-v3"])
def test_serve_lm_goes_through_the_launcher(arch, capsys):
    out = serve_lm.main(["--arch", arch, "--device", "cpu"])
    assert len(out) == 4
    assert all(len(r.out_tokens) == 12 for r in out)
    assert f"[serve] {arch} on cpu: 4 requests, 48 tokens" in \
        capsys.readouterr().out


def test_train_lm_trains_the_demo_config(tmp_path):
    losses = train_lm.main(["--device", "cpu", "--steps", "3", "--batch",
                            "2", "--seq", "16", "--ckpt-dir",
                            str(tmp_path)])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert train_lm.default_cfg().name == "demo-15m"


def test_noise_aware_collectives_prints_the_outcome_as_it_is():
    got = noise_aware_collectives.main(["--device", "cpu"])
    for size in (1024, 65536):
        row = got["dragonfly"][size]
        assert sorted(row) == ["ADAPTIVE_0", "ADAPTIVE_3", "app_aware",
                               "eps_greedy"]
        assert row["ADAPTIVE_0"] == 1.0
        assert all(np.isfinite(v) and v > 0 for v in row.values())
    h100 = got["h100"]
    assert h100["modes"] == {4 << 10: "hierarchical", 1 << 20: "direct",
                             32 << 20: "direct", 512 << 20: "direct"}
    # only the first step's 16 of 512 buckets go hierarchically
    assert h100["saved_pct"] == pytest.approx(
        100 * 16 / 512 * (1 - 1 / 511), rel=1e-9)


def test_figure_runner_runs_selector_and_model(capsys):
    bench_run.main(["--only", "selector,model", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "name,us_per_call,derived"
    sweep = rows_of(out, "h100_selector.sweep.")
    assert len(sweep) == 21
    assert rows_of(out, "h100_selector.crossover_bytes")[""][0] == 4096.0
    model = rows_of(out, "model_validation.")
    assert len(model) == 7
    assert all(np.isfinite(v) and -100 <= v <= 100
               for v, _ in model.values())


def test_figure_runner_takes_the_topology_and_refuses_unknown_suites(
        capsys):
    bench_run.main(["--only", "fig7", "--device", "cpu", "--topology",
                    SMALL_ARIES])
    assert "fig7." in capsys.readouterr().out
    with pytest.raises(SystemExit):
        bench_run.main(["--only", "tpu", "--device", "cpu"])
    assert set(bench_run.suites()) == {
        "fig3", "table1", "fig4fig5", "fig7", "fig8", "fig10", "model",
        "selector", "perf", "interference"}


def _v5e() -> HwSpec:
    return HwSpec(name=V5E.name, peak_flops=V5E.peak_flops,
                  hbm_bw=V5E.hbm_bw, ici_bw=V5E.ici_bw, dcn_bw=V5E.dcn_bw)


def test_h100_selector_sweep_matches_the_reference_at_equal_spec():
    got, want = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(got):
        flips = h100_selector.crossover_sweep(_v5e())
        h100_selector.grad_reduce_savings(_v5e())
    with contextlib.redirect_stdout(want):
        ref_flips = ref_tpu_selector.crossover_sweep()
        ref_tpu_selector.grad_reduce_savings()
    assert [(s, m.name) for s, m in flips] == \
        [(s, m.name) for s, m in ref_flips]
    mine = rows_of(got.getvalue(), "h100_selector.")
    ref = rows_of(want.getvalue(), "tpu_selector.")
    assert mine == ref and len(mine) == 25


def test_h100_selector_settles_on_direct_at_the_h100_spec():
    flips = dict(h100_selector.crossover_sweep())
    assert [s for s, m in flips.items() if m.name == "HIERARCHICAL"] == \
        [4096]
    saved = h100_selector.grad_reduce_savings()
    assert saved["app_aware_gib"] < saved["direct_gib"]
    assert saved["saving_pct"] < 1.0
