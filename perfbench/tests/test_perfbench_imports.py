"""Nothing the harness runs loads JAX or the JAX package (``repro``,
judged by whole top-level module names: the port's ``repro_torch``
begins with it), and ``run.py`` prints no result without a card."""

from __future__ import annotations

import subprocess
import sys
import textwrap

from perfbench import spec

ROOT = spec.ROOT

PROBE = textwrap.dedent("""
    import sys
    sys.path[:0] = [{root!r}, {src!r}]
    import torch
    from perfbench import control, judge, profiling, run, spec, weights
    from perfbench.tests.smoke_cells import smoke_cell
    for name in {cells!r}:
        cell = smoke_cell(name)
        spec.kind(cell.traffic).run(cell, 3, 0.2, True,
                                    torch.device("cpu"), 0.0)
        for metric in cell.per_layer:
            spec.metric_reader(metric["name"])
    print(sorted({{m.split(".", 1)[0] for m in sys.modules}}
                 & {{"jax", "jaxlib", "flax", "repro"}}))
""")


def test_a_run_loads_no_jax():
    cells = [w["name"] for w in
             spec.read_json(spec.BENCHMARK)["workloads"]]
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), cells=cells)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    saved = dict(sys.modules)
    try:
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_probe"] = sys
        assert "repro" not in run.forbidden_loaded()
        sys.modules["repro.models"] = sys
        assert run.forbidden_loaded() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _cli(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "zamba2-7b.train-8x512", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
