"""The port's input shapes, roofline, traced-step costs and NIC counters
against the reference's.

``repro_torch.configs.shapes`` and ``repro_torch.analysis.roofline`` are
held equal to ``repro.configs.shapes`` and ``repro.analysis.roofline``
exactly: the same shapes and skips for every arch, the same integer
parameter and model-FLOP counts, and the same report from the same
costs on the same ``HwSpec`` numbers (the reference's
``roofline_fraction`` reads ``V5E``'s peak whatever spec it was given, so
that fraction is compared on ``V5E``'s numbers).

The costs of a traced step (``repro_torch.analysis.trace_costs``) are
held against the reference's ``parse_hlo`` on the same programs, each
side in a subprocess: a 128 x 128 product; 32 layers of it (a Python
loop in the port, the reference's trip-scaled scan); an all-reduce over
512 ranks (the port's fake world of 512, the reference's
``replica_groups=[1,512]<=[512]``); and an all-reduce over the pod dim
of 2 x 16 x 16 (rank 0's group (0, 256), the reference's
``[256,2]<=[2,256]T(1,0)``), which both classify as ``cross_pod``.
FLOPs, wire bytes, group sizes and groups are equal exactly.

``TraceCounterBackend`` is held against ``HloCounterBackend`` on the
same collectives and windows: every counter equal.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo_parse as ref_hlo
from repro.analysis import roofline as ref_roof
from repro.collectives.hlo_counters import HloCounterBackend
from repro.configs import shapes as ref_shapes
from repro.configs.registry import get_config as ref_config
from repro_torch.analysis import roofline as port_roof
from repro_torch.analysis import trace_costs as port_costs
from repro_torch.collectives.trace_counters import TraceCounterBackend
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs import shapes as port_shapes

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_skips_equal_the_reference(arch):
    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in ref_shapes.SHAPES.items()}
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name in SHAPES:
        try:
            want = ref_shapes.input_specs(rcfg, ref_shapes.SHAPES[name])
        except ref_shapes.ShapeNotSupported as e:
            with pytest.raises(port_shapes.ShapeNotSupported) as got:
                port_shapes.input_specs(cfg, SHAPES[name])
            assert str(got.value) == str(e)
            continue
        got = port_shapes.input_specs(cfg, SHAPES[name])
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].device.type == "meta"
            assert _dtype_name(got[k].dtype) == jnp.dtype(want[k].dtype).name


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_and_model_flop_counts_are_exact(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert port_roof.param_counts_analytic(cfg) == \
        ref_roof.param_counts_analytic(rcfg)
    for name in SHAPES:
        assert port_roof.model_flops_estimate(cfg, SHAPES[name]) == \
            ref_roof.model_flops_estimate(rcfg, ref_shapes.SHAPES[name])
        for chips in (256, 512):
            assert port_roof.flash_ideal_bytes_per_chip(
                cfg, SHAPES[name], chips) == \
                ref_roof.flash_ideal_bytes_per_chip(
                    rcfg, ref_shapes.SHAPES[name], chips)


#: (kind, operand bytes, result bytes, multiplier, group size, group0)
_COLLECTIVES = [
    ("all-reduce", 4 << 20, 4 << 20, 1, 16, tuple(range(16))),
    ("all-gather", 1 << 20, 16 << 20, 3, 16, tuple(range(0, 256, 16))),
    ("reduce-scatter", 8 << 20, 1 << 19, 2, 16, tuple(range(16))),
    ("all-to-all", 2 << 20, 2 << 20, 1, 16, tuple(range(16))),
    ("all-reduce", 3 << 20, 3 << 20, 5, 2, (0, 256)),
    ("collective-permute", 1 << 16, 1 << 16, 1, 2, (0, 256)),
]


def _costs(pkg):
    if pkg == "ref":
        ops = [ref_hlo.CollectiveOp(k, ob, rb, m, g, g0, "c", f"op{i}")
               for i, (k, ob, rb, m, g, g0) in enumerate(_COLLECTIVES)]
        return ref_hlo.HloCosts(
            flops=3.5e14, bytes_accessed=2.25e12, collectives=ops,
            dot_flops_by_meta={}, n_while=0, trip_counts=[],
            scope_bytes={"attn_core": 7.5e11}, scope_flops={})
    ops = [port_costs.CollectiveOp(k, ob, rb, m, g, g0, "step", f"op{i}")
           for i, (k, ob, rb, m, g, g0) in enumerate(_COLLECTIVES)]
    return port_costs.TraceCosts(
        flops=3.5e14, bytes_accessed=2.25e12, collectives=ops,
        scope_bytes={"attn_core": 7.5e11})


def _spec(pkg, hw):
    cls = ref_roof.HwSpec if pkg == "ref" else port_roof.HwSpec
    return cls(name=hw.name, peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
               ici_bw=hw.ici_bw, dcn_bw=hw.dcn_bw)


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)])
def test_roofline_terms_and_flash_adjusted_equal_the_reference(mesh):
    cfg, rcfg = get_config("llama3-8b"), ref_config("llama3-8b")
    shape, rshape = SHAPES["train_4k"], ref_shapes.SHAPES["train_4k"]
    mf = port_roof.model_flops_estimate(cfg, shape)
    for base in (port_roof.H100, ref_roof.V5E):
        got = port_roof.roofline_terms(
            _costs("port"), arch="a", shape="s", mesh_shape=mesh,
            model_flops=mf, hw=_spec("port", base))
        want = ref_roof.roofline_terms(
            _costs("ref"), arch="a", shape="s", mesh_shape=mesh,
            model_flops=mf, hw=_spec("ref", base))
        for key in ("chips", "compute_s", "memory_s", "collective_s",
                    "collective_intra_bytes", "collective_cross_bytes",
                    "hlo_flops_per_chip", "hlo_bytes_per_chip",
                    "model_flops_total", "n_collectives", "dominant",
                    "bound_s", "useful_flops_ratio"):
            assert getattr(got, key) == getattr(want, key), key
        if base is ref_roof.V5E:     # the reference's fraction reads V5E
            assert got.roofline_fraction == want.roofline_fraction
        assert got.collective_cross_bytes > 0 if len(mesh) == 3 else \
            got.collective_cross_bytes == 0
        assert port_roof.flash_adjusted(
            got, _costs("port"), cfg, shape, hw=_spec("port", base)) == \
            ref_roof.flash_adjusted(want, _costs("ref"), rcfg, rshape,
                                    hw=_spec("ref", base))


def test_counters_equal_the_reference_backend():
    mesh = (2, 16, 16)
    port = TraceCounterBackend(mesh_shape=mesh)
    ref = HloCounterBackend(mesh_shape=mesh, hw=_spec("ref", port_roof.H100))
    for window in (1e-3, 0.5, 0.0):
        port.observe_step(_costs("port"), compute_window_s=window)
        ref.observe_step(_costs("ref"), compute_window_s=window)
        assert vars(port.read_counters()) == vars(ref.read_counters())
        assert port.now_s() == ref.now_s()
    assert port.read_counters().request_flits_stalled_cycles > 0


# --------------------------------------------- traced costs against the HLO
REF_COSTS = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp
    from repro.analysis.hlo_parse import parse_hlo
    from repro.analysis.roofline import classify_collective
    f32 = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    out = {}
    c = parse_hlo(jax.jit(lambda a, b: a @ b).lower(f32, f32)
                  .compile().as_text())
    out["product"] = {"flops": c.flops}
    def layers(x, ws):
        return jax.lax.scan(lambda h, w: (h @ w, None), x, ws)[0]
    ws = jax.ShapeDtypeStruct((32, 128, 128), jnp.float32)
    c = parse_hlo(jax.jit(layers).lower(f32, ws).compile().as_text())
    out["layers"] = {"flops": c.flops, "trips": c.trip_counts}
    HLO = '''HloModule m

    %add (a: f32[], b: f32[]) -> f32[] {
      %a = f32[] parameter(0)
      %b = f32[] parameter(1)
      ROOT %s = f32[] add(f32[] %a, f32[] %b)
    }

    ENTRY %main (p: f32[1024]) -> f32[1024] {
      %p = f32[1024]{0} parameter(0)
      ROOT %ar = f32[1024]{0} all-reduce(f32[1024]{0} %p), GROUPS, to_apply=%add
    }
    '''
    for name, groups, mesh in (
            ("world", "replica_groups=[1,512]<=[512]", (512,)),
            ("pod", "replica_groups=[256,2]<=[2,256]T(1,0)", (2, 16, 16))):
        c = parse_hlo(HLO.replace("GROUPS", groups))
        op, = c.collectives
        out[name] = {"wire": op.wire_bytes() * op.multiplier,
                     "size": op.group_size,
                     "group0": list(op.group0_devices),
                     "class": classify_collective(op.group0_devices, mesh)}
    print(json.dumps(out))
""")

PORT_COSTS = textwrap.dedent("""
    import json
    import torch, torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.analysis.roofline import classify_collective
    from repro_torch.analysis.trace_costs import CostTracer
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh_for

    def traced(fn):
        with FakeTensorMode():
            tracer = CostTracer()
            with tracer:
                fn()
        return tracer.costs()

    out = {}
    c = traced(lambda: torch.zeros(128, 128) @ torch.zeros(128, 128))
    out["product"] = {"flops": c.flops}
    def layers():
        h, ws = torch.zeros(128, 128), torch.zeros(32, 128, 128)
        for w in ws:
            h = h @ w
    c = traced(layers)
    out["layers"] = {"flops": c.flops, "n_while": c.n_while}
    fake_world(512)
    mesh = make_mesh_for((2, 16, 16), ("pod", "data", "model"),
                         device_type="cpu")
    def world():
        funcol.all_reduce(torch.zeros(1024), "sum", dist.group.WORLD)
    def pod():
        x = DTensor.from_local(torch.zeros(1024), mesh,
                               [Partial(), Replicate(), Replicate()])
        x.redistribute(mesh, [Replicate()] * 3)
    for name, fn, shape in (("world", world, (512,)),
                            ("pod", pod, (2, 16, 16))):
        op, = traced(fn).collectives
        out[name] = {"wire": op.wire_bytes() * op.multiplier,
                     "size": op.group_size,
                     "group0": list(op.group0_devices),
                     "class": classify_collective(op.group0_devices, shape)}
    print(json.dumps(out))
""")


def _run(code: str, env_extra: dict) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, **env_extra)
    # files, not pipes: a full pipe would stall a process the test has
    # not read yet
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    return proc


def _result(proc) -> dict:
    proc.wait(timeout=300)
    out, err = proc.files
    out.seek(0)
    err.seek(0)
    text = out.read()
    assert proc.returncode == 0, err.read()[-4000:]
    return json.loads(text.strip().splitlines()[-1])


def test_traced_costs_equal_the_reference_hlo():
    ref = _run(REF_COSTS, {"JAX_PLATFORMS": "cpu"})
    port = _run(PORT_COSTS, {})
    want, got = _result(ref), _result(port)
    assert got["product"]["flops"] == want["product"]["flops"] \
        == 2 * 128 ** 3
    assert want["layers"]["trips"] == [32]
    assert got["layers"]["n_while"] == 0
    assert got["layers"]["flops"] == want["layers"]["flops"] \
        == 32 * 2 * 128 ** 3
    for name in ("world", "pod"):
        assert got[name] == want[name], name
    assert got["world"]["size"] == 512
    assert got["world"]["wire"] == 2 * 511 / 512 * 4096
    assert tuple(got["pod"]["group0"]) == (0, 256)
    assert got["pod"]["class"] == "cross_pod"
    assert np.isclose(got["pod"]["wire"], 4096.0)
