"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) at smoke
size, against the reference's sharding arithmetic.

In a fake world of 8 ranks, on the meshes (2, 4) ("data", "model") and
(2, 2, 2) ("pod", "data", "model"), every arch x shape cell runs at its
smoke config (train 8 x 32, prefill 8 x 32, decode 8 rows over a
64-slot cache, long_500k one row over 128): each ends ``ok``, or is
skipped where the reference skips (``long_500k`` without
``supports_long_context``).  Each cell's per-rank argument bytes
(``mem_args_bytes``: parameters, AdamW moments, the batch and the
decode state) equal exactly the reference's sum of
``sharding.shard_shape`` bytes over the same leaves on 8 forced host
devices (the optimizer's step and the decode position are host ints in
the port and are left out of both; the port keeps the SSM state per
layer, so there the reference's rules are applied to the per-layer
leaves, as tests/test_torch_sharding.py holds them).  The port's cells
run in one subprocess, the reference's in another, side by side.

On (1, 8), where heads do not divide the model dim, whisper's smoke
config (q over its positions, the cross-attention's too) and a mamba2 of
4 heads of 32 (its SSD scan whole on every model rank) run every kind of
step.

At world 1, the per-rank FLOPs of the dense smoke train step equal a
count made here from its shapes: every projection three times (forward,
and the two products of its backward), the attention core's products
at the kernel's plain versions (q.k^T and P.V forward, q.k^T again for
the LSE the bf16 backward reads, five products backward).

Importing the dry run or the mesh module starts no process group, and
a production mesh without a world of its size raises.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

COMMON = textwrap.dedent("""
    import json, sys
    MESHES = {"2x4": ((2, 4), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
    #: kind -> (sequence, rows); long_500k: one row
    SMALL = {"train": (32, 8), "prefill": (32, 8), "decode": (64, 8)}
    def small(shapes_mod, name):
        s = shapes_mod.SHAPES[name]
        seq, rows = (128, 1) if s.global_batch == 1 else SMALL[s.kind]
        return shapes_mod.InputShape(s.name, seq, rows, s.kind)
""")

PORT_CELLS = COMMON + textwrap.dedent("""
    import logging
    logging.disable(logging.WARNING)
    from repro_torch.configs import ARCHS, SHAPES, get_smoke_config, shapes
    from repro_torch.launch.dryrun import lower_cell
    out = {m: {} for m in MESHES}
    for mname, mesh in MESHES.items():
        for arch in ARCHS:
            for name in SHAPES:
                try:
                    rep, costs = lower_cell(get_smoke_config(arch),
                                            small(shapes, name),
                                            mesh_override=mesh)
                except shapes.ShapeNotSupported:
                    out[mname][f"{arch}/{name}"] = {"status": "skipped"}
                    continue
                out[mname][f"{arch}/{name}"] = {
                    k: rep[k] for k in ("status", "mem_args_bytes", "fsdp",
                                        "microbatch", "hlo_flops_scaled",
                                        "mem_total_gb", "n_collectives",
                                        "attn_scope_bytes")}
    # heads that do not divide "model": whisper's 4 (q over its
    # positions, the cross-attention too), and a mamba2 of 4 heads of 32
    # (the SSD scan whole on every "model" rank)
    odd = {"whisper-large-v3": get_smoke_config("whisper-large-v3"),
           "mamba2-130m": get_smoke_config("mamba2-130m").scaled(
               ssm_head_dim=32)}
    out["odd"] = {}
    for arch, cfg in odd.items():
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            rep, _ = lower_cell(cfg, small(shapes, name),
                                mesh_override=((1, 8), ("data", "model")))
            out["odd"][f"{arch}/{name}"] = rep["status"]
    cfg = get_smoke_config("qwen2-1.5b")
    rep, costs = lower_cell(cfg, shapes.InputShape("train", 16, 2, "train"),
                            mesh_override=((1, 1), ("data", "model")))
    out["world1"] = {"flops": costs.flops, "mesh": rep["mesh"],
                     "collectives": [c.wire_bytes()
                                     for c in costs.collectives]}
    print(json.dumps(out))
""")

REF_ARGS = COMMON + textwrap.dedent("""
    import math
    import jax, numpy as np
    from repro import compat
    from repro.configs import ARCHS, SHAPES, get_smoke_config, shapes
    from repro.models import registry
    from repro.models.common import Family
    from repro.sharding.partition import (decode_state_specs,
                                          default_policy,
                                          input_specs_sharding, param_specs)

    def nbytes(leaves, shardings):
        return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                   for x, s in zip(leaves, shardings) if x.ndim)

    out = {}
    for mname, (mshape, axes) in MESHES.items():
        mesh = compat.make_mesh(mshape, axes)
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            pol = default_policy(mesh)
            params = jax.eval_shape(lambda: registry.init_params(cfg, 0))
            pb = nbytes(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(
                            param_specs(params, cfg, mesh, pol)))
            for name in SHAPES:
                shape = small(shapes, name)
                try:
                    specs = shapes.input_specs(cfg, shape)
                except shapes.ShapeNotSupported:
                    out[f"{mname}/{arch}/{name}"] = "skipped"
                    continue
                ins = input_specs_sharding(specs, cfg, mesh, pol)
                total = nbytes([specs[k] for k in specs],
                               [ins[k] for k in specs])
                if shape.kind == "train":
                    total += 3 * pb           # masters, m, v
                else:
                    extra = cfg.img_tokens if cfg.family == Family.VLM \\
                        else 0
                    st = jax.eval_shape(lambda: registry.make_decode_state(
                        cfg, shape.global_batch, shape.seq_len + extra))
                    if type(st).__name__ == "SSMDecodeState":
                        L = jax.tree_util.tree_leaves(
                            st.states)[0].shape[0]
                        st = [jax.tree_util.tree_map(
                            lambda x: jax.ShapeDtypeStruct(x.shape[1:],
                                                           x.dtype),
                            st.states)] * L
                    total += pb + nbytes(
                        jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(
                            decode_state_specs(st, cfg, mesh, pol)))
                out[f"{mname}/{arch}/{name}"] = total
    print(json.dumps(out))
""")


def _start(code: str, *args, devices: int = 0) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    # files, not pipes: a full pipe would stall a process the test has
    # not read yet
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    return proc


def _result(proc) -> dict:
    proc.wait(timeout=900)
    out, err = proc.files
    out.seek(0)
    err.seek(0)
    text = out.read()
    assert proc.returncode == 0, err.read()[-4000:]
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    port, ref = _start(PORT_CELLS), _start(REF_ARGS, devices=8)
    return _result(port), _result(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_cell_runs_or_is_skipped_where_the_reference_skips(runs,
                                                                 mesh):
    port, ref = runs
    cells = port[mesh]
    assert len(cells) == 40
    for key, rep in cells.items():
        want = ref[f"{mesh}/{key}"]
        if want == "skipped":
            assert rep["status"] == "skipped", key
            continue
        assert rep["status"] == "ok", key
        assert rep["hlo_flops_scaled"] > 0 and rep["n_collectives"] > 0, key
        assert not rep["fsdp"] and rep["microbatch"] == 0, key
    skipped = sorted(k for k, v in cells.items() if v["status"] == "skipped")
    assert len(skipped) == 8 and all(k.endswith("long_500k")
                                     for k in skipped)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_argument_bytes_equal_the_reference_shards(runs, mesh):
    port, ref = runs
    for key, rep in port[mesh].items():
        if rep["status"] != "ok":
            continue
        assert rep["mem_args_bytes"] == ref[f"{mesh}/{key}"], key


def test_heads_that_do_not_divide_the_model_dim(runs):
    """On (1, 8): whisper's smoke config (4 heads) and a mamba2 of 4
    heads of 32 run every kind of step."""
    assert runs[0]["odd"] == {f"{a}/{n}": "ok"
                              for a in ("whisper-large-v3", "mamba2-130m")
                              for n in ("train_4k", "prefill_32k",
                                        "decode_32k")}


def test_world_of_one_counts_the_dense_train_step_flops(runs):
    """qwen2-1.5b's smoke train step at B = 2, S = 16 on one rank."""
    got = runs[0]["world1"]
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-1.5b")
    b, s = 2, 16
    t, d, f, hd = b * s, cfg.d_model, cfg.d_ff, cfg.hd
    h, hkv, v = cfg.n_heads, cfg.n_kv_heads, cfg.vocab_padded
    linear = cfg.n_layers * (2 * t * d * (h + 2 * hkv) * hd   # q, k, v
                             + 2 * t * h * hd * d             # wo
                             + 3 * 2 * t * d * f)             # in, gate, out
    linear += 2 * t * d * v                                   # the head
    core = 2 * b * h * s * s * hd                             # one product
    want = 3 * linear + cfg.n_layers * (3 + 5) * core
    assert got["mesh"] == "1x1"
    assert got["flops"] == want
    assert all(w == 0 for w in got["collectives"])


def test_importing_starts_no_world_and_a_mesh_needs_one():
    probe = textwrap.dedent("""
        import torch.distributed as dist
        import repro_torch.launch.dryrun, repro_torch.launch.mesh as m
        assert not dist.is_initialized()
        try:
            m.make_production_mesh(device_type="cpu")
        except RuntimeError as e:
            print("raised:", e)
        repro_torch.launch.dryrun.fake_world(8)
        try:
            m.make_production_mesh(device_type="cpu")
        except RuntimeError as e:
            print("raised:", e)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2
    assert "none is running" in lines[0]
    assert "256 ranks; the world has 8" in lines[1]
