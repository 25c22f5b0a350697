"""The port's sharding rules and elastic restart against the reference's.

Placements.  For every arch in ``ARCHS`` at full size (the port's
parameters made under ``FakeTensorMode``, the reference's by
``jax.eval_shape``: nothing is allocated), on the meshes (4, 4)
("data", "model") and (2, 2, 4) ("pod", "data", "model"), under the
default, ``fsdp=True`` and ``expert_parallel=False`` policies, each port
parameter's placements are read back as a spec (the mesh dims that shard
each tensor dim) and held against the reference's ``PartitionSpec``:

  * equal to the reference's rules on the unstacked leaf, for every
    leaf (``repro.sharding.partition._spec_for_leaf`` on the leaf with
    its layer dims taken off);
  * equal to the reference's spec of its stacked leaf with the layer
    dims dropped, wherever that spec leaves the layer dims whole.  Where
    it does not, the reference's rules read a stacked layer dim as a
    role: qwen2-moe-a2.7b's shared expert, a ``[L, D, F]`` leaf under
    ``moe``, takes the experts' rule, and its L (24) is sharded over
    "model".  The port's layers are separate tensors; it keeps the
    unstacked rule there.  The test pins that those are the only
    leaves.

The same for ``input_specs_sharding`` over every shape, and for
``decode_state_specs`` at the smoke configs (8 rows, and one row, whose
cache spreads its positions over the data dims), leaf by leaf; the
port's SSM state is a list of per-layer states, so there the
reference's rules are applied to the per-layer leaves.  Each side runs
in a subprocess: the port in a fake world of 16 ranks, the reference on
16 forced host devices.

Elastic restart.  A smoke llama3-8b checkpoint, drawn by the reference,
is resharded onto (2, 2) and (1, 4) meshes by both: the port in a gloo
world of 4 processes (``reshard_checkpoint`` of the port's state dict
and AdamW moments), the reference on 4 forced host devices.  Each
rank's local shard equals bit for bit the reference's addressable shard
of the same layer on the device at the rank's mesh coordinate, and
``full_tensor()`` equals the host array.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

MESHES = {"4x4": ((4, 4), ("data", "model")),
          "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}
POLICIES = ("default", "fsdp", "no_ep")
#: the leaves whose stacked reference spec shards a layer dim
STACKED_DIM_SHARDED = {"qwen2-moe-a2.7b": {"blocks.moe.shared.w_in",
                                           "blocks.moe.shared.w_gate",
                                           "blocks.moe.shared.w_out"}}

COMMON = textwrap.dedent("""
    import json, sys
    from dataclasses import replace
    MESHES = {"4x4": ((4, 4), ("data", "model")),
              "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}
    POLICIES = ("default", "fsdp", "no_ep")
    STATES = ((8, 32), (1, 64))
    def policy_of(base, name):
        if name == "fsdp":
            return replace(base, fsdp=True)
        if name == "no_ep":
            return replace(base, expert_parallel=False)
        return base
    def norm(entry):
        if entry is None:
            return None
        return list(entry) if isinstance(entry, (tuple, list)) else [entry]
""")

PORT_SPECS = COMMON + textwrap.dedent("""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import (ARCHS, SHAPES, ShapeNotSupported,
                                     get_config, get_smoke_config,
                                     input_specs)
    from repro_torch.launch.dryrun import _build, fake_world
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry
    from repro_torch.sharding.partition import (
        decode_state_specs, default_policy, input_specs_sharding,
        param_specs, spec_of)

    def spec(pl, mesh, ndim):
        return [norm(e) for e in spec_of(pl, mesh, ndim)]

    def leaves(tree, pls, out):
        if isinstance(tree, torch.Tensor):
            out.append(spec(pls, MESH, tree.ndim))
        elif isinstance(tree, (tuple, list)):
            for t, p in zip(tree, pls):
                leaves(t, p, out)
        return out

    fake_world(16)
    out = {}
    models = {}
    with FakeTensorMode():
        for arch in ARCHS:
            models[arch] = _build(get_config(arch))
    for mname, (shape, axes) in MESHES.items():
        MESH = mesh = make_mesh_for(shape, axes, device_type="cpu")
        for pname in POLICIES:
            pol = policy_of(default_policy(mesh), pname)
            for arch in ARCHS:
                cfg = get_config(arch)
                named = dict(models[arch].named_parameters())
                specs = param_specs(models[arch], cfg, mesh, pol)
                out[f"params/{mname}/{pname}/{arch}"] = {
                    n: spec(p, mesh, named[n].ndim)
                    for n, p in specs.items()}
                for sname, shp in SHAPES.items():
                    try:
                        ins = input_specs(cfg, shp)
                    except ShapeNotSupported:
                        continue
                    got = input_specs_sharding(ins, cfg, mesh, pol)
                    out[f"inputs/{mname}/{pname}/{arch}/{sname}"] = {
                        k: spec(p, mesh, ins[k].ndim)
                        for k, p in got.items()}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            pol = default_policy(mesh)
            for b, s in STATES:
                st = registry.make_decode_state(cfg, b, s, device="cpu")
                out[f"state/{mname}/{arch}/{b}"] = leaves(
                    st, decode_state_specs(st, cfg, mesh, pol), [])
    print(json.dumps(out))
""")

REF_SPECS = COMMON + textwrap.dedent("""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.configs import (ARCHS, SHAPES, ShapeNotSupported, get_config,
                               get_smoke_config, input_specs)
    from repro.models import registry
    from repro.sharding.partition import (
        _spec_for_leaf, decode_state_specs, default_policy,
        input_specs_sharding, param_specs)

    STACK = {"blocks": 1, "enc_blocks": 1, "dec_blocks": 1, "main": 2,
             "trailing": 1}

    def spec(s, ndim):
        entries = list(s) + [None] * (ndim - len(s))
        return [norm(e) for e in entries]

    def name_of(path):
        return ".".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path)

    out = {}
    params = {a: jax.eval_shape(
        lambda a=a: registry.init_params(get_config(a), 0)) for a in ARCHS}
    for mname, (shape, axes) in MESHES.items():
        mesh = compat.make_mesh(shape, axes)
        for pname in POLICIES:
            pol = policy_of(default_policy(mesh), pname)
            for arch in ARCHS:
                cfg = get_config(arch)
                specs = param_specs(params[arch], cfg, mesh, pol)
                flat = jax.tree_util.tree_flatten_with_path(params[arch])[0]
                sflat = jax.tree_util.tree_leaves(specs)
                got = {}
                for (path, leaf), sh in zip(flat, sflat):
                    n = name_of(path)
                    k = STACK.get(n.split(".")[0], 0)
                    unstacked = jax.ShapeDtypeStruct(leaf.shape[k:],
                                                     leaf.dtype)
                    got[n] = {"stacked": spec(sh.spec, leaf.ndim),
                              "layers": k,
                              "unstacked": spec(_spec_for_leaf(
                                  path, unstacked, mesh, pol, cfg),
                                  leaf.ndim - k)}
                out[f"params/{mname}/{pname}/{arch}"] = got
                for sname, shp in SHAPES.items():
                    try:
                        ins = input_specs(cfg, shp)
                    except ShapeNotSupported:
                        continue
                    sh = input_specs_sharding(ins, cfg, mesh, pol)
                    out[f"inputs/{mname}/{pname}/{arch}/{sname}"] = {
                        k: spec(v.spec, ins[k].ndim) for k, v in sh.items()}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            pol = default_policy(mesh)
            for b, s in STATES:
                st = jax.eval_shape(
                    lambda: registry.make_decode_state(cfg, b, s))
                if type(st).__name__ == "SSMDecodeState":
                    # the port keeps one state per layer
                    L = jax.tree_util.tree_leaves(st.states)[0].shape[0]
                    st = [jax.tree_util.tree_map(
                        lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype),
                        st.states)] * L
                sh = decode_state_specs(st, cfg, mesh, pol)
                out[f"state/{mname}/{arch}/{b}"] = [
                    spec(s_.spec, x.ndim) for x, s_ in zip(
                        jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(sh)) if x.ndim]
    print(json.dumps(out))
""")


def _start(code: str, devices: int = 0) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    # files, not pipes: a full pipe would stall a process the test has
    # not read yet
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    return proc


def _result(proc) -> dict:
    proc.wait(timeout=600)
    out, err = proc.files
    out.seek(0)
    err.seek(0)
    text = out.read()
    assert proc.returncode == 0, err.read()[-4000:]
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def specs():
    port, ref = _start(PORT_SPECS), _start(REF_SPECS, devices=16)
    return _result(port), _result(ref)


def _layer_name(name: str) -> str:
    return ".".join(p for p in name.split(".") if not p.isdigit())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
def test_parameter_placements_equal_the_reference(specs, mesh, policy):
    got_all, want_all = specs
    checked = 0
    for key, got in got_all.items():
        if not key.startswith(f"params/{mesh}/{policy}/"):
            continue
        arch = key.rsplit("/", 1)[1]
        want = want_all[key]
        assert {_layer_name(n) for n in got} == set(want), arch
        layer_sharded = set()
        for name, spec in got.items():
            ref = want[_layer_name(name)]
            assert spec == ref["unstacked"], (arch, name)
            k = ref["layers"]
            if any(ref["stacked"][:k]):
                layer_sharded.add(_layer_name(name))
                continue
            assert spec == ref["stacked"][k:], (arch, name)
            checked += 1
        quirk = STACKED_DIM_SHARDED.get(arch, set()) \
            if policy != "no_ep" else set()
        assert layer_sharded == quirk, (arch, layer_sharded)
    assert checked > 1000


@pytest.mark.parametrize("mesh", list(MESHES))
def test_input_and_state_placements_equal_the_reference(specs, mesh):
    got_all, want_all = specs
    keys = [k for k in want_all
            if k.startswith((f"inputs/{mesh}/", f"state/{mesh}/"))]
    assert set(keys) == {k for k in got_all
                         if k.startswith((f"inputs/{mesh}/",
                                          f"state/{mesh}/"))}
    for key in keys:
        assert got_all[key] == want_all[key], key
    # the one-row caches spread their positions over the data dims
    assert any(any(e and "data" in e for e in leaf)
               for leaf in got_all[f"state/{mesh}/zamba2-7b/1"])


# ------------------------------------------------------------ elastic
ELASTIC_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}

REF_ELASTIC = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro import compat
    from repro.ckpt.elastic import reshard_checkpoint
    from repro.configs import get_smoke_config
    from repro.models import registry
    out_dir = sys.argv[1]
    cfg = get_smoke_config("llama3-8b")
    params = registry.init_params(cfg, 0)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    def name(path):
        return "/".join(str(k.key) for k in path)
    np.savez(f"{out_dir}/host.npz",
             **{name(p): np.asarray(x) for p, x in flat})
    shards = {}
    for mname, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
        mesh = compat.make_mesh(shape, ("data", "model"))
        placed = reshard_checkpoint(params, cfg, mesh)
        devices = list(mesh.devices.flat)
        for (path, _), arr in zip(flat, jax.tree_util.tree_leaves(placed)):
            by_dev = {s.device: s.data for s in arr.addressable_shards}
            for rank, dev in enumerate(devices):
                shards[f"{mname}/{name(path)}/{rank}"] = \\
                    np.asarray(by_dev[dev])
    np.savez(f"{out_dir}/ref_shards.npz", **shards)
    print("{}")
""")

PORT_ELASTIC = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def nested(flat):
        tree = {}
        for key, value in flat.items():
            node = tree
            *parts, leaf = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = value
        return tree

    def run(rank, store, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=store, rank=rank,
                                world_size=4)
        from repro_torch.ckpt import reshard_checkpoint
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models.convert import dense_state_dict
        from repro_torch.train.optimizer import AdamWState
        cfg = get_smoke_config("llama3-8b")
        host = dict(np.load(f"{out_dir}/host.npz"))
        state = {k: v.numpy() for k, v in
                 dense_state_dict(nested(host), cfg).items()}
        tree = (state, AdamWState(step=3, m=state, v=state))
        shards, bad = {}, []
        for mname, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
            mesh = make_mesh_for(shape, ("data", "model"), device_type="cpu")
            placed = reshard_checkpoint(tree, cfg, mesh)
            assert placed[1].step == 3
            for part, got in (("params", placed[0]), ("m", placed[1].m),
                              ("v", placed[1].v)):
                for name, t in got.items():
                    shards[f"{mname}/{part}/{name}"] = \\
                        t.to_local().numpy().copy()
                    if not np.array_equal(t.full_tensor().numpy(),
                                          state[name]):
                        bad.append(f"{mname} {part} {name}")
        np.savez(f"{out_dir}/port_{rank}.npz", **shards)
        with open(f"{out_dir}/bad_{rank}.txt", "w") as f:
            f.write("\\n".join(bad))
        dist.destroy_process_group()

    if __name__ == "__main__":
        out_dir = sys.argv[1]
        mp.spawn(run, args=(f"file://{out_dir}/store", out_dir), nprocs=4)
""")


def test_reshard_checkpoint_places_the_reference_shards(tmp_path):
    ref = _start(REF_ELASTIC.replace("sys.argv[1]", repr(str(tmp_path))),
                 devices=4)
    _result(ref)
    script = tmp_path / "port_elastic.py"
    script.write_text(PORT_ELASTIC)
    env = dict(os.environ, PYTHONPATH=SRC)
    port = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert port.returncode == 0, port.stderr[-4000:]
    want = np.load(tmp_path / "ref_shards.npz")
    n = 0
    for rank in range(4):
        assert (tmp_path / f"bad_{rank}.txt").read_text() == ""
        got = np.load(tmp_path / f"port_{rank}.npz")
        for key in got.files:
            mname, part, name = key.split("/", 2)
            parts = name.split(".")
            layer = next((int(p) for p in parts if p.isdigit()), None)
            ref_key = "/".join(p for p in parts if not p.isdigit())
            ref = want[f"{mname}/{ref_key}/{rank}"]
            if layer is not None:
                ref = ref[layer]
            assert got[key].dtype == np.float32
            assert np.array_equal(got[key], ref), (rank, key)
            n += 1
    # every parameter and both moments, on both meshes, on every rank
    assert n == 4 * len(got.files) and len(got.files) % 6 == 0
    host = np.load(tmp_path / "host.npz")
    assert got["1x4/params/embed"].shape[0] * 4 == host["embed"].shape[0]
