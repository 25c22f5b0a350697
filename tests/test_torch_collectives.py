"""The port's collective schedules and expert-parallel MoE on a gloo world
of 4 against the reference on 4 forced host devices.

One world of 4 processes (``torch.multiprocessing.spawn``, gloo, a
``file://`` store) and one reference subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
tests/test_sharding_collectives_multidev.py runs it) are started once
for the module, side by side, on the same inputs; each case below then
compares their outputs.  Two meshes of 4, with the reference's axis
names: ``pod2_data2`` = (pod 2, data 2, model 1) and ``pod2_model2`` =
(pod 2, data 1, model 2).  Rank r sits at mesh coordinate r
(row-major), which is the reference's shard r of a dim split over
("pod", "data", "model").

Tolerances: the schedules move and sum float32 values, 1e-6 relative
(the sums of 2-4 terms in other orders); ``moe_ep`` is float32 math in
other orders, ``EP_TOL = 2e-5``; ``aux`` 1e-6.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

MESHES = {"pod2_data2": (2, 2, 1), "pod2_model2": (2, 1, 2)}
INNER = {"pod2_data2": "data", "pod2_model2": "model"}
SUM_TOL = 1e-6
EP_TOL = 2e-5
WORLD = 4

#: inputs both sides load: the all-reduce and all-to-all inputs per
#: rank, and the MoE weights and tokens (tests/test_moe_grad_comm.py's
#: moe_cfg in float32, x [4, 16, 32] from default_rng(0))
COMMON = textwrap.dedent("""
    import numpy as np
    MESHES = {"pod2_data2": (2, 2, 1), "pod2_model2": (2, 1, 2)}
    INNER = {"pod2_data2": "data", "pod2_model2": "model"}
    NAMES = ("pod", "data", "model")
    def moe_kw():
        return dict(name="t", n_layers=1, d_model=32, n_heads=4,
                    n_kv_heads=2, d_ff=64, d_ff_expert=64, vocab=128,
                    n_experts=8, top_k=2, remat=False, moe_impl="ep")
""")

WORLD_SCRIPT = COMMON + textwrap.dedent("""
    import os, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, store, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=store, rank=rank,
                                world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.collectives import (
            CollectiveMode, allreduce_direct, allreduce_hierarchical,
            alltoall_direct, alltoall_hierarchical, grad_allreduce)
        from repro_torch.collectives.moe_ep import (local_experts, moe_ep,
                                                    moe_ep_ref)
        from repro_torch.models import attention, transformer
        from repro_torch.models.common import Family, ModelConfig, rmsnorm
        from repro_torch.models.moe import MoE, moe_weights
        inp = np.load(os.path.join(out_dir, "inputs.npz"))
        cfg = ModelConfig(family=Family.MOE, dtype=torch.float32,
                          **moe_kw())
        m = MoE(cfg)
        m.load_state_dict({k: torch.from_numpy(inp["moe/" + k])
                           for k in ("router", "w_in", "w_gate", "w_out")})
        w = moe_weights(m, cfg)
        out = {}
        for name, shape in MESHES.items():
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
            inner = INNER[name]
            x = torch.from_numpy(inp["ar"][rank])
            out[f"{name}/ar_direct"] = allreduce_direct(x, mesh,
                                                        ("pod", "data"))
            out[f"{name}/ar_hier"] = allreduce_hierarchical(x, mesh, "pod",
                                                            "data")
            y = torch.from_numpy(inp["a2a"][rank])
            once = alltoall_direct(y, mesh, inner)
            out[f"{name}/a2a_direct"] = once
            out[f"{name}/a2a_twice"] = alltoall_direct(once, mesh, inner)
            out[f"{name}/a2a_hier"] = alltoall_hierarchical(y, mesh, "pod",
                                                            inner)
            for mode in CollectiveMode:
                g = grad_allreduce(
                    {"ones": torch.ones(8, 4),
                     "g": torch.from_numpy(inp["grad"][rank])},
                    mesh, mode=mode)
                out[f"{name}/grad_ones_{mode.value}"] = g["ones"]
                out[f"{name}/grad_{mode.value}"] = g["g"]
            coord = np.unravel_index(rank, shape)
            n_dp = shape[0] * shape[1]
            dp = coord[0] * shape[1] + coord[1]
            xs = torch.from_numpy(inp["moe_x"]).reshape(
                n_dp, -1, 16, 32)[dp]
            wl = local_experts(w, mesh, "model")
            for mode in CollectiveMode:
                yy, aux = moe_ep(wl, xs, cfg, mesh, mode=mode)
                out[f"{name}/ep_{mode.value}"] = yy
                out[f"{name}/ep_aux_{mode.value}"] = aux
            out[f"{name}/ep_ref"] = moe_ep_ref(w, xs, cfg)[0]
            # a block with moe_impl="ep" on this mesh: attention, then
            # moe_ep (DIRECT) on the rank's shard with its experts
            blk = {"ln1": torch.ones(32), "ln2": torch.ones(32),
                   "wqkv": torch.from_numpy(inp["wqkv"]),
                   "wo": torch.from_numpy(inp["wo"]), "moe": w}
            pos = torch.arange(16, dtype=torch.int32)[None].expand(
                xs.shape[0], 16)
            got, _ = transformer.block_forward(blk, xs, cfg, pos, mesh=mesh)
            h = rmsnorm(xs, blk["ln1"], cfg.norm_eps)
            q, k, v = attention.qkv_project(blk, h, cfg, pos)
            x1 = xs + attention.attn_output(
                blk, attention.flash_attend(q, k, v), cfg)
            want = x1 + moe_ep_ref(w, rmsnorm(x1, blk["ln2"], cfg.norm_eps),
                                   cfg)[0]
            out[f"{name}/block_gap"] = (got - want).abs().max()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.numpy() for k, v in out.items()})
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        out_dir = sys.argv[1]
        mp.spawn(run, args=("file://" + os.path.join(out_dir, "store"),
                            out_dir), nprocs=4, join=True)
""")

REF_SCRIPT = COMMON + textwrap.dedent("""
    import os, sys
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.collectives import (allreduce_direct, allreduce_hierarchical,
                                   alltoall_direct, alltoall_hierarchical,
                                   grad_allreduce)
    from repro.collectives.modes import CollectiveMode
    from repro.collectives.moe_ep import moe_ep, moe_ep_ref
    from repro.models.common import Family, ModelConfig

    out_dir = sys.argv[1]
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    cfg = ModelConfig(family=Family.MOE, dtype=jnp.float32, **moe_kw())
    p = {k: jnp.asarray(inp["moe/" + k])
         for k in ("router", "w_in", "w_gate", "w_out")}
    x_moe = jnp.asarray(inp["moe_x"])
    out = {}
    ALL = P(("pod", "data", "model"))
    for name, shape in MESHES.items():
        mesh = compat.make_mesh(shape, NAMES)
        inner = INNER[name]

        def run(fn, v):
            return np.asarray(compat.shard_map(
                fn, mesh=mesh, in_specs=ALL, out_specs=ALL,
                check_vma=False)(v))

        ar = inp["ar"].reshape(-1, *inp["ar"].shape[2:])
        out[f"{name}/ar_direct"] = run(
            lambda v: allreduce_direct(v, ("pod", "data")), ar)
        out[f"{name}/ar_hier"] = run(
            lambda v: allreduce_hierarchical(v, "pod", "data",
                                             shape[1]), ar)
        a2a = inp["a2a"].reshape(-1, inp["a2a"].shape[-1])
        out[f"{name}/a2a_direct"] = run(
            lambda v: alltoall_direct(v, inner), a2a)
        out[f"{name}/a2a_hier"] = run(
            lambda v: alltoall_hierarchical(v, "pod", inner), a2a)
        for mode in CollectiveMode:
            g = grad_allreduce({"w": jnp.ones((8, 4))}, mesh, mode=mode)
            out[f"{name}/grad_ones_{mode.value}"] = np.asarray(g["w"])
        with compat.set_mesh(mesh):
            for mode in CollectiveMode:
                y, aux = jax.jit(lambda p, x, mode=mode: moe_ep(
                    p, x, cfg, mode=mode))(p, x_moe)
                out[f"{name}/ep_{mode.value}"] = np.asarray(y)
                out[f"{name}/ep_aux_{mode.value}"] = np.asarray(aux)
        n_dp = shape[0] * shape[1]
        out[f"{name}/ep_ref"] = np.concatenate([
            np.asarray(moe_ep_ref(p, xs, cfg)[0])
            for xs in jnp.split(x_moe, n_dp)])
    np.savez(os.path.join(out_dir, "reference.npz"), **out)
""")


def _inputs(path):
    from repro.models.common import Family, ModelConfig
    from repro.models.moe import init_moe
    ns = {}
    exec(COMMON, ns)
    cfg = ModelConfig(family=Family.MOE, **ns["moe_kw"]())
    p = init_moe(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    arrays = {"moe_x": rng.standard_normal((4, 16, 32)).astype(np.float32)}
    arrays.update({f"moe/{k}": np.asarray(v, np.float32)
                   for k, v in p.items()})
    rng = np.random.default_rng(1)
    arrays.update(
        ar=rng.standard_normal((WORLD, 5, 3)).astype(np.float32),
        a2a=rng.standard_normal((WORLD, 8, 3)).astype(np.float32),
        grad=rng.standard_normal((WORLD, 6, 5)).astype(np.float32),
        wqkv=(rng.standard_normal((32, 64)) / np.sqrt(32)).astype(
            np.float32),
        wo=(rng.standard_normal((32, 32)) / np.sqrt(32)).astype(
            np.float32))
    np.savez(os.path.join(path, "inputs.npz"), **arrays)
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the gloo world and the reference side by side; returns
    (inputs, the world's outputs by rank, the reference's)."""
    path = str(tmp_path_factory.mktemp("collectives"))
    inputs = _inputs(path)
    procs = []
    for name, script, env in (
            ("world", WORLD_SCRIPT, {}),
            ("reference", REF_SCRIPT,
             {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})):
        file = os.path.join(path, f"{name}.py")
        with open(file, "w") as f:
            f.write(script)
        procs.append(subprocess.Popen(
            [sys.executable, file, path], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                     **env)))
    for proc in procs:
        out, err = proc.communicate(timeout=560)
        assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    world = [dict(np.load(os.path.join(path, f"rank{r}.npz")))
             for r in range(WORLD)]
    ref = dict(np.load(os.path.join(path, "reference.npz")))
    return inputs, world, ref


def _stack(world, key):
    return np.stack([w[key] for w in world])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_allreduce_schedules_agree_with_reference(runs, mesh):
    """DIRECT equals HIERARCHICAL equals the reference's and the sum over
    (pod, data) (tests/test_sharding_collectives_multidev.py:75)."""
    inputs, world, ref = runs
    shape = MESHES[mesh]
    want = inputs["ar"].reshape(shape + (5, 3)).sum(axis=(0, 1),
                                                    keepdims=True)
    want = np.broadcast_to(want, shape + (5, 3)).reshape(WORLD, 5, 3)
    for key in ("ar_direct", "ar_hier"):
        got = _stack(world, f"{mesh}/{key}")
        np.testing.assert_allclose(got, want, rtol=SUM_TOL, atol=SUM_TOL)
        np.testing.assert_allclose(
            got, ref[f"{mesh}/{key}"].reshape(WORLD, 5, 3), rtol=SUM_TOL,
            atol=SUM_TOL)
    np.testing.assert_allclose(_stack(world, f"{mesh}/ar_direct"),
                               _stack(world, f"{mesh}/ar_hier"),
                               rtol=SUM_TOL, atol=SUM_TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_alltoall_round_trip_and_reference(runs, mesh):
    """The direct exchange twice is the identity; once, and the
    hierarchical exchange, equal the reference's outputs bit for bit
    (:96)."""
    inputs, world, ref = runs
    np.testing.assert_array_equal(_stack(world, f"{mesh}/a2a_twice"),
                                  inputs["a2a"])
    for key in ("a2a_direct", "a2a_hier"):
        np.testing.assert_array_equal(
            _stack(world, f"{mesh}/{key}"),
            ref[f"{mesh}/{key}"].reshape(WORLD, 8, 3))
    assert not np.array_equal(_stack(world, f"{mesh}/a2a_hier"),
                              inputs["a2a"])


@pytest.mark.parametrize("mode", ["direct", "hierarchical"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_grad_allreduce_means_over_dp(runs, mesh, mode):
    """Ones average to 1 under both modes, as the reference's (:125); a
    gradient that differs per rank averages over (pod, data)."""
    inputs, world, ref = runs
    ones = _stack(world, f"{mesh}/grad_ones_{mode}")
    np.testing.assert_allclose(ones, 1.0, rtol=SUM_TOL)
    np.testing.assert_allclose(ref[f"{mesh}/grad_ones_{mode}"], 1.0,
                               rtol=SUM_TOL)
    shape = MESHES[mesh]
    g = inputs["grad"].reshape(shape + (6, 5))
    want = np.broadcast_to(g.mean(axis=(0, 1), keepdims=True),
                           g.shape).reshape(WORLD, 6, 5)
    np.testing.assert_allclose(_stack(world, f"{mesh}/grad_{mode}"), want,
                               rtol=SUM_TOL, atol=SUM_TOL)


def _ep(world, mesh, key, replicated=True):
    """The world's per-rank MoE outputs as the reference's global [4,16,32]:
    per data-parallel shard the copy at model coordinate 0, which the
    reference's output (replicated over "model") shows.  ``replicated``:
    the ranks along "model" must hold the same shard."""
    shape = MESHES[mesh]
    per = _stack(world, f"{mesh}/{key}").reshape(
        shape[0] * shape[1], shape[2], -1, 16, 32)
    if replicated:
        np.testing.assert_array_equal(per, per[:, :1].repeat(shape[2], 1))
    return per[:, 0].reshape(4, 16, 32)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_ep_direct_matches_reference_and_oracle(runs, mesh):
    inputs, world, ref = runs
    got = _ep(world, mesh, "ep_direct")
    for want in (ref[f"{mesh}/ep_direct"], ref[f"{mesh}/ep_ref"],
                 _ep(world, mesh, "ep_ref")):
        np.testing.assert_allclose(got, want, rtol=EP_TOL, atol=EP_TOL)
    np.testing.assert_allclose(_stack(world, f"{mesh}/ep_aux_direct"),
                               ref[f"{mesh}/ep_aux_direct"], rtol=SUM_TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_ep_hierarchical_matches_reference(runs, mesh):
    """The port keeps the reference's pod-crossing exchange (C9) bit for
    bit in its routing, so their outputs agree.  Under C9 the ranks along
    "model" need not agree, so only the copy the reference shows is
    compared."""
    _, world, ref = runs
    np.testing.assert_allclose(_ep(world, mesh, "ep_hierarchical", False),
                               ref[f"{mesh}/ep_hierarchical"], rtol=EP_TOL,
                               atol=EP_TOL)
    np.testing.assert_allclose(_stack(world, f"{mesh}/ep_aux_hierarchical"),
                               ref[f"{mesh}/ep_aux_hierarchical"],
                               rtol=SUM_TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_c9_hierarchical_moe_ep_departs_on_pod_meshes(runs, mesh):
    """C9, a fault of the reference kept for parity: on a mesh with a pod
    dim of 2, both packages' HIERARCHICAL ``moe_ep`` depart from the
    single-device oracle by more than 1, while DIRECT agrees (``-s``
    prints the departures)."""
    _, world, ref = runs
    oracle = ref[f"{mesh}/ep_ref"]
    gaps = [float(np.abs(got - oracle).max()) for got in (
        _ep(world, mesh, "ep_hierarchical", False),
        ref[f"{mesh}/ep_hierarchical"], _ep(world, mesh, "ep_direct"))]
    print(f"C9 {mesh}: HIERARCHICAL moe_ep vs the oracle, port "
          f"{gaps[0]:.4f}, reference {gaps[1]:.4f}; port DIRECT "
          f"{gaps[2]:.2e}")
    assert min(gaps[:2]) > 1.0
    assert gaps[2] < EP_TOL


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_block_forward_ep_is_attention_then_moe_ep(runs, mesh):
    """A block with ``moe_impl="ep"`` on a rank's shard equals the
    attention half plus the oracle's MoE on that shard."""
    _, world, _ = runs
    assert _stack(world, f"{mesh}/block_gap").max() < EP_TOL
